"""Paper-scale validation run: ~2.2 B points, >2^31 collected hits.

The reference's protocol tops out at ca13 ≈ 2.6 B points with the XL box
matching the entire dataset (~2.6 B hits,
/root/reference/query/src/bin/run_query_experiments.rs:140). This repo's
host-int accumulation makes >2^31 counts correct by design
(engine drains device int32 partials into Python ints), but until this tool
no run had crossed 2^31 hits or 10^9 points. It:

  1. `generate`: streams a 35-file LAST dataset (default 64 M pts/file ->
     2.24 B points, ~45 GB, point format 0) to disk, one file in RAM at a
     time.
  2. `oracle`: exact NumPy f64 oracle per file (bbox-XL count, class-6
     count), summed in Python ints — the full truth, not a sample.
  3. `run`: engine bbox-XL count, class-6 count, and a force_collect
     bbox-XL collect-to-count (>2^31 hits through the collect/emit path),
     each asserted == oracle; peak RSS sampled throughout.

Usage:
  python tools/paperscale.py all --root /data/paperscale [--files 35]
  python tools/paperscale.py run --root ... --json paperscale.json

Runs on JAX's default backend (JAX_PLATFORMS=cpu pins the CPU). Host
time: generation ~10-20 min on one core, oracle ~5 min; device query
times are not measured here.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

# One world slab per file along x (like synth.write_dataset), 1 km² x 100 m
# at mm scale: x/y residuals ~20 bits, z ~17 — representative of the paper's
# datasets, and the XL box below covers every slab.
EXTENT = (1000.0, 1000.0, 100.0)
BASE_OFFSET = (100000.0, 200000.0, 0.0)
CLASS = 6


def xl_box(n_files: int):
    from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

    return AABB(
        (BASE_OFFSET[0] - 1.0, BASE_OFFSET[1] - 1.0, BASE_OFFSET[2] - 1.0),
        (BASE_OFFSET[0] + n_files * EXTENT[0] + 1.0,
         BASE_OFFSET[1] + EXTENT[1] + 1.0, BASE_OFFSET[2] + EXTENT[2] + 1.0),
    )


def partial_box(n_files: int):
    """~55% of points: exercises per-block compaction at scale (the XL box
    full-matches every block, which takes the cheap emit_range path)."""
    from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

    return AABB(
        (BASE_OFFSET[0], BASE_OFFSET[1], BASE_OFFSET[2]),
        (BASE_OFFSET[0] + n_files * EXTENT[0], BASE_OFFSET[1] + 0.55 * EXTENT[1],
         BASE_OFFSET[2] + EXTENT[2]),
    )


class RssTracker:
    """Tracks peak anonymous RSS (the leak-relevant number) and peak total
    VmRSS separately: VmRSS also counts mmap'd FILE pages, which the kernel
    reclaims under pressure — on a 42 GB dataset the page cache legitimately
    dominates VmRSS while the engine's own footprint stays flat."""

    def __init__(self):
        self.peak_anon = 0
        self.peak_total = 0
        self._stop = False
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _sample(self):
        anon = total = 0
        for line in open("/proc/self/status"):
            if line.startswith("VmRSS:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("RssAnon:"):
                anon = int(line.split()[1]) * 1024
        return anon, total

    def _loop(self):
        while not self._stop:
            anon, total = self._sample()
            self.peak_anon = max(self.peak_anon, anon)
            self.peak_total = max(self.peak_total, total)
            time.sleep(0.5)

    @property
    def peak(self) -> int:
        return self.peak_anon

    def stop(self) -> int:
        self._stop = True
        self._t.join(timeout=2)
        return self.peak_anon


def file_paths(root: Path, n_files: int, fmt: str = "last") -> list[Path]:
    return [root / fmt / f"file_{i}.{fmt}" for i in range(n_files)]


def generate(root: Path, n_files: int, pts_per_file: int,
             fmt: str = "last") -> None:
    from adhoc_queries_pointclouds_tpu.formats import synth

    writer = {"last": synth.write_cloud_last, "lazer": synth.write_cloud_lazer,
              "laz": synth.write_cloud_laz}[fmt]
    (root / fmt).mkdir(parents=True, exist_ok=True)
    for i, path in enumerate(file_paths(root, n_files, fmt)):
        if path.exists() and path.stat().st_size > 0:
            continue
        t0 = time.time()
        cloud = synth.make_cloud(
            pts_per_file, seed=1000 + i, point_format=0,
            offset=(BASE_OFFSET[0] + i * EXTENT[0], BASE_OFFSET[1], BASE_OFFSET[2]),
            extent=EXTENT,
        )
        writer(cloud, path)
        del cloud
        print(f"generated {path.name}: {pts_per_file / 1e6:.0f} Mpts "
              f"in {time.time() - t0:.0f}s", flush=True)


def oracle(root: Path, n_files: int, fmt: str = "last") -> dict:
    """Exact per-file NumPy f64 oracle, Python-int totals."""
    from adhoc_queries_pointclouds_tpu.formats import open_point_cloud

    xlb = xl_box(n_files)
    pb = partial_box(n_files)
    totals = {"points": 0, "xl": 0, "cls": 0, "partial": 0}
    for path in file_paths(root, n_files, fmt):
        r = open_point_cloud(path)
        n = r.point_count
        chunk = 16_000_000
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            w = r.positions_world(s, e)
            totals["xl"] += int(np.sum(xlb.contains_points(w)))
            totals["partial"] += int(np.sum(pb.contains_points(w)))
            totals["cls"] += int(np.sum(r.column("classification", s, e) == CLASS))
            totals["points"] += e - s
        r.close()
        print(f"oracle {path.name}: cumulative {totals}", flush=True)
    return totals


def run(root: Path, n_files: int, out_json: Path | None,
        fmt: str = "last") -> int:
    from adhoc_queries_pointclouds_tpu.engine import run_query
    from adhoc_queries_pointclouds_tpu.models.query import (
        BoundsQuery, ClassQuery, QueryPlan,
    )

    files = [p for p in file_paths(root, n_files, fmt) if p.exists()]
    assert len(files) == n_files, f"dataset incomplete: {len(files)}/{n_files}"
    ds = root / fmt

    oracle_path = root / "oracle.json"
    if oracle_path.exists():
        truth = json.loads(oracle_path.read_text())
    else:
        truth = oracle(root, n_files, fmt)
        oracle_path.write_text(json.dumps(truth))
    print(f"oracle totals: {truth}", flush=True)
    assert truth["xl"] == truth["points"], "XL box must cover all points"

    import jax

    rss = RssTracker()
    report = {"oracle": truth, "n_files": n_files, "format": fmt,
              "backend": jax.default_backend(),
              "crossed_2_31_hits": truth["points"] >= 2**31}

    def one(label, plan, expect, **kw):
        t0 = time.time()
        res = run_query(ds, plan, use_index=False, **kw)
        dt = time.time() - t0
        ok = res.match_count == expect
        mpts = truth["points"] / dt / 1e6
        decode = res.timer.seconds.get("decode_cpu", 0.0)
        scan = res.timer.seconds.get("scan", 0.0)
        print(f"{label}: {res.match_count} (expect {expect}) "
              f"{'OK' if ok else 'MISMATCH'} in {dt:.0f}s = {mpts:.1f} Mpts/s "
              f"(decode {decode:.0f}s of {scan:.0f}s scan; "
              f"peak anon RSS {rss.peak_anon / 2**30:.1f} GiB)", flush=True)
        report[label] = {"count": res.match_count, "expect": expect, "ok": ok,
                         "seconds": round(dt, 1), "mpts": round(mpts, 1),
                         "decode_cpu_s": round(decode, 1),
                         "scan_s": round(scan, 1),
                         "decode_mpts": round(
                             truth["points"] / max(decode, 1e-9) / 1e6, 1)}
        return ok

    ok = True
    ok &= one("count_xl", QueryPlan(bounds=BoundsQuery(xl_box(n_files))),
              truth["xl"])
    ok &= one("count_class6", QueryPlan(classification=ClassQuery(CLASS)),
              truth["cls"])
    # >2^31 hits through the collect/emit machinery (count-only emitter)
    ok &= one("collect_xl", QueryPlan(bounds=BoundsQuery(xl_box(n_files))),
              truth["xl"], force_collect=True)
    # partial-match collect at scale: real per-block compaction + cap ratchets
    ok &= one("collect_partial", QueryPlan(bounds=BoundsQuery(partial_box(n_files))),
              truth["partial"], force_collect=True)
    report["peak_anon_rss_gib"] = round(rss.stop() / 2**30, 2)
    report["peak_total_rss_gib"] = round(rss.peak_total / 2**30, 2)
    report["pass"] = bool(ok)
    print(("PASS" if ok else "FAIL")
          + f" — peak anon RSS {report['peak_anon_rss_gib']} GiB"
          + f" (total incl. page cache {report['peak_total_rss_gib']} GiB)",
          flush=True)
    if out_json:
        out_json.write_text(json.dumps(report, indent=2))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["generate", "oracle", "run", "all"])
    ap.add_argument("--root", type=Path, default=Path("/root/paperscale"))
    ap.add_argument("--files", type=int, default=35)
    ap.add_argument("--pts-per-file", type=int, default=64_000_000)
    ap.add_argument("--format", choices=["last", "lazer", "laz"],
                    default="last",
                    help="container to generate/scan (VERDICT r3 item 6: "
                         "compressed-format scale run)")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if args.cmd in ("generate", "all"):
        generate(args.root, args.files, args.pts_per_file, args.format)
    if args.cmd == "oracle":
        truth = oracle(args.root, args.files, args.format)
        (args.root / "oracle.json").write_text(json.dumps(truth))
    if args.cmd in ("run", "all"):
        return run(args.root, args.files, args.json, args.format)
    return 0


if __name__ == "__main__":
    sys.exit(main())

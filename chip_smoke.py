#!/usr/bin/env python
"""Smoke run of the query engine on a GPU, checked against a NumPy oracle.

Drives the main path end to end through the entry points a user calls:
`cli.main` (streaming counts, `index`, collect with LAS write-back),
`run_query` (density winner sets) and `serve` (a device-resident dataset).
The dataset is generated from --seed: ~56 M points (the paper's smallest
dataset, `doc`) in 8 files of LAS and LAST, plus one 8 M-point file each of
LAZ and LAZER, on the `doc` world extent so the paper's S and L boxes apply.
Every count, hit set and density winner set is compared with a plain NumPy
f64 oracle that parses the LAS files itself; the tolerance is 0.

Run from the repository root:

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # 4-card mesh + 4-process --distributed

Exits non-zero, printing no result line, when JAX finds no GPU or any phase
fails. The times printed are smoke timings of one run, not benchmark
metrics. The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# the paper's `doc` dataset: world extent (experiments.AABBS["doc"]["xl"]),
# its S and L query boxes, and the max-density cell this smoke run samples
DOC_XL = ((389400.0, 124200.0, -94.88), (406200.0, 148200.0, 760.03))
BOX_S = ((390000.0, 130000.0, 0.0), (390500.0, 140000.0, 200.0))
BOX_L = ((390000.0, 130000.0, 0.0), (400000.0, 140000.0, 200.0))
DENSITY_CELL = 100.0
CLASS = 6
TIME_RATE = 200_000.0  # synth flight line, points per second
TIME_FRACTION = (0.30, 0.50)  # of the whole flight line (experiments "tl")
SCALE = 0.001
# dataset size: 8 x 7 M points (`doc` is 56 M) in LAS and LAST, and the one
# LAZ/LAZER file
FILES = 8
POINTS_PER_FILE = 7_000_000
COMPRESSED_POINTS = 8_000_000


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# --------------------------------------------------------------- dataset --


def generate(root: Path, n_files: int, ppf: int, formats, seed: int, t0: float) -> None:
    """The clustered `doc`-extent dataset, one process per file."""
    from adhoc_queries_pointclouds_tpu.formats import synth

    if root.exists():
        shutil.rmtree(root)
    ext = [hi - lo for lo, hi in zip(*DOC_XL)]
    synth.write_dataset(
        root, n_files=n_files, points_per_file=ppf, formats=tuple(formats), seed=seed,
        point_format=1, clustered=True, classes=(2, 5, 6), offset=DOC_XL[0],
        extent=(ext[0] / n_files, ext[1], ext[2]), scale=(SCALE,) * 3,
        time_rate=TIME_RATE, time_start=t0, workers=os.cpu_count() or 1,
    )


# ---------------------------------------------------------------- oracle --


def read_las(path: Path) -> dict:
    """Independent LAS 1.2 reader (formats 1-3): raw xyz, scale, offset,
    classification and GPS time, parsed with numpy from the bytes."""
    buf = path.read_bytes()
    hdr = np.frombuffer(buf, np.uint8, 227)
    off = int(hdr[96:100].view("<u4")[0])
    pf = int(hdr[104])
    rec_len = int(hdr[105:107].view("<u2")[0])
    n = int(hdr[107:111].view("<u4")[0])
    scale = hdr[131:155].view("<f8").copy()
    offset = hdr[155:179].view("<f8").copy()
    names, fmts, offs = ["x", "y", "z", "cls"], ["<i4", "<i4", "<i4", "u1"], [0, 4, 8, 15]
    if pf in (1, 3):
        names, fmts, offs = names + ["gps"], fmts + ["<f8"], offs + [20]
    dt = np.dtype({"names": names, "formats": fmts, "offsets": offs, "itemsize": rec_len})
    recs = np.frombuffer(buf, dt, n, off)
    raw = np.stack([recs["x"], recs["y"], recs["z"]], 1).astype(np.int64)
    return {
        "raw": raw, "scale": scale, "offset": offset,
        "world": raw * scale + offset,
        "cls": recs["cls"].copy(),
        "gps": recs["gps"].copy() if "gps" in names else None,
    }


def _in_box(w, box):
    return np.all((w >= np.asarray(box[0])) & (w <= np.asarray(box[1])), axis=1)


def density_winners(worlds, box, cell):
    """Reference SparseGrid (grid_sampling.rs:18-105) in NumPy f64 over the
    in-box points of `worlds` (a list of per-file arrays, in insertion
    order): per masked cell key the point closest to its unmasked cell
    centre, the first inserted on ties. Returns sorted (key, file, idx, d2)."""
    bmin = np.asarray(box[0], np.float64)
    ext = np.asarray(box[1], np.float64) - bmin
    dims = np.maximum(np.ceil(ext / cell), 0.0)
    bits = [int(max(math.ceil(math.log2(v)), 0)) if v > 0 else 0 for v in dims]
    keys, d2s, fidx, gidx = [], [], [], []
    for f, w in enumerate(worlds):
        sel = np.nonzero(_in_box(w, box))[0]
        p = w[sel]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = (p - bmin) * dims / ext
        r = np.where(np.isnan(r) | (r < 0), 0.0, r)
        c = np.minimum(r, 2.0**64 - 1).astype(np.uint64)
        key = np.zeros(len(p), np.uint64)
        shift = 0
        for a in range(3):
            key |= (c[:, a] & np.uint64((1 << bits[a]) - 1)) << np.uint64(shift)
            shift += bits[a]
        d = p - ((c.astype(np.float64) + 0.5) * cell + bmin)
        keys.append(key)
        d2s.append(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
        fidx.append(np.full(len(p), f, np.int64))
        gidx.append(sel.astype(np.int64))
    key, d2 = np.concatenate(keys), np.concatenate(d2s)
    fi, gi = np.concatenate(fidx), np.concatenate(gidx)
    order = np.lexsort((gi, fi, d2, key))
    first = np.ones(len(order), bool)
    first[1:] = key[order][1:] != key[order][:-1]
    w = order[first]
    return key[w], fi[w], gi[w], d2[w]


class Oracle:
    """Answers for one dataset directory, computed from its LAS files."""

    def __init__(self, las_dir: Path, time_range):
        self.files = sorted(las_dir.glob("*.las"))
        self.data = [read_las(p) for p in self.files]
        worlds = [d["world"] for d in self.data]
        self.counts = {
            "bbox_s": sum(int(_in_box(w, BOX_S).sum()) for w in worlds),
            "bbox_l": sum(int(_in_box(w, BOX_L).sum()) for w in worlds),
            "class": sum(int((d["cls"] == CLASS).sum()) for d in self.data),
            "time": sum(int(((d["gps"] >= time_range[0]) & (d["gps"] < time_range[1])).sum())
                        for d in self.data),
        }
        self.hits_s = np.concatenate([w[_in_box(w, BOX_S)] for w in worlds])
        self.hits_s_cls = np.concatenate(
            [d["cls"][_in_box(d["world"], BOX_S)] for d in self.data])
        self.worlds = worlds
        self._density: dict = {}

    def density(self, scope: str):
        """Winners of the L-box density query: one grid over all files
        ("global"), or one per file ("file")."""
        if scope not in self._density:
            if scope == "global":
                won = density_winners(self.worlds, BOX_L, DENSITY_CELL)
            else:
                parts = [density_winners([w], BOX_L, DENSITY_CELL) for w in self.worlds]
                key, _, gi, d2 = (np.concatenate(c) for c in zip(*parts))
                fi = np.concatenate([np.full(len(p[0]), f) for f, p in enumerate(parts)])
                won = (key, fi, gi, d2)
            self._density[scope] = won
        return self._density[scope]


def check(name: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{name}: got {got}, oracle {want}")
    log(f"  ok {name} = {got}")


def lattice(world: np.ndarray) -> np.ndarray:
    """World points -> integer steps of the dataset's lattice (origin at the
    `doc` minimum corner, step SCALE): exact for points written at that
    lattice, whatever header a file quantized them with."""
    return np.round((world - np.asarray(DOC_XL[0])) / SCALE).astype(np.int64)


def check_written(out_dir: Path, oracle: Oracle, name: str) -> None:
    """The LAS files a collect wrote hold exactly the oracle's hit set, as
    multisets of (lattice x, y, z, class)."""
    files = sorted(out_dir.glob("*.las"))
    got = [read_las(p) for p in files]
    check(f"{name} written points", sum(len(g["raw"]) for g in got), len(oracle.hits_s))
    a = np.concatenate([np.column_stack([lattice(g["world"]), g["cls"]]) for g in got])
    b = np.column_stack([lattice(oracle.hits_s), oracle.hits_s_cls])
    a = a[np.lexsort(a.T[::-1])]
    b = b[np.lexsort(b.T[::-1])]
    if not np.array_equal(a, b):
        raise AssertionError(f"{name}: written points differ from the oracle hit set")
    log(f"  ok {name} written hit set ({len(a)} points, {len(files)} files)")


# ---------------------------------------------------------------- phases --


class Clock:
    """Wall and compile seconds of one phase (JAX's own compile events)."""

    compile_s = 0.0

    @classmethod
    def install(cls) -> None:
        import jax

        events = {
            "/jax/core/compile/backend_compile_duration",
            "/jax/core/compile/jaxpr_to_mlir_module_duration",
            "/jax/core/compile/jaxpr_trace_duration",
        }

        def listen(event, duration, **_):
            if event in events:
                cls.compile_s += duration

        jax.monitoring.register_event_duration_secs_listener(listen)

    @classmethod
    @contextlib.contextmanager
    def phase(cls, name: str):
        log(f"phase {name}")
        t0, c0 = time.perf_counter(), cls.compile_s
        yield
        log(f"phase {name}: wall {time.perf_counter() - t0:.2f} s, compile "
            f"{cls.compile_s - c0:.2f} s (smoke timing, not a benchmark metric)")


def cli(args: list[str]) -> str:
    """Run the CLI in this process; its stdout, or an error on rc != 0."""
    from adhoc_queries_pointclouds_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    if rc != 0:
        raise RuntimeError(f"cli {args} exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue()


def found(text: str) -> int:
    m = re.findall(r"Found (\d+) matching points", text)
    if len(m) != 1:
        raise AssertionError(f"expected one 'Found N' line, got: {text[-1000:]}")
    return int(m[0])


def box_arg(box) -> str:
    return "--bounds=" + ";".join(str(v) for v in (*box[0], *box[1]))


def query_args(time_range) -> dict:
    return {
        "bbox_s": [box_arg(BOX_S)],
        "bbox_l": [box_arg(BOX_L)],
        "class": ["--class", str(CLASS)],
        "time": [f"--time-range={time_range[0]!r};{time_range[1]!r}"],
    }


def phase_counts(dirs: dict, oracles: dict, time_range) -> None:
    """Streaming counts on every format, sidecar index off, then built by
    `cli index` and on."""
    for use_index in (False, True):
        for fmt, d in dirs.items():
            if use_index:
                cli(["index", "-i", str(d)])
            for q, a in query_args(time_range).items():
                extra = [] if use_index else ["--no-index"]
                got = found(cli(["-i", str(d), *a, *extra]))
                check(f"{fmt} {q} index={'on' if use_index else 'off'}", got,
                      oracles[fmt].counts[q])


def phase_collect(dirs: dict, oracles: dict, out_root: Path) -> None:
    for fmt, d in dirs.items():
        out = out_root / f"collect_{fmt}"
        out.mkdir(parents=True)
        got = found(cli(["-i", str(d), box_arg(BOX_S), "-o", str(out)]))
        check(f"{fmt} collect bbox_s count", got, oracles[fmt].counts["bbox_s"])
        check_written(out, oracles[fmt], f"{fmt} collect bbox_s")


def check_density_state(name: str, state, want) -> None:
    """The engine's winner state equals the oracle's: (key, file, point)
    rows as sets, and each winner's d2 bit for bit."""
    key, fi, gi, d2 = want
    def rows(*cols):  # u64 each: a mixed column_stack would promote to f64
        return np.column_stack([np.asarray(c).astype(np.uint64) for c in cols])

    got = rows(state["key"], state["file_idx"], state["gidx"])
    exp = rows(key, fi, gi)
    got_o, exp_o = np.lexsort(got.T[::-1]), np.lexsort(exp.T[::-1])
    if not (np.array_equal(got[got_o], exp[exp_o])
            and np.array_equal(np.asarray(state["d2"])[got_o], d2[exp_o])):
        raise AssertionError(f"{name}: winner set differs from the oracle "
                             f"({len(got)} vs {len(exp)} winners)")
    log(f"  ok {name} winner set ({len(got)} cells)")


def phase_density(d: Path, oracle: Oracle, fmt: str) -> None:
    from adhoc_queries_pointclouds_tpu.engine import run_query
    from adhoc_queries_pointclouds_tpu.models.query import BoundsQuery, DensityConfig, QueryPlan
    from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

    for scope in ("file", "global"):
        want = oracle.density(scope)
        got = found(cli(["-i", str(d), box_arg(BOX_L), "--density", str(DENSITY_CELL),
                         "--density-scope", scope]))
        check(f"{fmt} density {scope} count", got, len(want[0]))
        state: dict = {}
        plan = QueryPlan(bounds=BoundsQuery(AABB(*BOX_L)),
                         density=DensityConfig(DENSITY_CELL, scope))
        res = run_query(d, plan, density_state_out=state)
        if scope == "global":
            merged = state["global"]
        else:
            merged = np.concatenate([state["file"][k] for k in sorted(state["file"])])
        check(f"{fmt} density {scope} run_query count", res.match_count, len(want[0]))
        check_density_state(f"{fmt} density {scope}", merged, want)


def phase_gpu_tests() -> None:
    """The adversarial density cases of tests/test_ops.py, on the GPU."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    counter = Count()
    env = dict(os.environ)
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          str(REPO / "tests" / "test_ops.py")], plugins=[counter])
    finally:
        os.environ.clear()
        os.environ.update(env)
    if rc != 0 or counter.passed < 2:
        raise AssertionError(f"gpu tests: rc={rc}, passed={counter.passed}")
    log(f"  ok {counter.passed} gpu-marked tests passed on the card")


def phase_resident(d: Path, oracle: Oracle, time_range, out_root: Path) -> None:
    import jax

    from adhoc_queries_pointclouds_tpu import serve

    reqs = [
        {"cmd": "info"},
        {"bounds": [*BOX_S[0], *BOX_S[1]]},
        {"bounds": [*BOX_L[0], *BOX_L[1]]},
        {"class": CLASS},
        {"time_range": list(time_range)},
        {"bounds": [*BOX_S[0], *BOX_S[1]], "collect": True, "limit": 1000},
        {"bounds": [*BOX_L[0], *BOX_L[1]], "density": DENSITY_CELL},
        {"cmd": "quit"},
    ]
    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
    buf = io.StringIO()
    saved = sys.stdin
    sys.stdin = stdin
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve.main(["-i", str(d)])
    finally:
        sys.stdin = saved
    if rc != 0:
        raise RuntimeError(f"serve exited {rc}")
    lines = [json.loads(l) for l in buf.getvalue().splitlines() if l.startswith("{")]
    ready, info, s, l_, c, t, col, den, bye = lines
    if not ready.get("ready") or not bye.get("bye"):
        raise AssertionError(f"serve protocol: {ready} ... {bye}")
    log(f"  resident: {info['points']} points, {info['resident_mib']} MiB, "
        f"loaded in {ready['load_s']} s (smoke timing)")
    check("resident points", info["points"], sum(len(w) for w in oracle.worlds))
    check("resident bbox_s", s.get("count"), oracle.counts["bbox_s"])
    check("resident bbox_l", l_.get("count"), oracle.counts["bbox_l"])
    check("resident class", c.get("count"), oracle.counts["class"])
    check("resident time", t.get("count"), oracle.counts["time"])
    check("resident collect count", col.get("count"), oracle.counts["bbox_s"])
    hits = {tuple(np.round(p, 6)) for p in oracle.hits_s.tolist()}
    pts = col.get("points", [])
    if len(pts) != min(1000, oracle.counts["bbox_s"]):
        raise AssertionError(f"resident collect returned {len(pts)} points")
    bad = [p for p in pts if tuple(p[:3]) not in hits]
    if bad:
        raise AssertionError(f"resident collect: {len(bad)} points not in the oracle hit set")
    log(f"  ok resident collect limit: {len(pts)} points, all oracle hits")
    check("resident density", den.get("count"), len(oracle.density("global")[0]))
    for r in (s, l_, c, t, col, den):
        log(f"  resident request {r.get('ms')} ms (smoke timing)")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


# ------------------------------------------------------------ four cards --


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_distributed(args: list[str], n: int, logdir: Path, timeout: float) -> list[str]:
    """The --distributed CLI as n processes, one card each, joined by
    jax.distributed; returns each process's output."""
    port = free_port()
    procs = []
    try:
        for pid in range(n):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(pid))
            logf = open(logdir / f"dist_{pid}.log", "w+")
            cmd = [sys.executable, "-m", "adhoc_queries_pointclouds_tpu.cli", *args,
                   "--distributed", "--coordinator", f"localhost:{port}",
                   "--num-processes", str(n), "--process-id", str(pid)]
            procs.append((subprocess.Popen(cmd, cwd=REPO, env=env, stdout=logf,
                                           stderr=subprocess.STDOUT, text=True), logf))
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p, logf in procs:
        logf.seek(0)
        out = logf.read()
        logf.close()
        if p.returncode != 0:
            raise RuntimeError(f"distributed process failed (rc={p.returncode}):\n{out[-3000:]}")
        outs.append(out)
    return outs


def phase_distributed(d: Path, oracle: Oracle, out_root: Path) -> None:
    logdir = out_root / "dist_logs"
    logdir.mkdir(parents=True)
    t0 = time.perf_counter()
    outs = run_distributed(["-i", str(d), box_arg(BOX_L)], 4, logdir, 600)
    for pid, o in enumerate(outs):
        check(f"distributed bbox_l count (process {pid})", found(o), oracle.counts["bbox_l"])
    out = out_root / "dist_collect"
    out.mkdir()
    outs = run_distributed(["-i", str(d), box_arg(BOX_S), "-o", str(out)], 4, logdir, 600)
    for pid, o in enumerate(outs):
        check(f"distributed collect count (process {pid})", found(o), oracle.counts["bbox_s"])
    merged = out_root / "dist_collect_merged"
    merged.mkdir()
    for k, f in enumerate(sorted(out.glob("host*/*.las"))):
        shutil.copy(f, merged / f"part_{k}.las")
    check_written(merged, oracle, "distributed collect")
    want = len(oracle.density("global")[0])
    outs = run_distributed(["-i", str(d), box_arg(BOX_L), "--density", str(DENSITY_CELL)],
                           4, logdir, 600)
    for pid, o in enumerate(outs):
        check(f"distributed density global (process {pid})", found(o), want)
    log(f"  distributed phase wall {time.perf_counter() - t0:.2f} s (smoke timing)")


def phase_mesh(d: Path, oracle: Oracle, time_range, out_root: Path) -> None:
    """Streaming count, collect and density on a mesh of every card, then a
    resident dataset sharded over them."""
    import jax

    from adhoc_queries_pointclouds_tpu.models.query import (
        BoundsQuery, ClassQuery, DensityConfig, QueryPlan, TimeRangeQuery,
    )
    from adhoc_queries_pointclouds_tpu.parallel.resident import ResidentDataset
    from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

    for q, a in query_args(time_range).items():
        check(f"mesh {q}", found(cli(["-i", str(d), *a, "--no-index"])), oracle.counts[q])
    out = out_root / "mesh_collect"
    out.mkdir()
    check("mesh collect count", found(cli(["-i", str(d), box_arg(BOX_S), "-o", str(out)])),
          oracle.counts["bbox_s"])
    check_written(out, oracle, "mesh collect")
    phase_density(d, oracle, "mesh")
    ds = ResidentDataset.load(d, attrs=("position", "classification", "gps_time"))
    shards = {s.device for a in (ds.xs, ds.cls, ds.ths) for s in a.addressable_shards}
    check("resident shard devices", len(shards), len(jax.devices()))
    plans = {
        "bbox_s": QueryPlan(bounds=BoundsQuery(AABB(*BOX_S))),
        "bbox_l": QueryPlan(bounds=BoundsQuery(AABB(*BOX_L))),
        "class": QueryPlan(classification=ClassQuery(CLASS)),
        "time": QueryPlan(time_range=TimeRangeQuery(*time_range)),
    }
    for q, plan in plans.items():
        check(f"mesh resident {q}", ds.count(plan), oracle.counts[q])
    dplan = QueryPlan(bounds=BoundsQuery(AABB(*BOX_L)), density=DensityConfig(DENSITY_CELL))
    check("mesh resident density", ds.count(dplan), len(oracle.density("global")[0]))
    for dev in jax.devices():
        log(f"  {dev}: peak_bytes_in_use {(dev.memory_stats() or {}).get('peak_bytes_in_use')}")


# ------------------------------------------------------------------ main --


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def preflight(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devs)}")
    from adhoc_queries_pointclouds_tpu import native

    if native.load() is None:
        raise SystemExit("chip_smoke: the native host library did not load")
    return devs


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", type=Path, default=REPO / ".smoke_data")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh and 4-process --distributed path")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.four_cards:
        devs = preflight(1)
        Clock.install()
    # the --distributed processes take one card each, so with --four-cards
    # this process stays off the cards until they have exited
    print(card_line(), flush=True)

    t0 = time.perf_counter()
    n_big = FILES * POINTS_PER_FILE
    big_span = n_big / TIME_RATE
    time_range = (TIME_FRACTION[0] * big_span, TIME_FRACTION[1] * big_span)
    generate(args.data / "big", FILES, POINTS_PER_FILE, ("las", "last"), args.seed, 0.0)
    dirs = {fmt: args.data / "big" / fmt for fmt in ("las", "last")}
    if not args.four_cards:
        # one compressed file whose flight line straddles the time range;
        # its LAS twin feeds the oracle, so the LAZ/LAZER decoders are
        # checked, not trusted
        small_t0 = time_range[0] - 0.5 * COMPRESSED_POINTS / TIME_RATE
        generate(args.data / "small", 1, COMPRESSED_POINTS, ("las", "laz", "lazer"),
                 args.seed + 1000, small_t0)
        dirs["laz"] = args.data / "small" / "laz"
        dirs["lazer"] = args.data / "small" / "lazer"
    log(f"dataset: {n_big} points x (las, last)"
        + ("" if args.four_cards else f" + {COMPRESSED_POINTS} points x (laz, lazer)")
        + f", generated in {time.perf_counter() - t0:.2f} s (set-up)")

    t0 = time.perf_counter()
    big = Oracle(dirs["las"], time_range)
    oracles = {"las": big, "last": big}
    if not args.four_cards:
        small = Oracle(args.data / "small" / "las", time_range)
        oracles.update(laz=small, lazer=small)
    log(f"oracle computed in {time.perf_counter() - t0:.2f} s: {big.counts}")

    out_root = args.data / "out"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir()
    if args.four_cards:
        phase_distributed(dirs["last"], big, out_root)
        devs = preflight(4)
        Clock.install()
        with Clock.phase("mesh (count, collect, density, resident) on 4 cards"):
            phase_mesh(dirs["last"], big, time_range, out_root)
    else:
        with Clock.phase("1 streaming counts (4 formats, index off/on)"):
            phase_counts(dirs, oracles, time_range)
        with Clock.phase("2 collect with LAS write-back"):
            phase_collect(dirs, oracles, out_root)
        with Clock.phase("3 density (file and global scope)"):
            phase_density(dirs["last"], big, "last")
            phase_density(dirs["laz"], oracles["laz"], "laz")
        with Clock.phase("3b adversarial density cases on the GPU"):
            phase_gpu_tests()
        with Clock.phase("4 resident serving"):
            phase_resident(dirs["last"], big, time_range, out_root)
    shutil.rmtree(args.data)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

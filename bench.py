#!/usr/bin/env python
"""Benchmark: fused bbox predicate-scan throughput on one GPU, plus the
streaming engine end to end.

Prints exactly ONE JSON line to stdout:
  {"metric": "bbox_scan_throughput", "value": <Mpts/s>, "unit": "Mpts/s",
   "vs_baseline": <ratio>, "device": {...}, "extras": {...}}

  - Kernel window: KERNEL_POINTS (>= 256 M) points generated on the device,
    K blocks of 2 M points as the engine stacks them. The bbox scan, a
    3-stream read of the same 12 B/pt, a device copy and a one-stream
    reduce, and the class scans are interleaved in rounds (median per
    metric), so every ratio is taken within one window. GB/s figures are
    total bytes moved (reads + writes).
  - End to end: a clustered LAST dataset through `run_query` (file bytes on
    disk -> decode-ahead feeder -> packed transport -> sharded device scan),
    packed vs raw transport, collect with LAS write-back, density, and a
    device-resident dataset.

The baseline is a single-pass vectorized NumPy scan of the same int32
predicate on the host CPU — a stand-in for the reference's `--optimized`
Rust loop (query/src/search/las.rs:101-119), a memory-bound integer-compare
pass over mmap'd columns.

Needs a GPU and the native host library (without it the host codecs fall
back to slow NumPy ones): missing either, it exits non-zero. Diagnostics go
to stderr.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# Host-side baseline size: large enough for a stable NumPy number.
N_POINTS = 8 * 1024 * 1024
KERNEL_BLOCK = 1 << 21
KERNEL_POINTS = int(os.environ.get("AQPC_BENCH_KERNEL_PTS", str(256 * 1024 * 1024)))
ITERS = 10
ROUNDS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def numpy_baseline(x, y, z, lo, hi) -> float:
    """Single-pass vectorized int32 bbox scan on host; returns pts/sec."""
    def scan():
        m = (x >= lo[0]) & (x <= hi[0])
        m &= (y >= lo[1]) & (y <= hi[1])
        m &= (z >= lo[2]) & (z <= hi[2])
        return int(np.count_nonzero(m))

    scan()  # warm page cache / allocator
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        count = scan()
    dt = (time.perf_counter() - t0) / reps
    log(f"numpy baseline: {count} hits, {len(x) / dt / 1e6:.1f} Mpts/s")
    return len(x) / dt


def kernel_and_rooflines(lo, hi) -> dict:
    """The bbox and class scans beside bandwidth probes, in one window.
    Each timed section is one fori_loop dispatch of ITERS passes, ended by
    a scalar fetch."""
    import jax
    import jax.numpy as jnp

    from adhoc_queries_pointclouds_tpu.ops import predicate

    k = KERNEL_POINTS // KERNEL_BLOCK
    n = k * KERNEL_BLOCK
    shape = (k, KERNEL_BLOCK)
    kx, ky, kz, kc = jax.random.split(jax.random.PRNGKey(0), 4)
    dx = jax.random.randint(kx, shape, -(2**30), 2**30, dtype=jnp.int32)
    dy = jax.random.randint(ky, shape, -(2**30), 2**30, dtype=jnp.int32)
    dz = jax.random.randint(kz, shape, -(2**30), 2**30, dtype=jnp.int32)
    dcls = jax.random.randint(kc, shape, 0, 32, dtype=jnp.int32).astype(jnp.uint8)
    dwords = jax.lax.bitcast_convert_type(dcls.reshape(k, -1, 4), jnp.int32)
    los = jnp.tile(jnp.asarray(lo)[None], (k, 1))
    nvs = jnp.full((k,), KERNEL_BLOCK, jnp.int32)
    targets = jnp.ones((k,), jnp.int32)
    jax.block_until_ready([dx, dy, dz, dcls, dwords])

    # the big arrays ride as jit arguments, not closed-over constants
    def loop(one):
        @jax.jit
        def multi(a, b, c, v0):
            def body(i, acc):
                return acc + one(a, b, c, v0 + i)

            return jax.lax.fori_loop(0, ITERS, body, jnp.int32(0))

        return multi

    bbox = loop(lambda a, b, c, v: jnp.sum(predicate.bbox_count_jnp_multi(
        a, b, c, los, jnp.tile((jnp.asarray(hi) + v)[None], (k, 1)), nvs)))
    # 3 int32 streams read, one scalar out: the kernel's 12 B/pt, minus the
    # predicate. maximum(a, v), not a + v: sum(a + v) factors out of the loop
    read3 = loop(lambda a, b, c, v: jnp.sum(
        jnp.maximum(a, v) + jnp.maximum(b, v) + jnp.maximum(c, v), dtype=jnp.int32))
    reduce1 = loop(lambda a, b, c, v: jnp.sum(jnp.maximum(a, v), dtype=jnp.int32))
    # the target class follows the loop index, so no pass can be hoisted
    cls = loop(lambda a, b, c, v: jnp.sum(
        predicate.class_count_jnp_multi(a, targets * (v & 31), nvs)))
    clsp = loop(lambda a, b, c, v: jnp.sum(
        predicate.class_count_packed_jnp_multi(a, targets * (v & 31), nvs)))

    # the copy carries the array through the loop, so every pass reads and
    # writes it (a scalar-slice body would be simplified away)
    @jax.jit
    def copy(a, b, c, v0):
        return jax.lax.fori_loop(0, ITERS - 1, lambda i, arr: arr + i, a + v0)[0, 0]

    probes = {
        "bbox": (bbox, (dx, dy, dz)), "read3": (read3, (dx, dy, dz)),
        "copy": (copy, (dx, dy, dz)), "reduce": (reduce1, (dx, dy, dz)),
        "cls": (cls, (dcls, dy, dz)), "clsp": (clsp, (dwords, dy, dz)),
    }

    def timed(name, seed):
        f, args = probes[name]
        t0 = time.perf_counter()
        int(f(*args, jnp.int32(seed)))
        return (time.perf_counter() - t0) / ITERS

    for name in probes:
        timed(name, 0)  # compile + warm
    f_c, a_c = probes["cls"]
    f_p, a_p = probes["clsp"]
    assert int(f_c(*a_c, jnp.int32(1))) == int(f_p(*a_p, jnp.int32(1)))

    samples: dict[str, list[float]] = {name: [] for name in probes}
    for r in range(ROUNDS):
        for name in probes:
            samples[name].append(timed(name, 2 + r))
    med = {name: float(np.median(v)) for name, v in samples.items()}
    out = {
        "kernel_points": n,
        "kernel_mpts": n / med["bbox"] / 1e6,
        "kernel_gbs": 12 * n / med["bbox"] / 1e9,
        "roofline_read3_gbs": 12 * n / med["read3"] / 1e9,
        "roofline_copy_gbs": 8 * n / med["copy"] / 1e9,
        "roofline_reduce_gbs": 4 * n / med["reduce"] / 1e9,
        "kernel_class_unpacked_mpts": n / med["cls"] / 1e6,
        "kernel_class_packed_mpts": n / med["clsp"] / 1e6,
        "window_spread_bbox": max(samples["bbox"]) / min(samples["bbox"]),
    }
    out["kernel_pct_of_read3"] = 100.0 * out["kernel_gbs"] / out["roofline_read3_gbs"]
    log(f"kernel window: {json.dumps(out)}")

    host = np.random.default_rng(2).integers(-100, 100, 16 * 1024 * 1024,
                                             dtype=np.int64).astype(np.int32)
    jax.block_until_ready(jax.device_put(host))  # warm path
    t0 = time.perf_counter()
    jax.block_until_ready(jax.device_put(host))
    out["h2d_gbs"] = host.nbytes / (time.perf_counter() - t0) / 1e9
    log(f"h2d: {out['h2d_gbs']:.2f} GB/s")
    return out


def _timed_query(ds, plan, **kw):
    from adhoc_queries_pointclouds_tpu.engine import run_query

    run_query(ds, plan, use_index=False, **kw)  # warm (compile + page cache)
    t0 = time.perf_counter()
    res = run_query(ds, plan, use_index=False, **kw)
    return res, time.perf_counter() - t0


def _packed_pair(ds, plan, total_pts, key) -> dict:
    """Packed (default) vs AQPC_PACK=0 transport for one plan."""
    prev = os.environ.get("AQPC_PACK")
    os.environ["AQPC_PACK"] = "0"
    try:
        res_u, dt_u = _timed_query(ds, plan)
    finally:
        if prev is None:
            os.environ.pop("AQPC_PACK", None)
        else:
            os.environ["AQPC_PACK"] = prev
    res, dt = _timed_query(ds, plan)
    assert res.match_count == res_u.match_count, (res.match_count, res_u.match_count)
    out = {
        f"{key}_mpts": total_pts / dt / 1e6,
        f"{key}_unpacked_mpts": total_pts / dt_u / 1e6,
        f"{key}_packed_speedup": dt_u / dt,
    }
    log(f"{key}: {res.match_count} hits, {json.dumps(out)}")
    return out


def end_to_end(root: Path) -> dict:
    """Streaming engine throughput on a clustered LAST dataset — the number
    comparable to the reference's headline MiB/s report (main.rs:309-316)."""
    from adhoc_queries_pointclouds_tpu.formats import synth
    from adhoc_queries_pointclouds_tpu.models.query import (
        BoundsQuery, ClassQuery, DensityConfig, QueryPlan, TimeRangeQuery,
    )
    from adhoc_queries_pointclouds_tpu.parallel.resident import ResidentDataset
    from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

    n_files, ppf = 4, 4_000_000
    total_pts = n_files * ppf
    ds = root / "last"
    if not ds.exists():
        log(f"generating e2e dataset ({n_files} x {ppf / 1e6:.0f}M pts, clustered LAST)...")
        synth.write_dataset(root, n_files=n_files, points_per_file=ppf, formats=("last",),
                            seed=0, point_format=1, clustered=True, classes=(2, 5, 6))
    box = AABB((100150.0, 200200.0, 5.0), (100000.0 + n_files * 1000.0 - 200.0, 200800.0, 80.0))
    total_bytes = sum(f.stat().st_size for f in ds.glob("*.last"))
    out: dict = {}

    out.update(_packed_pair(ds, QueryPlan(bounds=BoundsQuery(box)), total_pts, "e2e"))
    out["e2e_mibs"] = total_bytes / 1048576.0 / (total_pts / (out["e2e_mpts"] * 1e6))
    span = total_pts / 200_000.0
    out.update(_packed_pair(
        ds, QueryPlan(time_range=TimeRangeQuery(span * 0.2, span * 0.7)), total_pts, "e2e_time"))
    out.update(_packed_pair(ds, QueryPlan(classification=ClassQuery(5)), total_pts, "e2e_class"))

    with tempfile.TemporaryDirectory() as td:
        cres, dt = _timed_query(ds, QueryPlan(bounds=BoundsQuery(box), output_dir=Path(td)))
        out["e2e_collect_mpts"] = total_pts / dt / 1e6
        log(f"e2e collect+writeback: {cres.match_count} hits in {dt:.2f}s")

    dres, dt = _timed_query(ds, QueryPlan(bounds=BoundsQuery(box), density=DensityConfig(100.0)))
    out["e2e_density_mpts"] = total_pts / dt / 1e6
    log(f"e2e density: {dres.match_count} cells in {dt:.2f}s")

    rds = ResidentDataset.load(ds, attrs=("position",))
    plan = QueryPlan(bounds=BoundsQuery(box))
    rds.count(plan)  # warm
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        rds.count(plan)
    dt = (time.perf_counter() - t0) / reps
    out["resident_ms_per_query"] = dt * 1e3
    out["resident_mpts_per_query"] = rds.total_points / dt / 1e6
    log(f"resident: {dt * 1e3:.2f} ms/query over {rds.total_points / 1e6:.0f} Mpts")
    return out


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    from adhoc_queries_pointclouds_tpu import native

    if native.load() is None:
        raise SystemExit("bench.py: the native host library did not load")
    card_line = card()
    log(f"device: {dev.device_kind} x {len(jax.devices())}; card: {card_line}")

    rng = np.random.default_rng(0)
    x, y, z = (rng.integers(-(2**30), 2**30, N_POINTS, dtype=np.int64).astype(np.int32)
               for _ in range(3))
    lo = np.array([-(2**29), -(2**28), -(2**29)], np.int32)
    hi = np.array([2**29, 2**28, 2**27], np.int32)
    baseline = numpy_baseline(x, y, z, lo, hi)

    extras = {"card": card_line, "numpy_baseline_mpts": baseline / 1e6}
    extras.update(kernel_and_rooflines(lo, hi))
    root = Path(".bench_data")
    extras.update(end_to_end(root / "e2e"))

    print(json.dumps({
        "metric": "bbox_scan_throughput",
        "value": extras["kernel_mpts"],
        "unit": "Mpts/s",
        "vs_baseline": extras["kernel_mpts"] * 1e6 / baseline,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": extras,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

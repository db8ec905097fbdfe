"""Query engine orchestration — the reference's main.rs driver on a device mesh.

Execution model:

  count queries   host decode-ahead feeder -> D*K blocks/step -> shard_map
                  fused predicate scan per device -> psum -> lazy
                  accumulation (one device sync at the very end)
  collect queries same D*K-block sharded step, fused predicate + per-block
                  index compaction (true counts + cap-bounded buffers,
                  pow2 retry on overflow); hits stream out in file order,
                  attributes gathered lazily (only hit rows are decoded)
  density queries sharded predicate + exact-cell candidate selection
                  (integer boundary tables; sort-based per-cell leaders +
                  f32-margin ties), then exact f64 reference math on the few
                  candidates merged in a sparse host state
  time queries    f64 GPS times as order-preserving (hi, lo) int32 pairs ->
                  exact range predicate in pure int32 device compares

File discovery, the bounds/class mutual exclusion, density's fallback to
dataset total bounds, and the closing MiB/s report all mirror the reference
CLI semantics (main.rs:29-57, 238-244, 253-259, 309-316).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

# Persistent XLA compilation cache. Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself; otherwise the cache lives at a fixed path inside the
# checkout (the path is part of the cache key, so a moving one never hits).
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir(environ=os.environ) -> str | None:
    """The cache directory to set in code, or None where the environment
    already names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CHECKOUT_CACHE_DIR)


if (_cache_dir := compile_cache_dir()) is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from .formats import is_valid_file, open_point_cloud
from .models.query import QueryPlan
from .ops import compact, density as density_ops, predicate
from .parallel import mesh as mesh_mod
from .parallel.pipeline import BlockFeeder
from .sinks import FileHits, HitEmitter, concat_hits, empty_hits, gather_hits
from .utils.aabb import AABB, clamp_bounds_to_i32, local_query_bounds
from .utils.timing import StageTimer

DEFAULT_BLOCK_SIZE = 1 << 21  # 2M points: 24 MiB of xyz per block

# Max device steps in flight. >1 overlaps H2D transfer + host decode of the
# next batch with the current scan (the north star's double-buffering).
# AQPC_INFLIGHT pins it.
MAX_INFLIGHT_STEPS = int(os.environ.get("AQPC_INFLIGHT", "3"))

# Blocks of small datasets shrink to the largest file, rounded up to this.
BLOCK_QUANTUM = 8192


def clamp_block_size(block_size: int, max_pts: int) -> int:
    """Clamp the block to the largest file: tiny files padded to a huge block
    would waste device work (the density sort is O(block log block))."""
    if max_pts and max_pts < block_size:
        q = BLOCK_QUANTUM
        return min(block_size, (max_pts + q - 1) // q * q)
    return block_size


_ASSEMBLY_POOL = None


def _assembly_pool():
    """Small shared pool for step-operand assembly: the row copies release
    the GIL, so multicore hosts overlap them (the copy would otherwise run
    serially on the main thread between device dispatches)."""
    global _ASSEMBLY_POOL
    if _ASSEMBLY_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _ASSEMBLY_POOL = ThreadPoolExecutor(max_workers=4)
    return _ASSEMBLY_POOL


def _stack_rows(batch, key: str, rows: int, block_size: int, dtype) -> np.ndarray:
    """Assemble one step operand: each task's unpadded column copied once
    into its row (pad + stack fused; padding content is never read — every
    kernel masks by per-block n_valid)."""
    out = np.empty((rows, block_size), dtype)

    def fill(j):
        col = batch[j].columns[key]
        out[j, : len(col)] = col

    if len(batch) >= 4 and block_size >= 1 << 16:
        list(_assembly_pool().map(fill, range(len(batch))))
    else:
        for j in range(len(batch)):
            fill(j)
    return out


def _stack_planes(batch, key: str, axis: int, rows: int, k_bits: int,
                  block_size: int) -> np.ndarray:
    """Assemble one packed-transport operand: (rows, k//8*B + k%8*(B//8))
    u8 bit/byte planes of each block's u32 residual stream. Every plane is
    extracted from the full residual, so blocks narrower than the step
    width contribute all-zero high planes naturally; pad tails are masked
    by n_valid like every other kernel."""
    from .ops import predicate

    out = np.empty((rows, predicate.packed_row_width(k_bits, block_size)), np.uint8)

    def fill(j):
        base = int(batch[j].columns["base"][axis])
        predicate.pack_bits_into(out[j], batch[j].columns[key], k_bits, base,
                                 block_size)

    if len(batch) >= 4 and block_size >= 1 << 16:
        list(_assembly_pool().map(fill, range(len(batch))))
    else:
        for j in range(len(batch)):
            fill(j)
    return out


_gc_steps = 0
_libc = None


def _init_malloc() -> None:
    """Pin glibc's mmap threshold so multi-MB block buffers never graduate
    into sbrk arenas.

    glibc's M_MMAP_THRESHOLD is DYNAMIC: freeing an mmap'd chunk raises the
    threshold (up to 32 MiB), after which the engine's 4-24 MiB per-block
    column copies are carved from arena heaps whose freed chunks are kept,
    not returned — anonymous RSS then grows with bytes scanned (observed
    ~7 B/pt; a 2.24 B-pt run retained >30 GiB). Pinning the threshold at
    1 MiB keeps every block-sized buffer an mmap that free() returns to the
    OS. AQPC_MALLOC_PIN=0 disables."""
    global _libc
    if os.environ.get("AQPC_MALLOC_PIN", "1") == "0":
        return
    try:
        import ctypes

        _libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        _libc.mallopt(M_MMAP_THRESHOLD, 1 << 20)
    except Exception:
        _libc = None


_init_malloc()


def _gc_tick() -> None:
    """Periodic FULL gc + malloc_trim across device-step dispatches.

    jax.Array objects created per step (np -> device transfers and results)
    sit in reference cycles that only a generational collection frees, and
    CPython's gc triggers on OBJECT counts — a streaming scan allocates few
    but enormous buffers per step, so collection lags by several steps.
    Gen-0/1 passes are not enough (the cycles age into gen-2), hence a full
    collect every AQPC_GC_STEPS steps (default 4; 0 disables), followed by
    a malloc_trim(0) to hand freed arena pages back to the OS (see
    _init_malloc for the allocator half of the story). AQPC_GC_STEPS is read
    per tick (an env lookup is noise next to a device step) so changes made
    after the first query in a long-lived process take effect."""
    global _gc_steps
    gc_every = int(os.environ.get("AQPC_GC_STEPS", "4"))
    _gc_steps += 1
    if gc_every > 0 and _gc_steps % gc_every == 0:
        gc.collect()
        if _libc is not None:
            try:
                _libc.malloc_trim(0)
            except Exception:
                pass


def _pack_range_tasks(file_idx: int, ranges, block_size: int) -> list:
    """Disjoint ascending [s, e) ranges -> BlockFeeder multi-range tasks,
    each packing up to block_size points (oversized ranges split). Groups
    of 1 full contiguous block degrade to ordinary 4-tuple tasks."""
    tasks: list = []
    group: list[tuple[int, int]] = []
    total = 0

    def flush():
        nonlocal group, total
        if not group:
            return
        if len(group) == 1:
            s, e = group[0]
            tasks.append((file_idx, s // block_size, s, e))
        else:
            tasks.append((file_idx, group[0][0] // block_size, tuple(group)))
        group, total = [], 0

    for s, e in ranges:
        while s < e:
            take = min(e - s, block_size - total)
            if group and group[-1][1] == s:  # adjacent after a split
                group[-1] = (group[-1][0], s + take)
            else:
                group.append((s, s + take))
            total += take
            s += take
            if total == block_size:
                flush()
    flush()
    return tasks


def _density_block_tasks(
    file_idx, n, block_size, idx_info, is_bounds, is_time, file_bounds,
    plan, timer,
) -> list:
    """Per-engine-block density tasks with sidecar bbox/GPS pruning. Only
    DISJOINT can skip — a CONTAINED block still has to flow through the
    grid dedupe (unlike counting, density needs the points themselves)."""
    from .index import DISJOINT, classify_block, classify_time_block

    tasks = []
    for b in range((n + block_size - 1) // block_size):
        start = b * block_size
        stop = min(start + block_size, n)
        if idx_info is not None and is_bounds:
            lo, hi = file_bounds[file_idx]
            cls_b = classify_block(idx_info[1], idx_info[0], start, stop, lo, hi)
            if cls_b == DISJOINT:
                timer.counts["index_skipped_blocks"] += 1
                timer.counts["index_pruned_points"] += stop - start
                continue
        elif idx_info is not None and is_time and idx_info[3] is not None:
            cls_b = classify_time_block(
                idx_info[3], idx_info[0], start, stop,
                plan.time_range.start, plan.time_range.end,
            )
            if cls_b == DISJOINT:
                timer.counts["index_skipped_blocks"] += 1
                timer.counts["index_pruned_points"] += stop - start
                continue
        tasks.append((file_idx, b, start, stop))
    return tasks


def _pack_transport_enabled() -> bool:
    """Byte-planar packed coordinate H2D transport (AQPC_PACK, default on)."""
    return os.environ.get("AQPC_PACK", "1") != "0"


def _residual_width(col: np.ndarray, block_size: int) -> tuple[int, int]:
    """(k_bits, base) for packing one int32 column as k-bit residuals.

    Nibble-rounded widths (multiples of 4, not exact k): the per-step width
    tuple is a jit static arg, so every distinct combo costs one compile
    (disk-cached after the first) plus a retained executable
    workspace — exact-bit widths produce a fresh combo every few files on
    heterogeneous data. Rounding to 4-bit planes caps combos at 8 per axis
    for <= 3 bits/axis (~0.4 B/pt) of extra link bytes. The <= 28-bit cap
    this rounding implies is also what makes the saturating i64->i32 clip
    of residual-space bounds exact (residuals < 2^28 never collide with a
    saturated bound); k == 32 forces base = 0, so bounds pass through
    unclipped. Byte planes only when bit planes can't be laid out
    (block_size % 8 != 0)."""
    mn = int(col.min())
    k = (predicate.bits_width(int(col.max()) - mn) + 3) // 4 * 4
    if k >= 32 or block_size % 8:
        k = min((k + 7) // 8 * 8, 32)
    if k >= 32:
        return 32, 0
    return k, mn


def _packed_xyz_cols(pos: np.ndarray, block_size: int) -> dict:
    """Packed-transport columns for one block's (N, 3) int32 positions.
    Residualization happens at plane-extraction (stack) time; this just
    records each axis's raw column + (base, width)."""
    cols = {}
    base = np.zeros(3, np.int64)
    w = np.empty(3, np.int64)
    for a, key in enumerate(("xp", "yp", "zp")):
        col = np.ascontiguousarray(pos[:, a])
        k, mn = _residual_width(col, block_size)
        cols[key] = col
        base[a] = mn
        w[a] = k
    cols["base"] = base
    cols["w"] = w
    return cols


def _packed_time_cols(th: np.ndarray, tl: np.ndarray, block_size: int) -> dict:
    """Packed-transport columns for one block's encoded GPS times: the
    (hi, lo) int32 pair rides the same bit-planar packer as xyz (hi is
    near-constant on flight-line data; lo packs when times share high
    mantissa bits)."""
    kh, bh = _residual_width(th, block_size)
    kl, bl = _residual_width(tl, block_size)
    return {
        "thp": th,
        "tlp": tl,
        "base": np.asarray([bh, bl], np.int64),
        "w": np.asarray([kh, kl], np.int64),
    }


def _packed_time_query(q_enc, base) -> np.ndarray:
    """Residual-space encoded range for one block: (q0h, q0l, q1h, q1l)
    shifted by the block's (hi, lo) bases, saturating-clipped to int32
    (exact under the <= 28-bit width cap — see _residual_width)."""
    i32 = np.iinfo(np.int32)
    shift = np.asarray([base[0], base[1], base[0], base[1]], np.int64)
    return np.clip(
        np.asarray(q_enc, np.int64) - shift, i32.min, i32.max
    ).astype(np.int32)


def _packed_class_cols(cls: np.ndarray, target: int, block_size: int) -> dict:
    """Dictionary-coded transport columns for one block's u8 class column.

    codes are u8 dictionary indices (predicate.class_dict_encode); "t"
    carries the target's code, or len(dict) — a code no point has — when
    the target class is absent; "np" the dictionary size so the count path
    can resolve absent/single-class blocks host-side with no device work."""
    present, codes = predicate.class_dict_encode(cls)
    pos = int(np.searchsorted(present, np.uint8(target)))
    tcode = pos if pos < len(present) and int(present[pos]) == int(target) else len(present)
    return {
        "clsp": codes,  # u8 end-to-end: pack_bits_into has a native u8 path
        "base": np.zeros(1, np.int64),
        "w": np.asarray(
            [predicate.class_dict_width(len(present), block_size)], np.int64
        ),
        "t": np.asarray([tcode], np.int64),
        "np": np.asarray([len(present)], np.int64),
    }


def discover_files(input_path) -> list[Path]:
    """File or flat directory listing with extension filter (main.rs:29-57).
    Also accepts an explicit sequence of file paths (distributed manifest
    shards)."""
    if isinstance(input_path, (list, tuple)):
        files = [Path(f) for f in input_path]
        for f in files:
            if not f.exists():
                raise FileNotFoundError(f"Input path {f} does not exist!")
        return [f for f in files if is_valid_file(f)]
    p = Path(input_path)
    if not p.exists():
        raise FileNotFoundError(f"Input path {p} does not exist!")
    if p.is_file():
        files = [p]
    elif p.is_dir():
        files = sorted(c for c in p.iterdir() if c.is_file())
    else:
        raise ValueError(f"Input path {p} is neither file nor directory!")
    return [f for f in files if is_valid_file(f)]


def get_total_bounds(readers) -> AABB:
    """Union of per-file header bounds (main.rs:94-120)."""
    total = AABB.empty()
    for r in readers:
        total = total.union(r.header.bounds)
    return total


@dataclasses.dataclass
class QueryResult:
    match_count: int
    hits: list[FileHits]
    output_files: list[Path]
    total_file_bytes: int
    elapsed_seconds: float
    timer: StageTimer
    files_searched: int
    points_scanned: int = 0

    @property
    def throughput_mibs(self) -> float:
        return self.total_file_bytes / 1048576.0 / max(self.elapsed_seconds, 1e-12)

    @property
    def mpts_per_s(self) -> float:
        return self.points_scanned / 1e6 / max(self.elapsed_seconds, 1e-12)


def run_query(
    input_path: str | Path,
    plan: QueryPlan,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    n_devices: int | None = None,
    workers: int = 8,
    prefetch: int = 12,
    keep_hits: bool = False,
    force_collect: bool = False,
    keep_going: bool = False,
    use_index: bool = True,
    print_stream=None,
    density_grid_bounds: AABB | None = None,
    density_state_out: dict | None = None,
    comm=None,
) -> QueryResult:
    """Run one query plan over a file or directory.

    keep_going: skip unreadable files with a warning instead of aborting the
    whole query (the reference aborts on any file error, main.rs:161-163).
    print_stream: stream matching points here as they are found (the
    reference's StdOutCollector, collect_points.rs:46-70) — bounded memory,
    unlike keep_hits. Defaults to sys.stdout when plan.print_points is set.
    comm: step-communication strategy (parallel/comm.py). The default runs
    single-process; parallel/distributed.py passes a DistStepComm so this
    same loop — feeder, packed transport, index pruning, emit machinery —
    becomes the multi-host SPMD program (count/collect paths; density runs
    host-local and is merged by distributed_density).
    """
    from .parallel.comm import LocalStepComm

    comm = comm or LocalStepComm()
    if print_stream is None and plan.print_points:
        import sys

        print_stream = sys.stdout
    timer = StageTimer()
    files = discover_files(input_path)
    if not files and comm.is_local:
        raise FileNotFoundError(f"No supported point-cloud files under {input_path}")
    total_bytes = sum(f.stat().st_size for f in files)

    with timer.stage("open"):
        if keep_going:
            readers = []
            kept = []
            for f in files:
                try:
                    readers.append(open_point_cloud(f))
                    kept.append(f)
                except Exception as e:
                    import sys

                    print(f"warning: skipping {f}: {e}", file=sys.stderr)
            files = kept
            if not files and comm.is_local:
                raise FileNotFoundError(f"No readable point-cloud files under {input_path}")
        else:
            readers = [open_point_cloud(f) for f in files]

    block_size = clamp_block_size(
        block_size, max((r.point_count for r in readers), default=0)
    )
    # multi-host runs must compile identical step shapes: take the max of
    # every host's clamped block (a no-op single-process)
    block_size = comm.agree_block_size(block_size)

    is_bounds = plan.bounds is not None
    query_bounds = plan.bounds.bounds if is_bounds else None

    if plan.time_range is not None:
        from .formats.las import has_gps_time

        for f, r in zip(files, readers):
            if not has_gps_time(r.header.point_format):
                raise ValueError(f"File {f} does not contain GPS times!")

    # Per-file integer-domain bounds + header prefilter (las.rs:82-99).
    file_bounds: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    active = []
    for i, r in enumerate(readers):
        if is_bounds:
            if not r.header.bounds.intersects(query_bounds):
                continue
            lo64, hi64 = local_query_bounds(
                query_bounds,
                r.header.scale,
                r.header.offset,
                parity_quirk=plan.parity_quirk,
            )
            lo, hi = clamp_bounds_to_i32(lo64, hi64)
            file_bounds[i] = (lo, hi)
        active.append(i)

    if plan.density is not None:
        if density_grid_bounds is not None:
            # distributed runs share one grid across hosts (the local files'
            # total bounds would give each host a different lattice)
            grid_bounds = density_grid_bounds
        elif is_bounds:
            grid_bounds = query_bounds
        else:
            grid_bounds = get_total_bounds(readers)
        grid = density_ops.GridSpec3D.create(grid_bounds, plan.density.cell_size)
    else:
        grid = None

    # Optional block min/max sidecar index (the reference's improvements.md
    # "on-the-fly index building" idea): classify each engine block as
    # disjoint / contained / partial against the integer query box. Exact
    # results are preserved — the index only removes work.
    file_indices_meta: dict[int, tuple] = {}
    index_collectors: dict[int, "index_mod.IndexCollector"] = {}
    if use_index:
        from . import index as index_mod

        for i in active:
            info = index_mod.load_index(files[i])
            if info is not None:
                file_indices_meta[i] = info
        # on-the-fly build (improvements.md semantics): a full bbox scan of
        # an unindexed file emits the sidecar as a byproduct. Density plans
        # skip the auto-build: the grid dedupe needs every in-box point, so
        # the sidecar can only ever prune DISJOINT blocks for them, and the
        # per-block min/max collection runs on the host critical path — on
        # wide (l/xl) density boxes that made index-on measurably slower
        # than index-off with nothing pruned in return.
        if (is_bounds and plan.density is None
                and os.environ.get("AQPC_AUTO_INDEX", "1") != "0"):
            for i in active:
                if i not in file_indices_meta:
                    index_collectors[i] = index_mod.IndexCollector(
                        readers[i].point_count
                    )

    # keep_hits asks for materialized points, so it forces the collect path
    # even when the plan itself would only count; force_collect exercises
    # the collect machinery (compaction, emit ordering, cap ratchets) with a
    # count-only emitter — used by paper-scale validation runs where
    # materializing >2^31 hits would be pointless IO
    if plan.collects_points or keep_hits or force_collect:
        result = _run_collect(
            plan, files, readers, active, file_bounds, grid,
            block_size=block_size, n_devices=n_devices,
            workers=workers, prefetch=prefetch,
            timer=timer, keep_hits=keep_hits, block_index=file_indices_meta,
            index_collectors=index_collectors, print_stream=print_stream,
            density_state_out=density_state_out, comm=comm,
        )
    else:
        result = _run_count(
            plan, readers, active, file_bounds,
            block_size=block_size, n_devices=n_devices,
            workers=workers, prefetch=prefetch, timer=timer,
            block_index=file_indices_meta, index_collectors=index_collectors,
            comm=comm,
        )

    for i, collector in index_collectors.items():
        if collector.save_if_complete(files[i]):
            timer.counts["index_built_files"] += 1

    # points actually scanned = points of files that survived the header
    # prefilter (skipped files cost only a header read), minus points of
    # blocks the sidecar index pruned (skipped or counted without IO) so
    # indexed runs don't overstate Mpts/s
    points_scanned = sum(readers[i].point_count for i in active)
    points_scanned -= timer.counts.get("index_pruned_points", 0)
    for r in readers:
        r.close()
    match_count, hits, output_files = result
    return QueryResult(
        match_count=match_count,
        hits=hits,
        output_files=output_files,
        total_file_bytes=total_bytes,
        elapsed_seconds=timer.elapsed(),
        timer=timer,
        files_searched=len(files),
        points_scanned=points_scanned,
    )


# ---------------------------------------------------------------------------
# count path
# ---------------------------------------------------------------------------


def _run_count(
    plan, readers, active, file_bounds, *, block_size, n_devices,
    workers, prefetch, timer, block_index=None, index_collectors=None,
    comm=None,
):
    from .parallel.comm import LocalStepComm

    comm = comm or LocalStepComm()
    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None
    mesh = comm.make_mesh(n_devices)
    d = mesh.devices.size
    # K blocks per device per dispatch amortizes the per-dispatch cost.
    blocks_per_step = int(os.environ.get("AQPC_BLOCKS_PER_STEP", "4"))
    rows_per_step = comm.batch_rows(mesh, max(1, blocks_per_step))
    block_index = block_index or {}

    from .index import (
        bbox_scan_ranges, class_present_ranges, time_scan_ranges,
    )

    tasks = []
    indexed_total = 0  # points of CONTAINED blocks: counted with zero IO
    skipped_blocks = contained_blocks = pruned_points = 0
    for i in active:
        n = readers[i].point_count
        idx_info = block_index.get(i)
        if idx_info is not None and not is_bounds and not is_time:
            # class sub-block pruning at FILE scope: present index-block
            # ranges (bitmap granularity, 65k pts) packed into FULL
            # multi-range device blocks — a short survivor range must not
            # occupy an entire padded slot (see class_present_ranges /
            # BlockFeeder multi-range tasks)
            ranges = class_present_ranges(
                idx_info[2], idx_info[0], 0, n,
                plan.classification.classification,
            )
            kept = sum(e - s for s, e in ranges)
            if kept < n:
                skipped_blocks += max((n - kept) // idx_info[0], 1)
                pruned_points += n - kept
            tasks += _pack_range_tasks(i, ranges, block_size)
            continue
        if idx_info is not None and (
            is_bounds or (is_time and idx_info[3] is not None)
        ):
            # bbox/GPS-time sub-block pruning at FILE scope, same 65k
            # granularity as the class path: a straddling sub-block no
            # longer forces its whole ~2M-point engine block through the
            # scan, and fully-inside sub-blocks count with zero point IO
            if is_bounds:
                lo, hi = file_bounds[i]
                scan_rs, cont_rs = bbox_scan_ranges(
                    idx_info[1], idx_info[0], 0, n, lo, hi)
            else:
                scan_rs, cont_rs = time_scan_ranges(
                    idx_info[3], idx_info[0], 0, n,
                    plan.time_range.start, plan.time_range.end)
            cont_pts = sum(e - s for s, e in cont_rs)
            scan_pts = sum(e - s for s, e in scan_rs)
            indexed_total += cont_pts
            if cont_pts:
                contained_blocks += max(cont_pts // idx_info[0], 1)
            if n - scan_pts - cont_pts > 0:
                skipped_blocks += max((n - scan_pts - cont_pts) // idx_info[0], 1)
            pruned_points += n - scan_pts
            tasks += _pack_range_tasks(i, scan_rs, block_size)
            continue
        for b in range((n + block_size - 1) // block_size):
            start = b * block_size
            stop = min(start + block_size, n)
            tasks.append((i, b, start, stop))
    if skipped_blocks or contained_blocks:
        timer.counts["index_skipped_blocks"] += skipped_blocks
        timer.counts["index_contained_blocks"] += contained_blocks
        timer.counts["index_pruned_points"] += pruned_points

    index_collectors = index_collectors or {}

    pack = _pack_transport_enabled()
    transform = None
    if is_time:
        # f64 GPS times run on device through the order-preserving
        # (hi, lo) int32 split encoding — exact f64 range semantics with
        # pure int32 compares (predicate.encode_f64_sortable). Half-open
        # [start, end) like the reference's Range<f64> stub (las.rs:332-339).
        q_enc = np.asarray(
            predicate.encode_f64_scalar(plan.time_range.start)
            + predicate.encode_f64_scalar(plan.time_range.end),
            np.int32,
        )

        # raw load + whole-block transform: multi-range (index-packed)
        # tasks concatenate several raw loads into one block BEFORE the
        # packed-transport encoding runs — per-range packing would
        # concatenate the per-range base/w scalars into garbage
        def load(file_idx, start, stop):
            gps = readers[file_idx].column("gps_time", start, stop)
            th, tl = predicate.encode_f64_sortable(gps)
            return {"th": th, "tl": tl}

        if pack:
            transform = lambda file_idx, cols: _packed_time_cols(  # noqa: E731
                cols["th"], cols["tl"], block_size)
    elif is_bounds:
        def load(file_idx, start, stop):
            pos = readers[file_idx].column("position", start, stop)
            collector = index_collectors.get(file_idx)
            if collector is not None:
                collector.update(start, pos)
            return {"pos": pos}

        def transform(file_idx, cols):
            pos = cols["pos"]
            if not pack:
                return {
                    "x": np.ascontiguousarray(pos[:, 0]),
                    "y": np.ascontiguousarray(pos[:, 1]),
                    "z": np.ascontiguousarray(pos[:, 2]),
                }
            # packed transport: k-bit residual streams vs per-block base
            # (residualization runs here, in the feeder worker threads;
            # plane extraction happens at stack time, pooled)
            return _packed_xyz_cols(pos, block_size)
    else:
        target_val = plan.classification.classification

        # raw load + whole-block transform split: multi-range (index
        # -packed) tasks concatenate several raw loads into one block
        # before the packed-transport encoding runs
        def load(file_idx, start, stop):
            return {"cls": np.ascontiguousarray(
                readers[file_idx].column("classification", start, stop)
            )}

        if pack:
            transform = lambda file_idx, cols: _packed_class_cols(  # noqa: E731
                cols["cls"], target_val, block_size)

    feeder = BlockFeeder(
        tasks, load, block_size,
        file_bounds=file_bounds, workers=workers, prefetch=prefetch, pad=False,
        transform_fn=transform,
    )

    pending: list = []
    # device_total: accumulated global step counts (identical on every
    # participant — the psum spans the comm's mesh); host_total: blocks
    # resolved with no device work (index-CONTAINED, dictionary
    # fast-paths) — summed across hosts by comm.finish_total.
    device_total = 0
    host_total = indexed_total
    batch = []

    def drain(limit: int):
        nonlocal device_total
        while len(pending) > limit:
            device_total += int(pending.pop(0))
        _gc_tick()

    def flush(batch):
        rows = comm.step_rows(mesh, len(batch), rows_per_step)
        pad = rows - len(batch)
        nvs = np.asarray([t.n_valid for t in batch] + [0] * pad, np.int32)
        if is_bounds and pack:
            i32 = np.iinfo(np.int32)
            wmax = comm.agree_widths(
                np.maximum.reduce([t.columns["w"] for t in batch])
                if batch else np.zeros(3, np.int64)
            )
            # residual-space bounds: the saturating i64->i32 clip is
            # exact because sub-32 widths are capped at 28 bits (residuals
            # < 2^28 never collide with a saturated bound) and k == 32
            # forces base = 0 (bounds pass through unclipped)
            lo_rows = [
                np.clip(t.lo.astype(np.int64) - t.columns["base"], i32.min, i32.max)
                .astype(np.int32)
                for t in batch
            ] + [np.zeros(3, np.int32)] * pad
            hi_rows = [
                np.clip(t.hi.astype(np.int64) - t.columns["base"], i32.min, i32.max)
                .astype(np.int32)
                for t in batch
            ] + [np.full(3, -1, np.int32)] * pad
            xs = _stack_planes(batch, "xp", 0, rows, int(wmax[0]), block_size)
            ys = _stack_planes(batch, "yp", 1, rows, int(wmax[1]), block_size)
            zs = _stack_planes(batch, "zp", 2, rows, int(wmax[2]), block_size)
            arrays = comm.put(
                mesh, (xs, ys, zs, np.stack(lo_rows), np.stack(hi_rows), nvs)
            )
            pending.append(
                mesh_mod.sharded_bbox_count_packed(
                    mesh, *arrays,
                    (int(wmax[0]), int(wmax[1]), int(wmax[2])), block_size,
                )
            )
        elif is_bounds:
            xs = _stack_rows(batch, "x", rows, block_size, np.int32)
            ys = _stack_rows(batch, "y", rows, block_size, np.int32)
            zs = _stack_rows(batch, "z", rows, block_size, np.int32)
            los = np.stack([t.lo for t in batch] + [np.zeros(3, np.int32)] * pad)
            his = np.stack([t.hi for t in batch] + [np.zeros(3, np.int32)] * pad)
            arrays = comm.put(mesh, (xs, ys, zs, los, his, nvs))
            pending.append(
                mesh_mod.sharded_bbox_count(mesh, *arrays)
            )
        elif is_time and pack:
            wmax = comm.agree_widths(
                np.maximum.reduce([t.columns["w"] for t in batch])
                if batch else np.zeros(2, np.int64)
            )
            q_rows = [_packed_time_query(q_enc, t.columns["base"]) for t in batch]
            q_rows += [np.zeros(4, np.int32)] * pad
            ths = _stack_planes(batch, "thp", 0, rows, int(wmax[0]), block_size)
            tls = _stack_planes(batch, "tlp", 1, rows, int(wmax[1]), block_size)
            arrays = comm.put(mesh, (ths, tls, np.stack(q_rows), nvs))
            pending.append(
                mesh_mod.sharded_time_count_packed(
                    mesh, *arrays, (int(wmax[0]), int(wmax[1])), block_size,
                )
            )
        elif is_time:
            ths = _stack_rows(batch, "th", rows, block_size, np.int32)
            tls = _stack_rows(batch, "tl", rows, block_size, np.int32)
            qs = np.tile(q_enc, (rows, 1))
            arrays = comm.put(mesh, (ths, tls, qs, nvs))
            pending.append(mesh_mod.sharded_time_count(mesh, *arrays))
        elif pack:
            kmax = int(comm.agree_widths(np.asarray(
                [max(int(t.columns["w"][0]) for t in batch) if batch else 0],
                np.int64,
            ))[0])
            cps = _stack_planes(batch, "clsp", 0, rows, kmax, block_size)
            targets = np.asarray(
                [int(t.columns["t"][0]) for t in batch] + [0] * pad, np.int32
            )
            arrays = comm.put(mesh, (cps, targets, nvs))
            pending.append(
                mesh_mod.sharded_class_count_dict(
                    mesh, *arrays, kmax, block_size
                )
            )
        else:
            clss = _stack_rows(batch, "cls", rows, block_size, np.uint8)
            targets = np.full(rows, plan.classification.classification, np.int32)
            arrays = comm.put(mesh, (clss, targets, nvs))
            pending.append(mesh_mod.sharded_class_count(mesh, *arrays))
        drain((comm.inflight() or MAX_INFLIGHT_STEPS) - 1)

    # host-side dictionary fast-paths change the flushed-step count, so they
    # are local-only: multi-host lockstep needs a step count derivable from
    # the task list alone (the device resolves those blocks for free anyway)
    is_class_dict = pack and not is_bounds and not is_time and comm.is_local
    n_steps = comm.agree_steps((len(tasks) + rows_per_step - 1) // rows_per_step)
    with timer.stage("scan"):
        flushed = 0
        for task in feeder:
            if is_class_dict:
                # the dictionary resolves two block shapes with no device
                # work: target class absent (count 0) and single-class
                # all-match (count n_valid) — the host already paid the one
                # u8 pass to build the dictionary
                npres = int(task.columns["np"][0])
                if int(task.columns["t"][0]) >= npres:
                    continue
                if npres == 1:
                    host_total += task.n_valid
                    continue
            batch.append(task)
            if len(batch) == rows_per_step:
                flush(batch)
                flushed += 1
                batch = []
        if batch:
            flush(batch)
            flushed += 1
        while flushed < n_steps:  # other hosts still have steps: match them
            flush([])
            flushed += 1
        drain(0)
    timer.seconds["decode_cpu"] += feeder.decode_seconds

    return comm.finish_total(device_total, host_total), [], []


# ---------------------------------------------------------------------------
# collect path (output and/or density)
# ---------------------------------------------------------------------------


def _run_collect(
    plan, files, readers, active, file_bounds, grid, *,
    block_size, n_devices, workers, prefetch, timer, keep_hits,
    block_index=None, index_collectors=None, print_stream=None,
    density_state_out=None, comm=None,
):
    """Collect-path driver: density goes to the grid-sampling pipeline,
    everything else through the sharded batched compaction path."""
    from .parallel.comm import LocalStepComm

    comm = comm or LocalStepComm()
    emitter = HitEmitter(
        readers,
        output_dir=plan.output_dir,
        print_stream=print_stream,
        keep_hits=keep_hits,
    )
    if plan.density is not None:
        # density always runs host-local (distributed_density merges per
        # -host grids/keys itself; a global-mesh density step would ship
        # candidate payloads across hosts for nothing)
        _run_density(
            plan, readers, active, file_bounds, grid, emitter,
            block_size=block_size, n_devices=n_devices,
            workers=workers, prefetch=prefetch,
            timer=timer, block_index=block_index,
            index_collectors=index_collectors,
            state_out=density_state_out,
        )
        total = emitter.total
    else:
        _run_collect_mesh(
            plan, readers, active, file_bounds, emitter,
            block_size=block_size, n_devices=n_devices,
            workers=workers, prefetch=prefetch, timer=timer,
            block_index=block_index, index_collectors=index_collectors,
            comm=comm,
        )
        # hit payloads never cross hosts; only the count is all-reduced
        total = comm.reduce_sum(emitter.total)
    return total, emitter.all_hits, emitter.output_files


def _run_collect_mesh(
    plan, readers, active, file_bounds, emitter, *,
    block_size, n_devices, workers, prefetch, timer,
    block_index=None, index_collectors=None, comm=None,
):
    """Mesh-parallel streaming collect.

    The reference runs every query type through the same rayon fan-out
    (main.rs:146-183); here collect rides the same D-chip x K-block batched
    dispatch as the count path: one sharded step fuses the predicate with
    per-block index compaction (counts + cap-bounded index buffers), so
    there is no per-block host round trip. Blocks whose hit count exceeds
    the current cap are retried once with a power-of-two bucket, and the cap
    adapts upward so steady state is a single pass. Hits stream to the
    emitter in file order as each step's results resolve — peak host memory
    is O(gather chunk), never O(total hits).
    """
    from collections import deque

    from .index import (
        bbox_scan_ranges, class_present_ranges, time_scan_ranges,
    )

    from .parallel.comm import LocalStepComm

    comm = comm or LocalStepComm()
    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None
    kind = "bbox" if is_bounds else ("time" if is_time else "class")
    mesh = comm.make_mesh(n_devices)
    d = mesh.devices.size
    blocks_per_step = int(os.environ.get("AQPC_BLOCKS_PER_STEP", "4"))
    rows_per_step = comm.batch_rows(mesh, max(1, blocks_per_step))
    block_index = block_index or {}
    index_collectors = index_collectors or {}

    if is_time:
        q_enc = np.asarray(
            predicate.encode_f64_scalar(plan.time_range.start)
            + predicate.encode_f64_scalar(plan.time_range.end),
            np.int32,
        )

    # Ordered per-file emission plan: "all" items are index-CONTAINED blocks
    # (every point matches, no device pass) interleaved in position with the
    # scanned blocks so hits still stream out in file order.
    emit_queue: dict[int, deque] = {i: deque() for i in active}
    tasks = []
    for i in active:
        n = readers[i].point_count
        idx_info = block_index.get(i)
        if idx_info is not None and not is_bounds and not is_time:
            # class sub-block pruning at FILE scope, packed into full
            # multi-range blocks (see _run_count): skipped ranges are
            # proven hit-free so emission order is unaffected
            ranges = class_present_ranges(
                idx_info[2], idx_info[0], 0, n,
                plan.classification.classification,
            )
            kept = sum(e - s for s, e in ranges)
            if kept < n:
                timer.counts["index_skipped_blocks"] += max(
                    (n - kept) // idx_info[0], 1)
                timer.counts["index_pruned_points"] += n - kept
            new_tasks = _pack_range_tasks(i, ranges, block_size)
            for _ in new_tasks:
                emit_queue[i].append(("scan",))
            tasks += new_tasks
            continue
        if idx_info is not None and (
            is_bounds or (is_time and idx_info[3] is not None)
        ):
            # bbox/GPS-time sub-block pruning at FILE scope (see
            # _run_count). Emission stays in file order: scan ranges are
            # packed SEGMENT-WISE between contained ranges, so every
            # packed task's points lie strictly between the neighboring
            # "all" entries in the emit queue.
            if is_bounds:
                lo, hi = file_bounds[i]
                scan_rs, cont_rs = bbox_scan_ranges(
                    idx_info[1], idx_info[0], 0, n, lo, hi)
            else:
                scan_rs, cont_rs = time_scan_ranges(
                    idx_info[3], idx_info[0], 0, n,
                    plan.time_range.start, plan.time_range.end)
            cont_pts = sum(e - s for s, e in cont_rs)
            scan_pts = sum(e - s for s, e in scan_rs)
            if cont_pts:
                timer.counts["index_contained_blocks"] += max(
                    cont_pts // idx_info[0], 1)
            if n - scan_pts - cont_pts > 0:
                timer.counts["index_skipped_blocks"] += max(
                    (n - scan_pts - cont_pts) // idx_info[0], 1)
            timer.counts["index_pruned_points"] += n - scan_pts

            def flush_segment(seg):
                new_tasks = _pack_range_tasks(i, seg, block_size)
                for _ in new_tasks:
                    emit_queue[i].append(("scan",))
                tasks.extend(new_tasks)

            seg: list[tuple[int, int]] = []
            ci = 0
            for s, e in scan_rs:
                while ci < len(cont_rs) and cont_rs[ci][1] <= s:
                    flush_segment(seg)
                    seg = []
                    emit_queue[i].append(("all",) + cont_rs[ci])
                    ci += 1
                seg.append((s, e))
            flush_segment(seg)
            for cs, ce in cont_rs[ci:]:
                emit_queue[i].append(("all", cs, ce))
            continue
        for b in range((n + block_size - 1) // block_size):
            start = b * block_size
            stop = min(start + block_size, n)
            emit_queue[i].append(("scan",))
            tasks.append((i, b, start, stop))

    pack = _pack_transport_enabled()
    transform = None
    if is_bounds:
        # raw load + whole-block transform: multi-range tasks concatenate
        # raw loads BEFORE packing (see _run_count)
        def load(file_idx, start, stop):
            pos = readers[file_idx].column("position", start, stop)
            collector = index_collectors.get(file_idx)
            if collector is not None:
                collector.update(start, pos)
            return {"pos": pos}

        def transform(file_idx, cols):
            pos = cols["pos"]
            if not pack:
                return {
                    "x": np.ascontiguousarray(pos[:, 0]),
                    "y": np.ascontiguousarray(pos[:, 1]),
                    "z": np.ascontiguousarray(pos[:, 2]),
                }
            # packed transport (see _run_count): residuals only — retries
            # re-test the raw columns host-kept under xp/yp/zp, and hit
            # ATTRIBUTES are gathered from the readers by index, so raw
            # coords never cross the link
            return _packed_xyz_cols(pos, block_size)
    elif is_time:
        def load(file_idx, start, stop):
            gps = readers[file_idx].column("gps_time", start, stop)
            th, tl = predicate.encode_f64_sortable(gps)
            return {"th": th, "tl": tl}

        if pack:
            transform = lambda file_idx, cols: _packed_time_cols(  # noqa: E731
                cols["th"], cols["tl"], block_size)
    else:
        target_val = plan.classification.classification

        # raw load + whole-block transform (multi-range tasks concatenate
        # raw loads first — see _run_count). Unlike the count path,
        # absent-target / single-class blocks still ship (>= 1-bit
        # planes): host-resolving them here would have to thread through
        # the ordered emit queue anyway, and the device already resolves
        # them for free (miss code / all-match).
        def load(file_idx, start, stop):
            return {"cls": np.ascontiguousarray(
                readers[file_idx].column("classification", start, stop)
            )}

        if pack:
            transform = lambda file_idx, cols: _packed_class_cols(  # noqa: E731
                cols["cls"], target_val, block_size)

    feeder = BlockFeeder(
        tasks, load, block_size,
        file_bounds=file_bounds, workers=workers, prefetch=prefetch, pad=False,
        transform_fn=transform,
    )

    def packed_bounds(task):
        """Residual-space (lo, hi) for one packed block.

        The i64->i32 clip is exact under the width rule above: sub-32
        widths are <= 28 bits, so residuals stay < 2^28 and can never
        equal a saturated bound (+-2^31-ish); k == 32 forces base = 0, so
        lo/hi pass through unclipped. (With exact per-block widths a k=31
        block could produce residual 2^31-1 == the saturated lo and count
        a point below the box — caught by review, fixed by the cap.)"""
        i32 = np.iinfo(np.int32)
        lo = np.clip(task.lo.astype(np.int64) - task.columns["base"],
                     i32.min, i32.max).astype(np.int32)
        hi = np.clip(task.hi.astype(np.int64) - task.columns["base"],
                     i32.min, i32.max).astype(np.int32)
        return lo, hi

    # Hit-index buffer cap per block. counts come back exact regardless, so
    # overflow is detected, retried at the right power-of-two bucket, and
    # the cap ratchets up — at most log2(block/cap0) recompiles per query.
    cap = min(int(os.environ.get("AQPC_COLLECT_CAP", "8192")), block_size)

    finalize_order = [i for i in active]
    next_final = 0  # position in finalize_order of the next unfinalized file

    def finalize_through(file_idx_inclusive):
        nonlocal next_final
        while next_final < len(finalize_order) and finalize_order[next_final] <= file_idx_inclusive:
            i = finalize_order[next_final]
            q = emit_queue[i]
            while q:
                item = q.popleft()
                if item[0] == "all":
                    emitter.emit_range(i, item[1], item[2])
            emitter.finalize_file(i)
            next_final += 1

    def emit_scan_result(task, local_idx, full=False):
        from .parallel.pipeline import task_gidx

        i = task.file_idx
        finalize_through(i - 1)
        q = emit_queue[i]
        while q and q[0][0] == "all":
            _, s, e = q.popleft()
            emitter.emit_range(i, s, e)
        if q and q[0][0] == "scan":
            q.popleft()
        if full:
            if task.ranges is None:
                emitter.emit_range(i, task.start, task.start + task.n_valid)
            else:
                for s, e in task.ranges:
                    emitter.emit_range(i, s, e)
        elif local_idx is not None and len(local_idx):
            emitter.emit_indices(i, task_gidx(task, local_idx))

    def retry_block(task, count):
        from .parallel.pipeline import pad_to

        # pad to the engine block so retries reuse one compiled shape per cap
        cap2 = compact.pow2_bucket(count, block_size)
        nv = jnp.asarray(task.n_valid, jnp.int32)
        if kind == "bbox" and pack:
            # packed loads keep the raw columns (under xp/yp/zp), so the
            # retry re-tests them directly against the original bounds
            idx2 = compact.bbox_compact(
                jnp.asarray(pad_to(task.columns["xp"], block_size)),
                jnp.asarray(pad_to(task.columns["yp"], block_size)),
                jnp.asarray(pad_to(task.columns["zp"], block_size)),
                jnp.asarray(task.lo), jnp.asarray(task.hi), nv, cap=cap2,
            )
        elif kind == "bbox":
            idx2 = compact.bbox_compact(
                jnp.asarray(pad_to(task.columns["x"], block_size)),
                jnp.asarray(pad_to(task.columns["y"], block_size)),
                jnp.asarray(pad_to(task.columns["z"], block_size)),
                jnp.asarray(task.lo), jnp.asarray(task.hi), nv, cap=cap2,
            )
        elif kind == "time":
            # packed loads keep the raw encoded pair under thp/tlp
            th = task.columns["thp" if pack else "th"]
            tl = task.columns["tlp" if pack else "tl"]
            idx2 = compact.time_compact(
                jnp.asarray(pad_to(th, block_size)),
                jnp.asarray(pad_to(tl, block_size)),
                jnp.asarray(q_enc), nv, cap=cap2,
            )
        elif pack:
            # dictionary codes select the same index set as raw classes:
            # cls == target  <=>  code == tcode (tcode = len(dict) on a
            # miss, which no code equals)
            idx2 = compact.class_compact(
                jnp.asarray(pad_to(task.columns["clsp"], block_size)),
                jnp.asarray(int(task.columns["t"][0]), jnp.int32),
                nv, cap=cap2,
            )
        else:
            idx2 = compact.class_compact(
                jnp.asarray(pad_to(task.columns["cls"], block_size)),
                jnp.asarray(plan.classification.classification, jnp.int32),
                nv, cap=cap2,
            )
        return np.asarray(idx2[:count])

    pending = deque()

    def flush(batch):
        nonlocal cap
        # multi-host: the collect program's cap must match across hosts
        # (it's a static shape); take the max so local ratchets propagate
        cap = comm.agree_cap(cap)
        rows = comm.step_rows(mesh, len(batch), rows_per_step)
        pad = rows - len(batch)
        nvs = np.asarray([t.n_valid for t in batch] + [0] * pad, np.int32)
        step_kind = kind
        step_extra = ()
        if kind == "bbox" and pack:
            wmax = comm.agree_widths(
                np.maximum.reduce([t.columns["w"] for t in batch])
                if batch else np.zeros(3, np.int64)
            )
            pbounds = [packed_bounds(t) for t in batch]
            arrays = (
                _stack_planes(batch, "xp", 0, rows, int(wmax[0]), block_size),
                _stack_planes(batch, "yp", 1, rows, int(wmax[1]), block_size),
                _stack_planes(batch, "zp", 2, rows, int(wmax[2]), block_size),
                np.stack([b[0] for b in pbounds] + [np.zeros(3, np.int32)] * pad),
                np.stack([b[1] for b in pbounds] + [np.full(3, -1, np.int32)] * pad),
                nvs,
            )
            step_kind = "bbox_packed"
            step_extra = ((int(wmax[0]), int(wmax[1]), int(wmax[2])), block_size)
        elif kind == "bbox":
            arrays = (
                _stack_rows(batch, "x", rows, block_size, np.int32),
                _stack_rows(batch, "y", rows, block_size, np.int32),
                _stack_rows(batch, "z", rows, block_size, np.int32),
                np.stack([t.lo for t in batch] + [np.zeros(3, np.int32)] * pad),
                np.stack([t.hi for t in batch] + [np.zeros(3, np.int32)] * pad),
                nvs,
            )
        elif kind == "time" and pack:
            wmax = comm.agree_widths(
                np.maximum.reduce([t.columns["w"] for t in batch])
                if batch else np.zeros(2, np.int64)
            )
            q_rows = [_packed_time_query(q_enc, t.columns["base"]) for t in batch]
            q_rows += [np.zeros(4, np.int32)] * pad
            arrays = (
                _stack_planes(batch, "thp", 0, rows, int(wmax[0]), block_size),
                _stack_planes(batch, "tlp", 1, rows, int(wmax[1]), block_size),
                np.stack(q_rows),
                nvs,
            )
            step_kind = "time_packed"
            step_extra = ((int(wmax[0]), int(wmax[1])), block_size)
        elif kind == "time":
            arrays = (
                _stack_rows(batch, "th", rows, block_size, np.int32),
                _stack_rows(batch, "tl", rows, block_size, np.int32),
                np.tile(q_enc, (rows, 1)),
                nvs,
            )
        elif pack:
            kmax = int(comm.agree_widths(np.asarray(
                [max(int(t.columns["w"][0]) for t in batch) if batch else 0],
                np.int64,
            ))[0])
            arrays = (
                _stack_planes(batch, "clsp", 0, rows, kmax, block_size),
                np.asarray(
                    [int(t.columns["t"][0]) for t in batch] + [0] * pad, np.int32
                ),
                nvs,
            )
            step_kind = "class_dict"
            step_extra = (kmax, block_size)
        else:
            arrays = (
                _stack_rows(batch, "cls", rows, block_size, np.uint8),
                np.full(rows, plan.classification.classification, np.int32),
                nvs,
            )
        counts_dev, idx_dev = mesh_mod.sharded_collect(
            mesh, step_kind, comm.put(mesh, arrays), cap, step_extra
        )
        pending.append((batch, counts_dev, idx_dev, cap))
        drain((comm.inflight() or MAX_INFLIGHT_STEPS) - 1)

    # Emission (disk gather of hit attributes, LAS encode, printing) runs on
    # ONE ordered worker thread so it overlaps the next device steps — the
    # emitter itself is single-threaded by construction (strict file order),
    # so a single consumer keeps its invariants while freeing the main loop.
    import queue as queue_mod
    import threading

    emit_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=8)
    emit_error: list[BaseException] = []

    def emit_worker():
        while True:
            item = emit_q.get()
            if item is None:
                return
            try:
                if not emit_error:
                    item()
            except BaseException as e:  # propagate to the main thread
                emit_error.append(e)
            finally:
                emit_q.task_done()

    emit_thread = threading.Thread(target=emit_worker, daemon=True)
    emit_thread.start()

    def submit_emit(fn):
        if emit_error:
            raise emit_error[0]
        emit_q.put(fn)

    def process(batch, counts_dev, idx_dev, cap_used):
        nonlocal cap
        counts = comm.fetch_rows(counts_dev)[: len(batch)]
        need_idx = any(
            0 < int(c) < batch[j].n_valid and int(c) <= cap_used
            for j, c in enumerate(counts)
        )
        idx_np = comm.fetch_rows(idx_dev) if need_idx else None
        for j, task in enumerate(batch):
            c = int(counts[j])
            if c == 0:
                submit_emit(lambda t=task: emit_scan_result(t, None))
            elif c == task.n_valid:
                # whole block matches: indices are implied, skip the fetch
                submit_emit(lambda t=task: emit_scan_result(t, None, full=True))
            elif c <= cap_used:
                local = idx_np[j, :c].copy()
                submit_emit(lambda t=task, l=local: emit_scan_result(t, l))
            else:
                # retry needs a device dispatch: do it here (main thread owns
                # the device), hand only the resolved indices to the worker
                local = retry_block(task, c)
                submit_emit(lambda t=task, l=local: emit_scan_result(t, l))
        # ratchet the cap from PARTIAL blocks only: full-match blocks never
        # fetch indices (they emit an implied range), and sizing every
        # step's index buffer to the block size would cost
        # inflight * rows * block_size * 4 B of memory for nothing
        partial = [
            int(c) for j, c in enumerate(counts)
            if 0 < int(c) < batch[j].n_valid
        ]
        m = max(partial) if partial else 0
        if m > cap:
            cap = compact.pow2_bucket(m, block_size)

    def drain(limit: int):
        while len(pending) > limit:
            process(*pending.popleft())
        _gc_tick()

    n_steps = comm.agree_steps((len(tasks) + rows_per_step - 1) // rows_per_step)
    with timer.stage("scan"):
        try:
            batch = []
            flushed = 0
            for task in feeder:
                batch.append(task)
                if len(batch) == rows_per_step:
                    flush(batch)
                    flushed += 1
                    batch = []
            if batch:
                flush(batch)
                flushed += 1
            while flushed < n_steps:  # other hosts still have steps
                flush([])
                flushed += 1
            drain(0)
            if active:
                submit_emit(lambda: finalize_through(max(active)))
        finally:
            emit_q.put(None)
            emit_thread.join()
        if emit_error:
            raise emit_error[0]
    timer.seconds["decode_cpu"] += feeder.decode_seconds


def _run_density(
    plan, readers, active, file_bounds, grid, emitter, *,
    block_size, n_devices, workers, prefetch, timer,
    block_index=None, index_collectors=None, state_out=None,
):
    """Grid-sampling (max-density) collection, f64-exact and mesh-parallel.

    Device: one sharded dispatch fuses the query predicate with exact-cell
    candidate selection for D*K blocks of a file (ops/density.py — interior
    cells certified against exact integer boundary tables, leaders + f32
    -error-margin ties + uncertifiable points survive). Host: exact f64
    reference cell keys and d² for the few candidates per block, merged into
    the sparse running grid state. Per-file or global scope
    (main.rs:156 vs 129-133).
    """
    from collections import deque

    from .index import (
        DISJOINT, class_present, class_present_ranges, classify_block,
        classify_time_block,
    )

    is_bounds = plan.bounds is not None
    is_time = plan.time_range is not None
    kind = "bbox" if is_bounds else ("time" if is_time else "class")
    scope = plan.density.scope
    mesh = mesh_mod.make_mesh(n_devices)
    d = mesh.devices.size
    blocks_per_step = int(os.environ.get("AQPC_BLOCKS_PER_STEP", "4"))
    rows_per_step = d * max(1, blocks_per_step)
    block_index = block_index or {}
    index_collectors = index_collectors or {}

    if is_time:
        q_enc = np.asarray(
            predicate.encode_f64_scalar(plan.time_range.start)
            + predicate.encode_f64_scalar(plan.time_range.end),
            np.int32,
        )

    pack = _pack_transport_enabled()

    def load(file_idx, start, stop):
        r = readers[file_idx]
        pos = r.column("position", start, stop)
        collector = index_collectors.get(file_idx)
        if collector is not None:
            collector.update(start, pos)
        cols = {
            "x": np.ascontiguousarray(pos[:, 0]),
            "y": np.ascontiguousarray(pos[:, 1]),
            "z": np.ascontiguousarray(pos[:, 2]),
        }
        if is_time:
            th, tl = predicate.encode_f64_sortable(
                r.column("gps_time", start, stop)
            )
            cols["th"], cols["tl"] = th, tl
        elif not is_bounds:
            cols["cls"] = np.ascontiguousarray(
                r.column("classification", start, stop)
            )
        return cols

    transform = None
    if pack:
        # bit-planar xyz transport (raw columns kept under xp/yp/zp,
        # residualized at stack time) — density was the last raw
        # 12 B/pt path, and the host link bounds density end to end.
        # Runs as a whole-block transform so multi-range (index-packed)
        # class tasks residualize the CONCATENATED block.
        def transform(file_idx, cols):
            out = {}
            base = np.zeros(3, np.int64)
            w = np.empty(3, np.int64)
            for a, key in enumerate(("xp", "yp", "zp")):
                col = cols.pop("xyz"[a])
                k, mn = _residual_width(col, block_size)
                out[key] = col
                base[a] = mn
                w[a] = k
            out["base"] = base
            out["w"] = w
            out.update(cols)  # cls / th,tl ride raw
            return out

    cap = min(int(os.environ.get("AQPC_COLLECT_CAP", "8192")), block_size)
    # deferred-merge accumulators (ops/density.py WinnerAccum): exact same
    # fold as per-block merge_winners_host, O(N log N) total instead of
    # O(blocks * state log state) — the old per-block re-sort dominated
    # xl-density wall time at paper scale
    global_acc = density_ops.WinnerAccum()

    with timer.stage("scan"):
        for file_seq, file_idx in enumerate(active):
            r = readers[file_idx]
            n = r.point_count
            scale = r.header.scale
            offset = r.header.offset
            tables = grid.file_tables(scale, offset)
            tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}
            file_acc = density_ops.WinnerAccum()

            idx_info = block_index.get(file_idx)
            tasks = []
            if idx_info is not None and not is_bounds and not is_time:
                # class sub-block pruning at FILE scope, packed into full
                # multi-range blocks (see _run_count)
                ranges = class_present_ranges(
                    idx_info[2], idx_info[0], 0, n,
                    plan.classification.classification,
                )
                kept = sum(e - s for s, e in ranges)
                if kept < n:
                    timer.counts["index_skipped_blocks"] += max(
                        (n - kept) // idx_info[0], 1)
                    timer.counts["index_pruned_points"] += n - kept
                tasks = _pack_range_tasks(file_idx, ranges, block_size)
            else:
                tasks = _density_block_tasks(
                    file_idx, n, block_size, idx_info, is_bounds, is_time,
                    file_bounds, plan, timer,
                )

            feeder = BlockFeeder(
                tasks, load, block_size,
                file_bounds=file_bounds, workers=workers, prefetch=prefetch,
                pad=False, transform_fn=transform,
            )

            def xyz_col(task, axis):
                # packed loads keep the raw absolute columns under xp/yp/zp
                # (residualization happens at stack time), so single-block
                # retry/merge paths read them directly either way
                return task.columns[("xp", "yp", "zp")[axis] if pack
                                    else "xyz"[axis]]

            def pred_mask_dev(task):
                from .parallel.pipeline import pad_to

                nv = jnp.asarray(task.n_valid, jnp.int32)
                if kind == "bbox":
                    return predicate.bbox_mask(
                        jnp.asarray(pad_to(xyz_col(task, 0), block_size)),
                        jnp.asarray(pad_to(xyz_col(task, 1), block_size)),
                        jnp.asarray(pad_to(xyz_col(task, 2), block_size)),
                        jnp.asarray(task.lo), jnp.asarray(task.hi), nv,
                    )
                if kind == "time":
                    return predicate.time_mask_jnp(
                        jnp.asarray(pad_to(task.columns["th"], block_size)),
                        jnp.asarray(pad_to(task.columns["tl"], block_size)),
                        jnp.asarray(q_enc), nv,
                    )
                return predicate.class_mask(
                    jnp.asarray(pad_to(task.columns["cls"], block_size)),
                    jnp.asarray(plan.classification.classification, jnp.int32), nv,
                )

            def host_hit_mask(task):
                """Exact host-side predicate mask (or None fast-out),
                mirroring the device predicate bit for bit (inclusive int
                bbox / lexicographic encoded half-open time / u8
                equality). A block with zero predicate hits produces zero
                density candidates by definition, so it skips BOTH the H2D
                transfer and the device 5-key sort."""
                if kind == "bbox":
                    lo, hi = task.lo, task.hi
                    x = xyz_col(task, 0)
                    m = (x >= lo[0]) & (x <= hi[0])
                    if not m.any():
                        return None
                    y = xyz_col(task, 1)
                    m &= (y >= lo[1]) & (y <= hi[1])
                    if not m.any():
                        return None
                    z = xyz_col(task, 2)
                    m &= (z >= lo[2]) & (z <= hi[2])
                    return m if m.any() else None
                if kind == "time":
                    th, tl = task.columns["th"], task.columns["tl"]
                    ge = (th > q_enc[0]) | ((th == q_enc[0]) & (tl >= q_enc[1]))
                    if not ge.any():
                        return None
                    m = ge & ((th < q_enc[2]) | ((th == q_enc[2]) & (tl < q_enc[3])))
                    return m if m.any() else None
                m = task.columns["cls"] == plan.classification.classification
                return m if m.any() else None

            def merge_candidates(task, local_idx):
                from .parallel.pipeline import task_gidx

                if local_idx is None or len(local_idx) == 0:
                    return
                # fused native exact key/d2 straight from the gathered raw
                # int32 columns (no (n,3) f64 world materialization)
                winners = grid.make_winners_raw(
                    xyz_col(task, 0)[local_idx],
                    xyz_col(task, 1)[local_idx],
                    xyz_col(task, 2)[local_idx],
                    scale, offset,
                    task_gidx(task, local_idx), file_idx,
                )
                if scope == "file":
                    file_acc.add(winners, file_seq)
                else:
                    global_acc.add(winners, file_seq)

            def retry_block(task, count):
                from .parallel.pipeline import pad_to

                cap2 = compact.pow2_bucket(count, block_size)
                _, idx2 = density_ops.block_density_candidates(
                    jnp.asarray(pad_to(xyz_col(task, 0), block_size)),
                    jnp.asarray(pad_to(xyz_col(task, 1), block_size)),
                    jnp.asarray(pad_to(xyz_col(task, 2), block_size)),
                    pred_mask_dev(task),
                    task.n_valid, tables_dev, cap=cap2,
                )
                return np.asarray(idx2[:count])

            pending = deque()

            def flush(batch):
                rows = ((len(batch) + d - 1) // d) * d
                pad = rows - len(batch)
                nvs = np.asarray([t.n_valid for t in batch] + [0] * pad, np.int32)
                if pack:
                    wmax = (
                        np.maximum.reduce([t.columns["w"] for t in batch])
                        if batch else np.zeros(3, np.int64)
                    )
                    xs = _stack_planes(batch, "xp", 0, rows, int(wmax[0]),
                                       block_size)
                    ys = _stack_planes(batch, "yp", 1, rows, int(wmax[1]),
                                       block_size)
                    zs = _stack_planes(batch, "zp", 2, rows, int(wmax[2]),
                                       block_size)
                    bases = np.stack(
                        [t.columns["base"].astype(np.int32) for t in batch]
                        + [np.zeros(3, np.int32)] * pad
                    )
                    head = (xs, ys, zs, bases)
                else:
                    xs = _stack_rows(batch, "x", rows, block_size, np.int32)
                    ys = _stack_rows(batch, "y", rows, block_size, np.int32)
                    zs = _stack_rows(batch, "z", rows, block_size, np.int32)
                    head = (xs, ys, zs)
                if kind == "bbox":
                    tail = (
                        np.stack([t.lo for t in batch] + [np.zeros(3, np.int32)] * pad),
                        np.stack([t.hi for t in batch] + [np.zeros(3, np.int32)] * pad),
                        nvs,
                    )
                elif kind == "time":
                    tail = (
                        _stack_rows(batch, "th", rows, block_size, np.int32),
                        _stack_rows(batch, "tl", rows, block_size, np.int32),
                        np.tile(q_enc, (rows, 1)),
                        nvs,
                    )
                else:
                    tail = (
                        _stack_rows(batch, "cls", rows, block_size, np.uint8),
                        np.full(rows, plan.classification.classification, np.int32),
                        nvs,
                    )
                if pack:
                    counts_dev, idx_dev = mesh_mod.sharded_density_packed(
                        mesh, kind, head + tail, tables_dev, cap,
                        (int(wmax[0]), int(wmax[1]), int(wmax[2])), block_size,
                    )
                else:
                    counts_dev, idx_dev = mesh_mod.sharded_density(
                        mesh, kind, head + tail, tables_dev, cap
                    )
                pending.append((batch, counts_dev, idx_dev, cap))
                drain(MAX_INFLIGHT_STEPS - 1)

            def process(batch, counts_dev, idx_dev, cap_used):
                nonlocal cap
                counts = np.asarray(counts_dev)[: len(batch)]
                idx_np = np.asarray(idx_dev) if (counts > 0).any() else None
                for j, task in enumerate(batch):
                    c = int(counts[j])
                    if c == 0:
                        continue
                    if c <= cap_used:
                        merge_candidates(task, idx_np[j, :c])
                    else:
                        merge_candidates(task, retry_block(task, c))
                m = int(counts.max()) if len(counts) else 0
                if m > cap:
                    cap = compact.pow2_bucket(m, block_size)

            def drain(limit: int):
                while len(pending) > limit:
                    process(*pending.popleft())
                _gc_tick()

            # Sparse gather-packing: a block whose predicate matches only a
            # few points would still pay a full 2M-row 5-key device sort
            # (the dominant density cost — a selective box crossing many
            # Morton tiles sorts the whole file for a handful of hits).
            # Instead, hits from such blocks are host-gathered (predicate
            # pre-applied, so only xyz ships) and dispatched through the
            # single-block kernel at the pow2 bucket of the ACTUAL hit
            # count — one small sort covers the survivors of MANY source
            # blocks instead of a padded full-width step each. cap=bucket
            # makes candidate overflow impossible (candidates <= n_valid),
            # so there is no retry path. Exact: cell assignment is
            # per-point, leaders are per-sort-domain, and the candidate
            # invariant (leader + f32-margin ties survive) holds for any
            # grouping of predicate-passing points.
            from .parallel.pipeline import pad_to, task_gidx as _tg

            sparse_max = block_size // 8
            sparse_xyz: list[tuple] = []
            sparse_gidx: list[np.ndarray] = []
            sparse_total = 0
            batch = []

            def push(t):
                nonlocal batch
                batch.append(t)
                if len(batch) == rows_per_step:
                    flush(batch)
                    batch = []

            def flush_sparse():
                nonlocal sparse_xyz, sparse_gidx, sparse_total
                if not sparse_total:
                    return
                xs = np.concatenate([t[0] for t in sparse_xyz])
                ys = np.concatenate([t[1] for t in sparse_xyz])
                zs = np.concatenate([t[2] for t in sparse_xyz])
                gmap = np.concatenate(sparse_gidx)
                sparse_xyz, sparse_gidx, sparse_total = [], [], 0
                bucket = compact.pow2_bucket(len(xs), block_size)
                counts_d, idx_d = density_ops.block_density_candidates(
                    jnp.asarray(pad_to(xs, bucket)),
                    jnp.asarray(pad_to(ys, bucket)),
                    jnp.asarray(pad_to(zs, bucket)),
                    jnp.ones(bucket, bool), len(xs), tables_dev, cap=bucket,
                )
                c = int(counts_d)
                lidx = np.asarray(idx_d[:c])
                winners = grid.make_winners_raw(
                    xs[lidx], ys[lidx], zs[lidx], scale, offset,
                    gmap[lidx], file_idx,
                )
                if scope == "file":
                    file_acc.add(winners, file_seq)
                else:
                    global_acc.add(winners, file_seq)

            for task in feeder:
                m = host_hit_mask(task)
                if m is None:
                    timer.counts["host_prefiltered_blocks"] += 1
                    continue
                nhits = int(np.count_nonzero(m))
                if nhits > sparse_max:
                    push(task)
                    continue
                idx = np.nonzero(m)[0]
                sparse_xyz.append((
                    xyz_col(task, 0)[idx],
                    xyz_col(task, 1)[idx],
                    xyz_col(task, 2)[idx],
                ))
                sparse_gidx.append(_tg(task, idx))
                sparse_total += nhits
                timer.counts["density_sparse_blocks"] += 1
                if sparse_total >= block_size - sparse_max:
                    flush_sparse()
            flush_sparse()
            if batch:
                flush(batch)
            drain(0)
            timer.seconds["decode_cpu"] += feeder.decode_seconds

            if scope == "file":
                file_state = file_acc.result()
                if state_out is not None:
                    state_out.setdefault("file", {})[file_idx] = file_state
                emitter.emit_hits(file_idx, _winners_to_hits(file_state, r, file_idx))
                emitter.finalize_file(file_idx)

    if scope == "global":
        global_state = global_acc.result()
        if state_out is not None:
            state_out["global"] = global_state
        combined: list[FileHits] = []
        if global_state is not None and len(global_state):
            for file_idx in np.unique(global_state["file_idx"]):
                sub = global_state[global_state["file_idx"] == file_idx]
                combined.append(_winners_to_hits(sub, readers[file_idx], int(file_idx)))
        merged = concat_hits(combined)
        emitter.emit_hits(-1, merged)
        emitter.finalize_file(-1)


def _winners_to_hits(state: np.ndarray | None, reader, file_idx: int) -> FileHits:
    if state is None or len(state) == 0:
        return empty_hits(file_idx)
    return gather_hits(reader, np.sort(state["gidx"]), file_idx)

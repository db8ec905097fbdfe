"""Multi-process distributed queries under `jax.distributed`.

The reference is strictly single-process (rayon threads, SURVEY §2.5); its
"all-reduce" is a fold over per-file collectors on the main thread
(main.rs:164-180). The device lift: every process runs the same SPMD
program under `jax.distributed`, reads its own shard of the file manifest
(the rayon-per-file model raised to processes), feeds its local devices,
and the per-step `psum` spans the GLOBAL mesh — the collectives are
inserted by XLA (NCCL on GPUs), no hand-rolled MPI.

Since round 4 the multi-host path IS the local engine: `DistStepComm`
(implementing parallel/comm.py's strategy surface) is handed to
`engine.run_query`, so the decode-ahead BlockFeeder, bit-planar packed
transport (xyz + GPS-time), class-dictionary transport, and sidecar-index
pruning all run unchanged per host. The comm only contributes the collective
glue: global-mesh construction, per-step width/cap agreement (packed widths
and collect caps are static shapes — every host must compile the identical
program), process-local -> global array assembly, per-host shard readback,
and the final count all-reduce. Hit payloads never cross hosts.

Caps, steps, widths and block sizes are agreed via tiny cross-process all-reduces, so
hosts never diverge — no divergence, no deadlock. Single-host processes
degenerate gracefully (process_count == 1 makes every agreement an
identity), which is how this is exercised in CI; tools/dist2.py proves the
2-process gloo boundary for every query kind.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.query import QueryPlan


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up jax.distributed (no-op if already initialized or single host).

    Must run before anything initializes a JAX backend, so it asks
    jax.distributed itself rather than jax.process_count()."""
    if coordinator_address is None or jax.distributed.is_initialized():
        return  # single-process mode, or already up
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh() -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()), axis_names=("d",))


def shard_manifest(files: list[Path]) -> list[Path]:
    """This process's slice of the file manifest (round-robin by process)."""
    pid, n = jax.process_index(), jax.process_count()
    return [f for i, f in enumerate(files) if i % n == pid]


def _allreduce_max(value: int, mesh: Mesh) -> int:
    """Agree on max(value) across processes (tiny sharded cross-process reduction)."""
    if jax.process_count() == 1:
        return value
    d_local = len(jax.local_devices())
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("d")),
        np.full(d_local, value, np.int64),
        (mesh.devices.size,),
    )
    return int(jnp.max(arr))


def _allreduce_max_vec(values: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Field-wise max of a small int vector across processes (packed-width
    agreement: every host must compile the same static width tuple)."""
    if jax.process_count() == 1:
        return values
    d_local = len(jax.local_devices())
    local = np.tile(np.asarray(values, np.int64), (d_local, 1))
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("d", None)),
        local,
        (mesh.devices.size, local.shape[1]),
    )
    return np.asarray(jnp.max(arr, axis=0)).astype(values.dtype)


def _allreduce_sum(value: int, mesh: Mesh) -> int:
    if jax.process_count() == 1:
        return value
    d_local = len(jax.local_devices())
    local = np.zeros(d_local, np.int64)
    local[0] = value
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("d")), local, (mesh.devices.size,)
    )
    return int(jnp.sum(arr))


class DistStepComm:
    """Multi-host step-communication strategy for engine.run_query.

    See parallel/comm.py for the contract. Every agreement is a tiny cross-process
    all-reduce; step operands are lifted to global arrays from process-local
    shards (jax.make_array_from_process_local_data), and step outputs are
    read back shard-wise so a host only ever touches its own rows."""

    is_local = False

    def __init__(self):
        self._mesh = global_mesh()

    def make_mesh(self, n_devices=None):
        return self._mesh

    def agree_block_size(self, block_size: int) -> int:
        return _allreduce_max(block_size, self._mesh)

    def batch_rows(self, mesh, blocks_per_device: int) -> int:
        return len(jax.local_devices()) * blocks_per_device

    def step_rows(self, mesh, n_batch: int, rows_per_step: int) -> int:
        # fixed step shape: every host pads to the same local row count
        return rows_per_step

    def agree_steps(self, n_steps: int) -> int:
        return _allreduce_max(n_steps, self._mesh)

    def agree_widths(self, widths: np.ndarray) -> np.ndarray:
        return _allreduce_max_vec(widths, self._mesh)

    def agree_cap(self, cap: int) -> int:
        return _allreduce_max(cap, self._mesh)

    def inflight(self) -> int:
        # synchronous steps: the cap ratchet must apply at the same step
        # boundary on every host (the feeder still decodes ahead)
        return 1

    def put(self, mesh, arrays: tuple) -> tuple:
        # every host contributes the same fixed row count (step_rows), so
        # the global leading dim is local rows x process count
        out = []
        for a in arrays:
            spec = P("d") if a.ndim == 1 else P("d", None)
            out.append(
                jax.make_array_from_process_local_data(
                    NamedSharding(mesh, spec), a,
                    (a.shape[0] * jax.process_count(),) + a.shape[1:],
                )
            )
        return tuple(out)

    def fetch_rows(self, dev) -> np.ndarray:
        shards = sorted(dev.addressable_shards, key=lambda s: s.index[0].start)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    def finish_total(self, device_total: int, host_total: int) -> int:
        return device_total + _allreduce_sum(host_total, self._mesh)

    def reduce_sum(self, value: int) -> int:
        return _allreduce_sum(value, self._mesh)


def _sharded_plan(input_path, plan: QueryPlan, parity_quirk: bool,
                  output_dir: Path | None):
    from ..engine import discover_files

    files = shard_manifest(discover_files(input_path))
    if parity_quirk and not plan.parity_quirk:
        plan = dataclasses.replace(plan, parity_quirk=True)
    if output_dir is not None and plan.output_dir != output_dir:
        plan = dataclasses.replace(plan, output_dir=Path(output_dir))
    return files, plan


def distributed_query(
    input_path: str | Path,
    plan: QueryPlan,
    *,
    block_size: int = 1 << 21,
    parity_quirk: bool = False,
    use_index: bool = True,
    output_dir: Path | None = None,
    print_stream=None,
    keep_hits: bool = False,
):
    """Run one plan over all hosts' manifest shards through the REAL engine
    (run_query + DistStepComm). Returns the engine's QueryResult: its
    match_count is the global total; hits/output_files are this host's
    (multi-process LAS dumps land under a per-host `host{i}/` subdir so a
    shared output directory never collides across hosts).

    Density plans are delegated to `distributed_density`: the engine's
    collect driver resolves winners host-locally, which is wrong across
    hosts (scope='global' needs cross-host per-key resolution; scope='file'
    needs the cell counts all-reduced). The returned result's hits and
    output_files are empty for density — `distributed_density` performs the
    write-back itself. Density results carry GLOBAL files_searched /
    total_file_bytes (all-reduced to match the global match_count); on the
    non-density path those two fields are HOST-LOCAL — run_query reports
    what this host scanned, and the reference-comparable MiB/s per host is
    exactly that — while match_count is the global psum."""
    from ..engine import run_query

    files, plan = _sharded_plan(input_path, plan, parity_quirk, output_dir)
    if plan.density is not None:
        from ..engine import QueryResult
        from ..utils.timing import StageTimer

        t0 = time.perf_counter()
        count = distributed_density(input_path, plan, block_size=block_size)
        mesh = global_mesh()
        return QueryResult(
            match_count=count, hits=[], output_files=[],
            total_file_bytes=_allreduce_sum(
                sum(f.stat().st_size for f in files), mesh),
            elapsed_seconds=time.perf_counter() - t0,
            timer=StageTimer(),
            files_searched=_allreduce_sum(len(files), mesh),
        )
    if plan.output_dir is not None and jax.process_count() > 1:
        plan = dataclasses.replace(plan, output_dir=_host_output_dir(plan))
    return run_query(
        files, plan, block_size=block_size, use_index=use_index,
        print_stream=print_stream, keep_hits=keep_hits, comm=DistStepComm(),
    )


def distributed_count(
    input_path: str | Path,
    plan: QueryPlan,
    *,
    block_size: int = 1 << 21,
    parity_quirk: bool = False,
) -> int:
    """bbox/class/GPS-time count over all hosts' file shards, global psum."""
    return distributed_query(
        input_path, plan, block_size=block_size, parity_quirk=parity_quirk
    ).match_count


# backwards-compatible alias (round-1 API)
def distributed_bbox_count(input_path, plan, *, block_size=1 << 21, parity_quirk=False):
    return distributed_count(
        input_path, plan, block_size=block_size, parity_quirk=parity_quirk
    )


def distributed_collect(
    input_path: str | Path,
    plan: QueryPlan,
    *,
    block_size: int = 1 << 21,
    parity_quirk: bool = False,
    output_dir: Path | None = None,
    print_stream=None,
    keep_hits: bool = False,
):
    """Collect query over all hosts' file shards.

    Every host participates in every sharded fused predicate+compaction
    step (identical program), reads back only its addressable shards of the
    (counts, indices) outputs, and gathers/dumps hits from its own files —
    the reference's per-file parallel collection (main.rs:153-161) lifted
    to hosts, with hit payloads never crossing the network. Returns
    (global match count, this host's QueryResult — .output_files/.hits are
    the host-local outputs)."""
    res = distributed_query(
        input_path, plan, block_size=block_size, parity_quirk=parity_quirk,
        output_dir=output_dir, print_stream=print_stream, keep_hits=keep_hits,
    )
    return res.match_count, res


def _allgather_slab_bytes() -> int:
    """Gathered-buffer budget per slab (AQPC_ALLGATHER_SLAB_KB, default
    64 MB: peak gather memory stays ~this regardless of winner-set size)."""
    return int(os.environ.get("AQPC_ALLGATHER_SLAB_KB", str(64 << 10))) << 10


def _allgather_i32_rows(
    rows: np.ndarray, mesh: Mesh, slab_bytes: int | None = None
) -> np.ndarray:
    """All-gather an (n, W) int32 matrix across processes -> (sum n, W).

    Each process contributes its row count in a header slot, payload
    flattened after, padding sliced off by count. All rows ship as int32
    words (the gloo CPU backend's s64 all_gather bit-interleaves payloads
    as s32 pairs — observed on jax 0.9.0, tools/dist2.py caught it).

    SLABBED: every process pads to the cross-host max row count, so a naive
    single gather materializes devices x maxn x W int32 on every host — at
    paper-scale global-density winner counts (~13M cells x 28 B wire rows)
    that is multiple GB per host. Instead the row space [0, maxn) is walked
    in fixed-size slabs whose *gathered* buffer stays <= slab_bytes, with
    one compiled gather program reused across slabs; peak memory scales
    with the slab budget, not devices x max-per-host."""
    if jax.process_count() == 1:
        return rows
    from jax import shard_map

    W = rows.shape[1]
    d_local = len(jax.local_devices())
    D = mesh.devices.size
    maxn = max(_allreduce_max(len(rows), mesh), 1)
    if slab_bytes is None:
        slab_bytes = _allgather_slab_bytes()
    slab_rows = max(1, slab_bytes // (D * W * 4))
    slab_rows = min(slab_rows, maxn)
    rows = np.ascontiguousarray(rows, np.int32)

    gather_fn = jax.jit(
        shard_map(
            lambda x: jax.lax.all_gather(x, "d", tiled=True),
            mesh=mesh, in_specs=P("d", None), out_specs=P(),
            # all_gather's result is the same on every device, but JAX
            # types it as varying over "d", so out_specs=P() fails the check
            check_vma=False,
        )
    )
    sharding = NamedSharding(mesh, P("d", None))
    width = 1 + slab_rows * W
    local = np.zeros((d_local, width), np.int32)
    parts = []
    for s0 in range(0, maxn, slab_rows):
        cnt = int(np.clip(len(rows) - s0, 0, slab_rows))
        local[0, 0] = cnt
        if cnt:
            local[0, 1 : 1 + cnt * W] = rows[s0 : s0 + cnt].ravel()
            if cnt < slab_rows:
                local[0, 1 + cnt * W :] = 0
        arr = jax.make_array_from_process_local_data(
            sharding, local, (D, width)
        )
        gathered = np.ascontiguousarray(gather_fn(arr))
        parts += [
            row[1 : 1 + row[0] * W].reshape(-1, W)
            for row in gathered if row[0] > 0
        ]
    if not parts:
        return np.empty((0, W), np.int32)
    return np.concatenate(parts, axis=0)


def _allgather_keys(keys: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Union of winner cell keys across processes (u64, order irrelevant).

    Rides the slabbed int32-word gather (_allgather_i32_rows): a count
    header per process rather than an in-band sentinel (a legitimate
    all-ones masked key, possible when sum(bits) == 64 or for wrapped
    beyond-max-face cells, would collide with any sentinel). Winner
    payloads never travel, only the 8-byte keys."""
    if jax.process_count() == 1:
        return keys
    rows = np.ascontiguousarray(keys).view(np.int32).reshape(-1, 2)
    return _allgather_i32_rows(rows, mesh).ravel().view(np.uint64)


def _host_output_dir(plan: QueryPlan) -> Path | None:
    """Per-host output subdir for multi-process runs: every host names its
    LAS dumps matching_points_{i} by LOCAL file index, so a shared directory
    would collide across hosts."""
    if plan.output_dir is None or jax.process_count() == 1:
        return plan.output_dir
    out = Path(plan.output_dir) / f"host{jax.process_index()}"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _winner_rows_i32(state, local_to_global) -> np.ndarray:
    """WINNER_DTYPE state -> (n, 7) int32 wire rows:
    key (2 words) | d2 bit pattern (2) | global file rank (1) | gidx (2)."""
    n = 0 if state is None else len(state)
    rows = np.zeros((n, 7), np.int32)
    if n:
        rows[:, 0:2] = np.ascontiguousarray(state["key"]).view(np.int32).reshape(n, 2)
        rows[:, 2:4] = np.ascontiguousarray(state["d2"]).view(np.int32).reshape(n, 2)
        rows[:, 4] = local_to_global(state["file_idx"].astype(np.int64)).astype(np.int32)
        rows[:, 5:7] = np.ascontiguousarray(
            state["gidx"].astype(np.int64)
        ).view(np.int32).reshape(n, 2)
    return rows


def distributed_density(
    input_path: str | Path,
    plan: QueryPlan,
    *,
    block_size: int = 1 << 21,
) -> int:
    """Max-density sampled count (and winner write-back) over all hosts'
    file shards.

    Every host runs the local density pipeline (device candidate pruning +
    exact f64 host resolution) over its manifest shard against ONE shared
    grid (global header bounds when the plan has no bbox).

    scope='file': winner sets are per-file and files never span hosts, so
    each host writes its own files' winners (per-host output subdir) and
    only the count is all-reduced.

    scope='global': winners are resolved per cell key across hosts by an
    all-gather of (key, d2 bits, global file rank, gidx) wire rows — 28 B
    per candidate winner, never the point payload. The global champion per
    key is the minimum by (d2, file rank, gidx), which equals the single
    -process engine's insertion-order tie rule exactly (merge_winners_host
    keeps the earlier-inserted on d2 ties, and single-process insertion
    order IS ascending (file, gidx)). Each host then dumps only the winners
    it owns, gathered from its own files — the reference's
    GridSampledCollector + dump (collect_points.rs:100-127) lifted to
    hosts."""
    from ..engine import discover_files, run_query
    from ..formats import open_point_cloud
    from ..utils.aabb import AABB

    all_files = discover_files(input_path)
    my_files = shard_manifest(all_files)
    mesh = global_mesh()
    nproc = jax.process_count()
    pid = jax.process_index()

    # shared grid bounds: the query box, or the union of ALL hosts' headers
    # (headers are cheap: every host reads every header)
    if plan.bounds is not None:
        grid_bounds = None  # run_query derives it from the box
    else:
        grid_bounds = AABB.empty()
        for f in all_files:
            r = open_point_cloud(f)
            grid_bounds = grid_bounds.union(r.header.bounds)
            r.close()

    scope = plan.density.scope
    host_out = _host_output_dir(plan)
    run_plan = plan
    if scope == "file":
        if host_out != plan.output_dir:
            run_plan = dataclasses.replace(plan, output_dir=host_out)
    elif nproc > 1 and plan.output_dir is not None:
        # global scope, multi-host: suppress the local (unresolved) dump;
        # the globally-resolved winners are written below
        run_plan = dataclasses.replace(plan, output_dir=None)

    state_out: dict = {}
    if my_files:
        run_query(
            my_files, run_plan, block_size=block_size,
            density_grid_bounds=grid_bounds, density_state_out=state_out,
        )
    if scope == "file":
        local = sum(
            len(s) for s in state_out.get("file", {}).values() if s is not None
        )
        return _allreduce_sum(local, mesh)

    g = state_out.get("global")
    if nproc == 1:
        # single process: run_query already wrote the merged output
        return 0 if g is None else len(g)

    # round-robin shard: local file j is global manifest entry j*nproc + pid
    rows = _winner_rows_i32(g, lambda j: j * nproc + pid)
    allrows = _allgather_i32_rows(rows, mesh)
    if len(allrows) == 0:
        return 0
    keys = np.ascontiguousarray(allrows[:, 0:2]).view(np.uint64).ravel()
    d2 = np.ascontiguousarray(allrows[:, 2:4]).view(np.float64).ravel()
    rank = allrows[:, 4].astype(np.int64)
    gidx = np.ascontiguousarray(allrows[:, 5:7]).view(np.int64).ravel()
    # champion per key = lexicographic min of (d2, rank, gidx) within key
    order = np.lexsort((gidx, rank, d2, keys))
    k_sorted = keys[order]
    first = np.ones(len(k_sorted), bool)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    win = order[first]
    count = int(first.sum())

    if plan.output_dir is not None:
        from ..sinks import HitEmitter, concat_hits, gather_hits

        mine = win[rank[win] % nproc == pid]
        my_readers = [open_point_cloud(f) for f in my_files]
        try:
            parts = []
            for r_rank in np.unique(rank[mine]):
                j = int(r_rank) // nproc  # local file index
                sel = mine[rank[mine] == r_rank]
                parts.append(gather_hits(my_readers[j], np.sort(gidx[sel]), j))
            emitter = HitEmitter(my_readers, output_dir=host_out)
            emitter.emit_hits(-1, concat_hits(parts))
            emitter.finalize_file(-1)
        finally:
            for r in my_readers:
                r.close()
    return count

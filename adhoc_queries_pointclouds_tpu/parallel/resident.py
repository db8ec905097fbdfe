"""Device-resident datasets: repeated ad-hoc queries at memory bandwidth.

The paper's engine re-reads files from disk on every query (cold-cache is
its headline protocol). An accelerator changes the economics: once the SoA
columns are resident in device memory (sharded over the device mesh), every
subsequent ad-hoc query is ONE device dispatch scanning at memory bandwidth
— no disk, no host, no decode. This is the interactive/serving story the reference cannot offer
and the main reason to run this workload on accelerators at all.

Sizing guide (80 GB card, of which a JAX process takes 75% = 60 GB by
default): positions are 12 B/point, classification 1 B/point and GPS time
8 B/point (the (hi, lo) int32 pair), 21 B/point in all. So ~5 B points fit
position-resident on one card and ~2.8 B with all three columns, before
query working space — the paper's ca13 (2.6 B points) fits
position-resident on one card (31 GB), and fully resident on four.

Counts are returned per block (int32, block <= 2^21 points) and summed on
the host in Python ints, so multi-billion-hit queries (ca13-XL ~2.6 B) never
overflow device int32.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats import open_point_cloud
from ..models.query import QueryPlan
from ..utils.aabb import clamp_bounds_to_i32, local_query_bounds
from . import mesh as mesh_mod

from jax import shard_map


def _stack_sharded(mesh: Mesh, arr: np.ndarray) -> jax.Array:
    return jax.device_put(arr, NamedSharding(mesh, P("d", *([None] * (arr.ndim - 1)))))


@dataclasses.dataclass
class ResidentDataset:
    mesh: Mesh
    block_size: int
    n_blocks: int  # padded to a multiple of the mesh size
    headers: list
    files: list[Path]
    file_idx: np.ndarray  # (n_blocks,) int32, -1 for padding blocks
    nvs: np.ndarray  # (n_blocks,) int32 valid points per block
    block_start: np.ndarray | None = None  # (n_blocks,) int64 file-local start
    xs: jax.Array | None = None  # (n_blocks, B) int32, sharded over 'd'
    ys: jax.Array | None = None
    zs: jax.Array | None = None
    cls: jax.Array | None = None  # (n_blocks, B) uint8, sharded over 'd'
    # GPS times as the order-preserving (hi, lo) int32 split encoding —
    # exact f64 range predicates with pure int32 device compares
    ths: jax.Array | None = None
    tls: jax.Array | None = None
    total_points: int = 0

    # ------------------------------------------------------------------

    @staticmethod
    def load(
        input_path: str | Path,
        *,
        attrs: tuple[str, ...] = ("position", "classification"),
        mesh: Mesh | None = None,
        block_size: int = 1 << 21,
        workers: int = 8,
    ) -> "ResidentDataset":
        from ..engine import clamp_block_size, discover_files
        from ..ops import predicate

        files = discover_files(input_path)
        if not files:
            raise FileNotFoundError(f"No supported point-cloud files under {input_path}")
        mesh = mesh or mesh_mod.make_mesh()
        d = mesh.devices.size
        readers = [open_point_cloud(f) for f in files]
        block_size = clamp_block_size(block_size, max(r.point_count for r in readers))

        tasks = []
        for i, r in enumerate(readers):
            n = r.point_count
            for b in range((n + block_size - 1) // block_size):
                start = b * block_size
                tasks.append((i, start, min(start + block_size, n)))
        n_blocks = ((len(tasks) + d - 1) // d) * d

        file_idx = np.full(n_blocks, -1, np.int32)
        nvs = np.zeros(n_blocks, np.int32)
        block_start = np.zeros(n_blocks, np.int64)
        want_pos = "position" in attrs
        want_cls = "classification" in attrs
        want_gps = "gps_time" in attrs
        xs = np.zeros((n_blocks, block_size), np.int32) if want_pos else None
        ys = np.zeros((n_blocks, block_size), np.int32) if want_pos else None
        zs = np.zeros((n_blocks, block_size), np.int32) if want_pos else None
        cls = np.zeros((n_blocks, block_size), np.uint8) if want_cls else None
        ths = np.zeros((n_blocks, block_size), np.int32) if want_gps else None
        tls = np.zeros((n_blocks, block_size), np.int32) if want_gps else None

        from concurrent.futures import ThreadPoolExecutor

        def fill(j):
            i, start, stop = tasks[j]
            r = readers[i]
            file_idx[j] = i
            nvs[j] = stop - start
            block_start[j] = start
            if want_pos:
                p = r.column("position", start, stop)
                xs[j, : stop - start] = p[:, 0]
                ys[j, : stop - start] = p[:, 1]
                zs[j, : stop - start] = p[:, 2]
            if want_cls:
                cls[j, : stop - start] = r.column("classification", start, stop)
            if want_gps:
                th, tl = predicate.encode_f64_sortable(
                    r.column("gps_time", start, stop)
                )
                ths[j, : stop - start] = th
                tls[j, : stop - start] = tl

        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            list(pool.map(fill, range(len(tasks))))

        ds = ResidentDataset(
            mesh=mesh,
            block_size=block_size,
            n_blocks=n_blocks,
            headers=[r.header for r in readers],
            files=files,
            file_idx=file_idx,
            nvs=nvs,
            block_start=block_start,
            xs=_stack_sharded(mesh, xs) if want_pos else None,
            ys=_stack_sharded(mesh, ys) if want_pos else None,
            zs=_stack_sharded(mesh, zs) if want_pos else None,
            cls=_stack_sharded(mesh, cls) if want_cls else None,
            ths=_stack_sharded(mesh, ths) if want_gps else None,
            tls=_stack_sharded(mesh, tls) if want_gps else None,
            total_points=int(nvs.sum()),
        )
        for r in readers:
            r.close()
        jax.block_until_ready(
            [a for a in (ds.xs, ds.ys, ds.zs, ds.cls, ds.ths, ds.tls) if a is not None]
        )
        return ds

    @property
    def resident_bytes(self) -> int:
        total = 0
        for a in (self.xs, self.ys, self.zs, self.cls, self.ths, self.tls):
            if a is not None:
                total += a.size * a.dtype.itemsize
        return total

    # ------------------------------------------------------------------

    def _bbox_fn(self):
        mesh = self.mesh

        def f(xs, ys, zs, los, his, nvs):
            idx = jax.lax.broadcasted_iota(jnp.int32, xs.shape, 1)
            m = idx < nvs[:, None]
            m &= (xs >= los[:, 0:1]) & (xs <= his[:, 0:1])
            m &= (ys >= los[:, 1:2]) & (ys <= his[:, 1:2])
            m &= (zs >= los[:, 2:3]) & (zs <= his[:, 2:3])
            return jnp.sum(m, axis=1, dtype=jnp.int32)

        return jax.jit(
            shard_map(
                f,
                mesh=mesh,
                in_specs=(
                    P("d", None), P("d", None), P("d", None),
                    P("d", None), P("d", None), P("d"),
                ),
                out_specs=P("d"),
            )
        )

    def _class_fn(self):
        mesh = self.mesh

        def f(cls, target, nvs):
            idx = jax.lax.broadcasted_iota(jnp.int32, cls.shape, 1)
            m = (idx < nvs[:, None]) & (cls.astype(jnp.int32) == target)
            return jnp.sum(m, axis=1, dtype=jnp.int32)

        return jax.jit(
            shard_map(
                f,
                mesh=mesh,
                in_specs=(P("d", None), P(), P("d")),
                out_specs=P("d"),
            )
        )

    def _time_fn(self):
        mesh = self.mesh

        def f(ths, tls, q, nvs):
            idx = jax.lax.broadcasted_iota(jnp.int32, ths.shape, 1)
            ge = (ths > q[0]) | ((ths == q[0]) & (tls >= q[1]))
            lt = (ths < q[2]) | ((ths == q[2]) & (tls < q[3]))
            m = ge & lt & (idx < nvs[:, None])
            return jnp.sum(m, axis=1, dtype=jnp.int32)

        return jax.jit(
            shard_map(
                f,
                mesh=mesh,
                in_specs=(P("d", None), P("d", None), P(), P("d")),
                out_specs=P("d"),
            )
        )

    def _block_mask(self, b: int, plan: QueryPlan, bounds_per_file: dict):
        """Predicate mask for one resident block (retry/density paths)."""
        from ..ops import predicate

        i = int(self.file_idx[b])
        nv = int(self.nvs[b])
        if plan.bounds is not None:
            lo, hi = bounds_per_file[i]
            return predicate.bbox_mask(
                self.xs[b], self.ys[b], self.zs[b],
                jnp.asarray(lo), jnp.asarray(hi), nv,
            )
        if plan.time_range is not None:
            q = np.asarray(
                predicate.encode_f64_scalar(plan.time_range.start)
                + predicate.encode_f64_scalar(plan.time_range.end),
                np.int32,
            )
            return predicate.time_mask_jnp(
                self.ths[b], self.tls[b], jnp.asarray(q), jnp.asarray(nv, jnp.int32)
            )
        return predicate.class_mask(
            self.cls[b], jnp.asarray(plan.classification.classification, jnp.int32), nv
        )

    def _file_bounds(self, plan: QueryPlan) -> dict:
        """Per-file integer query bounds + header prefilter (empty box for
        pruned files so padded blocks match nothing)."""
        out = {}
        for i, h in enumerate(self.headers):
            if not h.bounds.intersects(plan.bounds.bounds):
                continue
            lo64, hi64 = local_query_bounds(
                plan.bounds.bounds, h.scale, h.offset, parity_quirk=plan.parity_quirk
            )
            out[i] = clamp_bounds_to_i32(lo64, hi64)
        return out

    def collect(
        self,
        plan: QueryPlan,
        *,
        output_dir=None,
        print_stream=None,
        keep_hits: bool = False,
        cap: int = 8192,
    ):
        """Collect matching points: HBM-resident predicate + compaction (one
        sharded dispatch for the whole dataset), hit attributes gathered
        from the source files only for hit rows. Returns (count, HitEmitter).

        This is the serving analog of the engine's collect path: the scan
        never touches disk; disk IO is proportional to the result size."""
        from ..formats import open_point_cloud
        from ..ops import compact, predicate
        from ..sinks import HitEmitter

        if plan.density is not None:
            return self.density_collect(
                plan, output_dir=output_dir, print_stream=print_stream,
                keep_hits=keep_hits,
            )
        is_bounds = plan.bounds is not None
        is_time = plan.time_range is not None
        kind = "bbox" if is_bounds else ("time" if is_time else "class")
        if is_bounds and self.xs is None:
            raise ValueError("dataset loaded without position columns")
        if is_time and self.ths is None:
            raise ValueError("dataset loaded without gps_time columns")
        if kind == "class" and self.cls is None:
            raise ValueError("dataset loaded without classification column")

        cap = min(cap, self.block_size)
        nvs_eff = self.nvs.copy()
        bounds_per_file = {}
        if is_bounds:
            bounds_per_file = self._file_bounds(plan)
            los = np.zeros((self.n_blocks, 3), np.int32)
            his = np.full((self.n_blocks, 3), -1, np.int32)
            for i, (lo, hi) in bounds_per_file.items():
                sel = self.file_idx == i
                los[sel] = lo
                his[sel] = hi
            arrays = (self.xs, self.ys, self.zs, jnp.asarray(los),
                      jnp.asarray(his), jnp.asarray(nvs_eff))
        elif is_time:
            q = np.asarray(
                predicate.encode_f64_scalar(plan.time_range.start)
                + predicate.encode_f64_scalar(plan.time_range.end),
                np.int32,
            )
            arrays = (self.ths, self.tls, jnp.asarray(np.tile(q, (self.n_blocks, 1))),
                      jnp.asarray(nvs_eff))
        else:
            targets = np.full(self.n_blocks, plan.classification.classification, np.int32)
            arrays = (self.cls, jnp.asarray(targets), jnp.asarray(nvs_eff))

        counts_dev, idx_dev = mesh_mod.sharded_collect(self.mesh, kind, arrays, cap)
        counts = np.asarray(counts_dev)
        idx_np = np.asarray(idx_dev) if (counts > 0).any() else None

        readers = [open_point_cloud(f) for f in self.files]
        emitter = HitEmitter(
            readers, output_dir=output_dir, print_stream=print_stream,
            keep_hits=keep_hits,
        )
        try:
            for b in range(self.n_blocks):
                i = int(self.file_idx[b])
                if i < 0:
                    continue
                c = int(counts[b])
                nv = int(self.nvs[b])
                start = int(self.block_start[b])
                if c == 0:
                    continue
                if c == nv:
                    emitter.emit_range(i, start, start + nv)
                    continue
                if c <= cap:
                    local = idx_np[b, :c]
                else:
                    cap2 = compact.pow2_bucket(c, self.block_size)
                    mask = self._block_mask(b, plan, bounds_per_file)
                    idx2, _ = compact.compact_indices(mask, cap=cap2)
                    local = np.asarray(idx2[:c])
                emitter.emit_indices(i, local.astype(np.int64) + start)
            for i in range(len(self.files)):
                emitter.finalize_file(i)
        finally:
            for r in readers:
                r.close()
        return emitter.total, emitter

    def density_states(self, plan: QueryPlan):
        """Run the density query against resident blocks; returns
        (per-file states dict, global state) — exactly one is populated."""
        from ..ops import density as density_ops, predicate

        if plan.density is None:
            raise ValueError("density_states needs a density plan")
        if plan.time_range is not None and self.ths is None:
            raise ValueError("dataset loaded without gps_time columns")
        if self.xs is None:
            raise ValueError("dataset loaded without position columns")
        if plan.bounds is not None:
            grid_bounds = plan.bounds.bounds
        else:
            from ..utils.aabb import AABB

            grid_bounds = AABB.empty()
            for h in self.headers:
                grid_bounds = grid_bounds.union(h.bounds)
        grid = density_ops.GridSpec3D.create(grid_bounds, plan.density.cell_size)

        accs: dict[int, density_ops.WinnerAccum] = {}
        global_acc = density_ops.WinnerAccum()
        tables_per_file = {}
        bounds_per_file = {}
        for i, h in enumerate(self.headers):
            if plan.bounds is not None:
                if not h.bounds.intersects(plan.bounds.bounds):
                    continue
                lo64, hi64 = local_query_bounds(
                    plan.bounds.bounds, h.scale, h.offset,
                    parity_quirk=plan.parity_quirk,
                )
                bounds_per_file[i] = clamp_bounds_to_i32(lo64, hi64)
            tables_per_file[i] = {
                k: jnp.asarray(v)
                for k, v in grid.file_tables(h.scale, h.offset).items()
            }

        per_file_scope = plan.density.scope == "file"
        cap = min(8192, self.block_size)
        # resident blocks are laid out file by file, so each file is one
        # contiguous row range: ONE jitted candidate dispatch per file (XLA
        # auto-partitions the batched sort over the mesh), candidates
        # gathered on device, exact f64 resolution on host
        ranges: dict[int, tuple[int, int]] = {}
        for b in range(self.n_blocks):
            i = int(self.file_idx[b])
            if i < 0:
                continue
            lo, hi = ranges.get(i, (b, b))
            ranges[i] = (min(lo, b), b + 1)

        for file_seq, (i, (blo, bhi)) in enumerate(sorted(ranges.items())):
            if i not in tables_per_file:
                continue
            if plan.bounds is not None and i not in bounds_per_file:
                continue
            nvs = jnp.asarray(self.nvs[blo:bhi])
            xs, ys, zs = self.xs[blo:bhi], self.ys[blo:bhi], self.zs[blo:bhi]
            if plan.bounds is not None:
                lo, hi = bounds_per_file[i]
                los = jnp.tile(jnp.asarray(lo), (bhi - blo, 1))
                his = jnp.tile(jnp.asarray(hi), (bhi - blo, 1))
                masks = predicate.bbox_mask_jnp_multi(xs, ys, zs, los, his, nvs)
            elif plan.time_range is not None:
                q = np.asarray(
                    predicate.encode_f64_scalar(plan.time_range.start)
                    + predicate.encode_f64_scalar(plan.time_range.end),
                    np.int32,
                )
                qs = jnp.tile(jnp.asarray(q), (bhi - blo, 1))
                masks = predicate.time_mask_jnp_multi(
                    self.ths[blo:bhi], self.tls[blo:bhi], qs, nvs
                )
            else:
                targets = jnp.full(bhi - blo, plan.classification.classification,
                                   jnp.int32)
                masks = predicate.class_mask_jnp_multi(self.cls[blo:bhi], targets, nvs)

            while True:
                counts, idx, gx, gy, gz = density_ops.density_candidates_gather(
                    xs, ys, zs, masks, nvs, tables_per_file[i], cap=cap
                )
                counts_np = np.asarray(counts)
                m = int(counts_np.max()) if len(counts_np) else 0
                if m <= cap:
                    break
                from ..ops.compact import pow2_bucket

                cap = pow2_bucket(m, self.block_size)
            idx_np = np.asarray(idx)
            gx_np, gy_np, gz_np = np.asarray(gx), np.asarray(gy), np.asarray(gz)
            h = self.headers[i]
            for j in range(bhi - blo):
                c = int(counts_np[j])
                if c == 0:
                    continue
                local = idx_np[j, :c].astype(np.int64)
                winners = grid.make_winners_raw(
                    gx_np[j, :c], gy_np[j, :c], gz_np[j, :c],
                    h.scale, h.offset,
                    local + int(self.block_start[blo + j]), i,
                )
                if per_file_scope:
                    accs.setdefault(i, density_ops.WinnerAccum()).add(
                        winners, file_seq
                    )
                else:
                    global_acc.add(winners, file_seq)
        return (
            {i: a.result() for i, a in accs.items()},
            global_acc.result() if not per_file_scope else None,
        )

    def density_count(self, plan: QueryPlan) -> int:
        """Max-density sampled count against resident blocks."""
        states, global_state = self.density_states(plan)
        if plan.density.scope == "file":
            return sum(len(s) for s in states.values() if s is not None)
        return 0 if global_state is None else len(global_state)

    def density_collect(
        self, plan: QueryPlan, *, output_dir=None, print_stream=None,
        keep_hits: bool = False,
    ):
        """Density-sampled collection: winner attributes gathered from the
        source files. Returns (count, HitEmitter)."""
        from ..formats import open_point_cloud
        from ..sinks import HitEmitter, concat_hits, empty_hits, gather_hits

        states, global_state = self.density_states(plan)
        readers = [open_point_cloud(f) for f in self.files]
        emitter = HitEmitter(
            readers, output_dir=output_dir, print_stream=print_stream,
            keep_hits=keep_hits,
        )

        def to_hits(state, i):
            if state is None or len(state) == 0:
                return empty_hits(i)
            return gather_hits(readers[i], np.sort(state["gidx"]), i)

        try:
            if plan.density.scope == "file":
                for i in range(len(self.files)):
                    emitter.emit_hits(i, to_hits(states.get(i), i))
                    emitter.finalize_file(i)
            else:
                combined = []
                if global_state is not None and len(global_state):
                    for i in np.unique(global_state["file_idx"]):
                        sub = global_state[global_state["file_idx"] == i]
                        combined.append(to_hits(sub, int(i)))
                merged = concat_hits(combined)
                emitter.emit_hits(-1, merged)
                emitter.finalize_file(-1)
        finally:
            for r in readers:
                r.close()
        return emitter.total, emitter

    def count(self, plan: QueryPlan) -> int:
        """One resident ad-hoc count query = one device dispatch
        (density plans: one dispatch per resident block + host merge)."""
        if plan.density is not None:
            return self.density_count(plan)
        if plan.collects_points:
            raise NotImplementedError(
                "use ResidentDataset.collect() for point materialization"
            )
        if plan.time_range is not None:
            if self.ths is None:
                raise ValueError("dataset loaded without gps_time columns")
            from ..ops import predicate

            q = np.asarray(
                predicate.encode_f64_scalar(plan.time_range.start)
                + predicate.encode_f64_scalar(plan.time_range.end),
                np.int32,
            )
            if not hasattr(self, "_time_jit"):
                self._time_jit = self._time_fn()
            counts = self._time_jit(
                self.ths, self.tls, jnp.asarray(q), jnp.asarray(self.nvs)
            )
            return int(np.asarray(counts).astype(np.int64).sum())
        nvs = jnp.asarray(self.nvs)
        if plan.bounds is not None:
            if self.xs is None:
                raise ValueError("dataset loaded without position columns")
            los = np.zeros((self.n_blocks, 3), np.int32)
            his = np.full((self.n_blocks, 3), -1, np.int32)  # empty box default
            for i, h in enumerate(self.headers):
                if not h.bounds.intersects(plan.bounds.bounds):
                    continue  # header prefilter: leave the empty box
                lo64, hi64 = local_query_bounds(
                    plan.bounds.bounds, h.scale, h.offset, parity_quirk=plan.parity_quirk
                )
                lo, hi = clamp_bounds_to_i32(lo64, hi64)
                sel = self.file_idx == i
                los[sel] = lo
                his[sel] = hi
            if not hasattr(self, "_bbox_jit"):
                self._bbox_jit = self._bbox_fn()
            counts = self._bbox_jit(
                self.xs, self.ys, self.zs, jnp.asarray(los), jnp.asarray(his), nvs
            )
        else:
            if self.cls is None:
                raise ValueError("dataset loaded without classification column")
            if not hasattr(self, "_class_jit"):
                self._class_jit = self._class_fn()
            counts = self._class_jit(
                self.cls,
                jnp.asarray(plan.classification.classification, jnp.int32),
                nvs,
            )
        return int(np.asarray(counts).astype(np.int64).sum())

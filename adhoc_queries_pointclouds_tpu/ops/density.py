"""Max-density grid sampling: keep the point closest to its cell center.

Device redesign of the reference's SparseGrid hash map
(query/src/grid_sampling.rs:18-105), bit-exact to its f64 semantics.

The reference computes, per point, r = (p_world - bmin) * dims / extent in
f64, truncates (`as u64`, saturating) to a cell, bit-masks each axis into a
packed u64 key, and keeps the point with the smallest f64 squared distance
to the *unmasked* cell's center (strict <, so the first-inserted point wins
ties). The device program runs in f32/int32 (no x64 mode), so the work
splits:

  device (f32/int32, sort-based): assigns each point a cell by binary-
    refining an f32 estimate against **exact integer boundary tables** (the
    smallest int32 local coordinate belonging to each cell, computed on the
    host in f64 — so the device's interior cell assignment is provably equal
    to the reference's f64 result, not approximately). A 5-key sort
    (cz, cy, cx, d2_f32, idx) + first-of-run then selects per-cell leaders,
    and every point within a conservative error margin of its leader —
    f32's worst case — survives as a *candidate*. Points the tables cannot
    certify (beyond the grid max face, int32 extremes, giant cells) are
    flagged straight into the candidate set. The candidate set provably
    contains every possible f64 winner.

  host (f64, tiny): recomputes the reference's exact cell key and d² for
    the few candidates per block and merges them into a sparse running
    state (numpy lexsort segment-min) with the reference tie rule.

So the 12 B/point hot path runs on the device and the f64 math only ever
touches O(cells + epsilon-ties) points — exact parity at device speed.

Scope of the bit-exactness claim: it covers cell COUNTS always, and winner
IDENTITY for in-grid (non-wrapped) cells. For masked-key *aliases* — points
beyond the grid max face whose bit-masked cells wrap onto the same HashMap
key (grid_sampling.rs:66-70) — the reference compares the stored point
against the INCOMING point's unmasked cell center (grid_sampling.rs:80-101),
an insertion-order-dependent rule that is not a per-key minimum; this module
compares each candidate to its OWN cell center (a well-defined min), so the
surviving point on an aliased key may differ. The set of occupied keys, and
therefore every density count, is identical either way.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.aabb import AABB

I32_MAX = np.int32(2**31 - 1)
I32_MIN = np.int32(-(2**31))

WINNER_DTYPE = np.dtype(
    [
        ("key", "<u8"),  # reference bit-packed masked cell key
        ("d2", "<f8"),  # exact f64 squared distance to the cell center
        ("file_idx", "<i4"),
        ("gidx", "<i8"),
    ]
)

# conservative relative/absolute margins covering worst-case f32 error in
# the device d² (see _density_candidates_kernel); ~30x the analytic bound
EPS_REL = 1e-5


@dataclasses.dataclass(frozen=True)
class GridSpec3D:
    """Host-side grid geometry replicating SparseGrid::new exactly
    (grid_sampling.rs:18-47): dims = ceil(extent/cell) as u64 (f64 ceil),
    bits = ceil(log2(dims)) as u64, per-axis masks, <= 64 total bits."""

    bounds: AABB
    cell_size: float
    dims: tuple[int, int, int]
    bits: tuple[int, int, int]

    @staticmethod
    def create(bounds: AABB, cell_size: float) -> "GridSpec3D":
        ext = np.asarray(bounds.extent, np.float64)
        ncf = np.ceil(ext / float(cell_size))  # f64, may be 0 or negative
        dims = tuple(int(max(v, 0.0)) for v in ncf)  # `as u64` saturates
        bits = []
        for v in ncf:
            b = np.ceil(np.log2(v)) if v > 0 else -np.inf  # log2(0) = -inf
            bits.append(int(max(b, 0.0)) if np.isfinite(b) else 0)
        if sum(bits) > 64:
            raise ValueError(
                f"Too many cells ({dims[0]}*{dims[1]}*{dims[2]}) in SparseGrid! "
                "The number of cells exceeds the capacity of a u64 index!"
            )
        if max(dims) > (1 << 23):
            # device boundary tables are O(dims) int32 per axis; 8M cells on
            # one axis = 32 MiB/axis. The reference tolerates absurd dims
            # (the key wraps); we draw the line where tables stop being sane.
            raise ValueError(
                f"grid dims {dims} too large for device tables (max 2^23/axis)"
            )
        return GridSpec3D(bounds, float(cell_size), dims, tuple(bits))

    @property
    def masks(self) -> tuple[int, int, int]:
        return tuple((1 << b) - 1 for b in self.bits)

    # -- exact reference math (host f64) ------------------------------------

    def exact_cells(self, world: np.ndarray) -> np.ndarray:
        """(n, 3) world f64 -> (n, 3) uint64 unmasked cells, exactly
        replicating grid_sampling.rs:51-60 incl. `as u64` saturation."""
        bmin = np.asarray(self.bounds.min, np.float64)
        ext = np.asarray(self.bounds.extent, np.float64)
        dims_f = np.asarray(self.dims, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = (world - bmin) * dims_f / ext
        # Rust `as u64`: NaN -> 0, negative -> 0, >= 2^64 -> u64::MAX
        r = np.where(np.isnan(r), 0.0, np.maximum(r, 0.0))
        sat = r >= 2.0**64
        cells = np.where(sat, 0.0, r).astype(np.uint64)
        return np.where(sat, np.uint64(0xFFFFFFFFFFFFFFFF), cells)

    def exact_keys_d2(
        self, world: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(n, 3) world f64 -> (packed masked u64 keys, exact f64 d²).

        d² is measured to the *unmasked* cell's center — the reference masks
        only the HashMap key, not the center (grid_sampling.rs:66-83)."""
        cells = self.exact_cells(world)
        bmin = np.asarray(self.bounds.min, np.float64)
        center = (cells.astype(np.float64) + 0.5) * self.cell_size + bmin
        d = world - center
        # explicit x, y, z accumulation order: nalgebra's distance_squared
        # (the reference, grid_sampling.rs:84-95) folds components in order,
        # and einsum's pairwise/SIMD accumulation differs by 1 ulp on ~20%
        # of points — enough to flip a winner on an exact d² tie
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        mx, my, mz = (np.uint64(m) for m in self.masks)
        xb, yb = np.uint64(self.bits[0]), np.uint64(self.bits[0] + self.bits[1])
        key = (
            (cells[:, 0] & mx)
            | ((cells[:, 1] & my) << xb)
            | ((cells[:, 2] & mz) << yb)
        )
        return key, d2

    def make_winners(
        self, world: np.ndarray, gidx: np.ndarray, file_idx: int
    ) -> np.ndarray:
        """Candidate points -> WINNER_DTYPE rows with exact key/d² (host)."""
        key, d2 = self.exact_keys_d2(world)
        out = np.empty(len(world), dtype=WINNER_DTYPE)
        out["key"] = key
        out["d2"] = d2
        out["gidx"] = np.asarray(gidx, np.int64)
        out["file_idx"] = file_idx
        return out

    def exact_keys_d2_raw(
        self, xi: np.ndarray, yi: np.ndarray, zi: np.ndarray,
        scale, offset,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Raw int32 local coords -> (masked u64 keys, exact f64 d²).

        One fused native pass when available (aqpc_density_exact; at paper
        scale the ~20 numpy vector passes of the world-convert +
        exact_keys_d2 chain were a visible slice of density wall time on
        this 1-core host); bit-identical numpy fallback otherwise — the
        native build uses -ffp-contract=off so every f64 op rounds exactly
        like numpy's separate ops and the reference's Rust."""
        from .. import native

        xi = np.ascontiguousarray(xi, np.int32)
        yi = np.ascontiguousarray(yi, np.int32)
        zi = np.ascontiguousarray(zi, np.int32)
        scale = np.asarray(scale, np.float64)
        offset = np.asarray(offset, np.float64)
        bmin = np.asarray(self.bounds.min, np.float64)
        ext = np.asarray(self.bounds.extent, np.float64)
        res = native.density_exact(
            xi, yi, zi, scale, offset, bmin, ext,
            np.asarray(self.dims, np.float64), self.cell_size,
            np.asarray(self.masks, np.uint64),
            self.bits[0], self.bits[0] + self.bits[1],
        )
        if res is not None:
            return res
        world = (
            np.stack([xi, yi, zi], axis=1).astype(np.float64) * scale + offset
        )
        return self.exact_keys_d2(world)

    def make_winners_raw(
        self, xi, yi, zi, scale, offset, gidx: np.ndarray, file_idx: int
    ) -> np.ndarray:
        """make_winners straight from raw int32 columns (fused native exact
        pass; no (n,3) f64 world materialization)."""
        key, d2 = self.exact_keys_d2_raw(xi, yi, zi, scale, offset)
        out = np.empty(len(key), dtype=WINNER_DTYPE)
        out["key"] = key
        out["d2"] = d2
        out["gidx"] = np.asarray(gidx, np.int64)
        out["file_idx"] = file_idx
        return out

    # -- device tables -------------------------------------------------------

    def file_tables(
        self,
        scale: tuple[float, float, float],
        offset: tuple[float, float, float],
    ) -> dict[str, np.ndarray]:
        key = (
            tuple(float(v) for v in self.bounds.min),
            tuple(float(v) for v in self.bounds.max),
            self.cell_size, self.dims,
            tuple(float(v) for v in scale), tuple(float(v) for v in offset),
        )
        cached = _TABLE_CACHE.get(key)
        if cached is None:
            cached = self._file_tables_impl(scale, offset)
            if len(_TABLE_CACHE) > 64:
                _TABLE_CACHE.clear()
            _TABLE_CACHE[key] = cached
        return cached

    def _file_tables_impl(
        self,
        scale: tuple[float, float, float],
        offset: tuple[float, float, float],
    ) -> dict[str, np.ndarray]:
        """Per-(file, grid) constants for the device candidate kernel
        (cached: repeated queries on the same grid+file geometry — the
        serving pattern — skip the O(dims) rebuild).

        For each axis: an exact boundary table b[0..dims+1] (int32 local
        units; b[c] is the smallest int32 p with exact f64 cell(p) >= c, so
        cell c = {p : b[c] <= p < b[c+1]} matches the reference bit-for-bit
        on the interior), plus split cell-center tables cr (int32 round) and
        cf (f32 fraction) so the device d² avoids catastrophic cancellation:
        d_local = float(p - cr[c]) - cf[c] is exact integer arithmetic plus
        two tiny f32 terms. Also the f32 affine estimate (q0i/q0f/dpl) whose
        error is < 0.5 cells for dims <= 2^23, so a +-2 correction window
        against the boundary tables always certifies interior points.
        """
        scale = np.asarray(scale, np.float64)
        offset = np.asarray(offset, np.float64)
        if np.any(scale <= 0):
            raise ValueError(f"non-positive LAS scale {scale} unsupported")
        bmin = np.asarray(self.bounds.min, np.float64)
        bmax = np.asarray(self.bounds.max, np.float64)
        ext = bmax - bmin
        dims_f = np.asarray(self.dims, np.float64)

        tables = {}
        dims_dev = []
        for ax, name in enumerate("xyz"):
            d_ax = self.dims[ax]
            dd = max(d_ax, 1)
            dims_dev.append(dd)
            b = np.empty(dd + 2, np.int64)
            b[0] = int(I32_MIN)  # `as u64` saturates r<1 (incl. negative) to cell 0
            b[dd + 1] = int(I32_MAX)  # sentinel for the +1 gather
            if d_ax == 0 or ext[ax] <= 0:
                # degenerate axis: reference r is NaN/inf -> every point cell 0
                b[1 : dd + 1] = int(I32_MAX)
            else:
                i = np.arange(1, dd + 1, dtype=np.float64)

                def r_of(p):  # exact reference r at integer local coords p
                    w = p * scale[ax] + offset[ax]
                    return (w - bmin[ax]) * dims_f[ax] / ext[ax]

                approx = (i * ext[ax] / dims_f[ax] + bmin[ax] - offset[ax]) / scale[ax]
                p = np.ceil(approx)
                # correct the f64-approximate inverse to the true threshold
                for _ in range(8):
                    too_high = r_of(p - 1) >= i
                    if not too_high.any():
                        break
                    p = np.where(too_high, p - 1, p)
                for _ in range(8):
                    too_low = r_of(p) < i
                    if not too_low.any():
                        break
                    p = np.where(too_low, p + 1, p)
                bad = (r_of(p) < i) | (r_of(p - 1) >= i)
                if bad.any():  # extreme exponents: bisection fallback
                    lo = np.full_like(p, float(I32_MIN))
                    hi = np.full_like(p, float(I32_MAX))
                    for _ in range(34):
                        mid = np.floor((lo + hi) / 2)
                        ge = r_of(mid) >= i
                        hi = np.where(ge, mid, hi)
                        lo = np.where(ge, lo, mid)
                    p = np.where(bad, hi, p)
                b[1 : dd + 1] = np.clip(p, int(I32_MIN), int(I32_MAX)).astype(np.int64)
            tables[f"b{name}"] = b.astype(np.int32)

            # split center tables for cells 0..dd-1
            c = np.arange(dd, dtype=np.float64)
            center_w = (c + 0.5) * self.cell_size + bmin[ax]
            center_l = (center_w - offset[ax]) / scale[ax]
            cr = np.clip(np.round(center_l), int(I32_MIN) + 1, int(I32_MAX) - 1)
            tables[f"cr{name}"] = cr.astype(np.int32)
            tables[f"cf{name}"] = (center_l - cr).astype(np.float32)

        # f32 affine estimate, grid-origin-relative so the f32 error stays
        # sub-cell: est = (float(p - q0i) - q0f) * dpl
        ext_l = ext / scale
        q0 = (bmin - offset) / scale
        q0i = np.clip(np.round(q0), int(I32_MIN) + 1, int(I32_MAX) - 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            dpl = np.where(ext_l > 0, dims_f / ext_l, 0.0)
        tables["q0i"] = q0i.astype(np.int32)
        tables["q0f"] = (q0 - q0i).astype(np.float32)
        tables["dpl"] = np.nan_to_num(dpl).astype(np.float32)
        tables["scale"] = scale.astype(np.float32)
        tables["dims"] = np.asarray(dims_dev, np.int32)
        # absolute d² slack: f32 rounding of the center fraction and scale
        tables["eps_abs"] = np.float32(3.0 * (1e-6 * self.cell_size) ** 2 + 1e-30)
        return tables


def _carry_leader(first, d2):
    """For each sorted position, the d² of its run's first element."""

    def op(a, b):
        av, aset = a
        bv, bset = b
        return jnp.where(bset, bv, av), aset | bset

    vals, _ = jax.lax.associative_scan(op, (jnp.where(first, d2, 0.0), first))
    return vals


def _density_candidates_1(
    x, y, z, pred_mask, n_valid,
    bx, by, bz, crx, cfx, cry, cfy, crz, cfz,
    q0i, q0f, dpl, scale, dims, eps_abs, cap: int,
):
    """Single-block candidate selection. Returns (count, idx[cap]).

    The candidate set provably contains every point that could win its cell
    under exact f64: interior points get their exact cell from the boundary
    tables and survive if within the f32 error margin of their cell's
    leader; anything uncertifiable is flagged in wholesale.
    """
    n = x.shape[0]
    idx = jax.lax.iota(jnp.int32, n)
    valid = pred_mask & (idx < n_valid)

    def axis(p, b, cr, cf, q0i_a, q0f_a, dpl_a, dim):
        est = (jnp.float32(0) + (p - q0i_a).astype(jnp.float32) - q0f_a) * dpl_a
        c = jnp.clip(est.astype(jnp.int32), 0, dim - 1)
        # +-2 correction against the exact boundaries (b has dim+2 entries)
        for _ in range(2):
            c = jnp.where(p >= jnp.take(b, jnp.minimum(c + 1, dim)), c + 1, c)
        for _ in range(2):
            c = jnp.where(p < jnp.take(b, c), c - 1, c)
        c = jnp.clip(c, 0, dim - 1)
        certified = (p >= jnp.take(b, c)) & (p < jnp.take(b, c + 1))
        # beyond the max face (cell >= dim wraps in the reference) -> flag
        certified &= p < jnp.take(b, dim)
        # int32 extremes: boundary tables are clamped there
        certified &= (p < I32_MAX) & (p > I32_MIN)
        di = p - jnp.take(cr, c)
        certified &= jnp.abs(di) < (1 << 30)  # int32 sub overflow guard
        dloc = di.astype(jnp.float32) - jnp.take(cf, c)
        return c, certified, dloc

    cx, okx, dlx = axis(x, bx, crx, cfx, q0i[0], q0f[0], dpl[0], dims[0])
    cy, oky, dly = axis(y, by, cry, cfy, q0i[1], q0f[1], dpl[1], dims[1])
    cz, okz, dlz = axis(z, bz, crz, cfz, q0i[2], q0f[2], dpl[2], dims[2])
    certified = okx & oky & okz
    flagged = valid & ~certified

    dx = dlx * scale[0]
    dy = dly * scale[1]
    dz = dlz * scale[2]
    # XLA may contract this into FMAs on the GPU: a fused multiply-add
    # rounds once where mul + add rounds twice, so the error stays inside
    # the EPS_REL / eps_abs margin either way.
    d2 = dx * dx + dy * dy + dz * dz

    # Zero-hit blocks never reach this sort: the engine skips them on the
    # host before dispatch (engine _run_density host prefilter), which also
    # saves their H2D transfer.
    in_sort = valid & certified
    czk = jnp.where(in_sort, cz, I32_MAX)
    cz_s, cy_s, cx_s, d2_s, idx_s = jax.lax.sort(
        (czk, cy, cx, d2, idx), num_keys=4
    )
    first = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (cz_s[1:] != cz_s[:-1])
            | (cy_s[1:] != cy_s[:-1])
            | (cx_s[1:] != cx_s[:-1]),
        ]
    )
    leader_d2 = _carry_leader(first, d2_s)
    near = d2_s <= leader_d2 + EPS_REL * leader_d2 + eps_abs
    cand_sorted = (first | near) & (cz_s != I32_MAX)
    # scatter candidacy back to original point order (ascending indices out)
    cand = jnp.zeros(n, bool).at[idx_s].set(cand_sorted, mode="drop")
    cand = cand | flagged
    count = jnp.sum(cand, dtype=jnp.int32)
    (out,) = jnp.nonzero(cand, size=cap, fill_value=n)
    return count, out.astype(jnp.int32)


_TABLE_CACHE: dict = {}


@functools.partial(jax.jit, static_argnames=("cap",))
def block_density_candidates(x, y, z, pred_mask, n_valid, tables, *, cap: int):
    """Jitted single-block entry (retry path and small runs)."""
    return _density_candidates_1(
        x, y, z, pred_mask, jnp.asarray(n_valid, jnp.int32),
        tables["bx"], tables["by"], tables["bz"],
        tables["crx"], tables["cfx"], tables["cry"], tables["cfy"],
        tables["crz"], tables["cfz"],
        tables["q0i"], tables["q0f"], tables["dpl"], tables["scale"],
        tables["dims"], tables["eps_abs"], cap,
    )


def density_candidates_multi(xs, ys, zs, masks, nvs, tables, cap: int):
    """(K, B) blocks, shared per-file tables -> (counts (K,), idx (K, cap)).

    lax.map (scan) over the K blocks rather than vmap: K independent
    single-block sorts, with the body compiled ONCE (a statically unrolled
    loop is ~K x the HLO). Whether a batched vmap sort is faster on the
    GPU is not measured. Traced inside the sharded step."""

    def one(args):
        x, y, z, m, nv = args
        return _density_candidates_1(
            x, y, z, m, nv,
            tables["bx"], tables["by"], tables["bz"],
            tables["crx"], tables["cfx"], tables["cry"], tables["cfy"],
            tables["crz"], tables["cfz"],
            tables["q0i"], tables["q0f"], tables["dpl"], tables["scale"],
            tables["dims"], tables["eps_abs"], cap,
        )

    return jax.lax.map(one, (xs, ys, zs, masks, nvs))


class WinnerAccum:
    """Amortized winner-state accumulator for the engine's streaming scan.

    `merge_winners_host` lexsorts the ENTIRE running state on every call;
    called once per block (the engine's old pattern) that is O(S log S)
    per block — at paper scale (13 M winner cells over 56 blocks) the host
    spends more time re-sorting winners it already resolved than the device
    spends scanning. This accumulator batches incoming candidate rows and
    merges only when the pending batch has grown to the merged state's size
    (a logarithmic merge schedule), making the total host cost O(N log N)
    over the whole scan instead of O(B * S log S).

    Exactness: identical to folding `merge_winners_host` per block. The
    reference's tie rule is "first inserted wins" (strict < replacement,
    grid_sampling.rs:97), and the engine inserts in ascending
    (file-processing-order, gidx) — `active` iterates files in ascending
    index and blocks stream in order — so insertion order is fully encoded
    in each row's (file_seq, gidx) and the per-key minimum of
    (d2, file_seq, gidx) is insertion-schedule-invariant. `add` takes the
    file's processing sequence number explicitly so global-scope merges
    stay exact even if file_idx values were ever discovered out of order.
    """

    def __init__(self, floor: int = 1 << 19):
        # SoA state (key, d2, seq, gidx, file_idx), unique keys ascending.
        self._state: tuple[np.ndarray, ...] | None = None
        self._batches: list[np.ndarray] = []
        self._batch_seqs: list[int] = []
        self._pending = 0
        self._floor = floor

    def add(self, rows: np.ndarray, file_seq: int) -> None:
        if rows is None or len(rows) == 0:
            return
        self._batches.append(rows)
        self._batch_seqs.append(file_seq)
        self._pending += len(rows)
        state_n = 0 if self._state is None else len(self._state[0])
        if self._pending >= max(state_n, self._floor):
            self._merge()

    def _merge(self) -> None:
        from .. import native

        if not self._batches:
            return
        merged = (self._batches[0] if len(self._batches) == 1
                  else np.concatenate(self._batches))
        seq = np.concatenate([
            np.full(len(b), s, np.int32)
            for b, s in zip(self._batches, self._batch_seqs)
        ])
        self._batches = []
        self._batch_seqs = []
        self._pending = 0

        key = np.ascontiguousarray(merged["key"])
        d2 = np.ascontiguousarray(merged["d2"])
        gidx = np.ascontiguousarray(merged["gidx"])
        # single stable key sort (numpy radix for u64) replaces the old
        # 4-key lexsort; the tie rule moves into the linear native pass
        order = np.argsort(key, kind="stable").astype(np.int64, copy=False)
        widx = native.winner_dedupe(order, key, d2, seq, gidx)
        if widx is None:
            # pure-python fallback: the original lexsort semantics
            order = np.lexsort((gidx, seq, d2, key))
            key, d2, seq, gidx = key[order], d2[order], seq[order], gidx[order]
            fidx = np.ascontiguousarray(merged["file_idx"])[order]
            first = np.empty(len(key), bool)
            first[0] = True
            first[1:] = key[1:] != key[:-1]
            batch = (key[first], d2[first], seq[first], gidx[first],
                     fidx[first])
            self._state = (batch if self._state is None
                           else _merge_soa_py(self._state, batch))
            return
        batch = (key[widx], d2[widx], seq[widx], gidx[widx],
                 np.ascontiguousarray(merged["file_idx"])[widx])
        if self._state is None:
            self._state = batch
        else:
            self._state = native.winner_merge(self._state, batch)

    def result(self) -> np.ndarray:
        self._merge()
        if self._state is None:
            return np.empty(0, WINNER_DTYPE)
        key, d2, _seq, gidx, fidx = self._state
        out = np.empty(len(key), WINNER_DTYPE)
        out["key"] = key
        out["d2"] = d2
        out["gidx"] = gidx
        out["file_idx"] = fidx
        return out


def _merge_soa_py(a: tuple[np.ndarray, ...], b: tuple[np.ndarray, ...]):
    """numpy fallback for native.winner_merge: same winner rule via lexsort
    over the concatenation (both inputs are already per-key unique)."""
    key = np.concatenate([a[0], b[0]])
    d2 = np.concatenate([a[1], b[1]])
    seq = np.concatenate([a[2], b[2]])
    gidx = np.concatenate([a[3], b[3]])
    fidx = np.concatenate([a[4], b[4]])
    order = np.lexsort((gidx, seq, d2, key))
    key, d2, seq, gidx, fidx = (
        key[order], d2[order], seq[order], gidx[order], fidx[order])
    first = np.empty(len(key), bool)
    first[0] = True
    first[1:] = key[1:] != key[:-1]
    return key[first], d2[first], seq[first], gidx[first], fidx[first]


def merge_winners_host(state: np.ndarray | None, new: np.ndarray) -> np.ndarray:
    """Merge candidate rows (exact key/d²) into the sparse running state.

    Ties on d² keep the earlier-inserted point (rank: existing state first,
    then ascending gidx within the new batch), matching the reference's
    strict < replacement (grid_sampling.rs:97)."""
    if new is not None and len(new) == 0:
        new = None
    if state is None or len(state) == 0:
        merged = new
        n_old = 0
    elif new is None:
        return state
    else:
        merged = np.concatenate([state, new])
        n_old = len(state)
    if merged is None:
        return np.empty(0, WINNER_DTYPE)
    if len(merged) <= 1:
        return merged
    rank = np.zeros(len(merged), np.int8)
    rank[n_old:] = 1
    order = np.lexsort((merged["gidx"], rank, merged["d2"], merged["key"]))
    merged = merged[order]
    first = np.empty(len(merged), bool)
    first[0] = True
    first[1:] = merged["key"][1:] != merged["key"][:-1]
    return merged[first]


@functools.partial(jax.jit, static_argnames=("cap",))
def density_candidates_gather(xs, ys, zs, masks, nvs, tables, *, cap: int):
    """Batched candidate selection + device-side coordinate gather: one
    dispatch covers all blocks of a file (XLA partitions the batched sort
    over whatever mesh the inputs are sharded on). Returns
    (counts (K,), idx (K, cap), x/y/z gathered at idx (K, cap) each)."""
    counts, idx = density_candidates_multi(xs, ys, zs, masks, nvs, tables, cap)
    safe = jnp.minimum(idx, xs.shape[1] - 1)
    gx = jnp.take_along_axis(xs, safe, axis=1)
    gy = jnp.take_along_axis(ys, safe, axis=1)
    gz = jnp.take_along_axis(zs, safe, axis=1)
    return counts, idx, gx, gy, gz

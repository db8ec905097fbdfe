"""Device-op tests: predicate scans, compaction, density segment-min — each
against a NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu.ops import (
    GridSpec3D,
    bbox_count,
    block_density_candidates,
    class_count,
    compact,
    merge_winners_host,
)
from adhoc_queries_pointclouds_tpu.ops.predicate import (
    bbox_count_jnp,
    bbox_mask_jnp,
    class_count_jnp,
)
from adhoc_queries_pointclouds_tpu.utils.aabb import AABB


def _random_block(n, seed=0, pad_to=None):
    rng = np.random.default_rng(seed)
    pad_to = pad_to or n
    x = np.zeros(pad_to, np.int32)
    y = np.zeros(pad_to, np.int32)
    z = np.zeros(pad_to, np.int32)
    x[:n] = rng.integers(-(2**30), 2**30, n, dtype=np.int64).astype(np.int32)
    y[:n] = rng.integers(-(2**30), 2**30, n, dtype=np.int64).astype(np.int32)
    z[:n] = rng.integers(-(2**30), 2**30, n, dtype=np.int64).astype(np.int32)
    return x, y, z


class TestPredicates:
    def test_bbox_count_vs_oracle(self):
        n = 10_000
        x, y, z = _random_block(n, seed=1)
        lo = np.array([-(2**29), -(2**28), -(2**30)], np.int32)
        hi = np.array([2**29, 2**30, 2**27], np.int32)
        oracle = int(
            np.sum(
                (x >= lo[0]) & (x <= hi[0])
                & (y >= lo[1]) & (y <= hi[1])
                & (z >= lo[2]) & (z <= hi[2])
            )
        )
        got = int(bbox_count(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                             jnp.asarray(lo), jnp.asarray(hi), n))
        assert got == oracle

    def test_bbox_count_respects_n_valid(self):
        n = 1000
        x, y, z = _random_block(n, seed=2, pad_to=4096)
        lo = np.full(3, -(2**31), np.int32)
        hi = np.full(3, 2**31 - 1, np.int32)
        # full int32 box matches everything valid — padding must not count
        got = int(bbox_count(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                             jnp.asarray(lo), jnp.asarray(hi), n))
        assert got == n

    def test_class_count_vs_oracle(self):
        rng = np.random.default_rng(4)
        cls = rng.integers(0, 8, 50_000, dtype=np.int64).astype(np.uint8)
        got = int(class_count(jnp.asarray(cls), jnp.asarray(3), len(cls)))
        assert got == int(np.sum(cls == 3))
        # class 19 never present (paper's "noclass" experiment)
        got19 = int(class_count(jnp.asarray(cls), jnp.asarray(19), len(cls)))
        assert got19 == 0

    # Block sizes that are no multiple of any tile, down to a 1-point block.
    # "full" is the whole int32 box, which only the n_valid mask can bound.
    @pytest.mark.parametrize("n_valid,block", [(1, 4), (1003, 1004), (8191, 8196), (65_537, 65_540)])
    @pytest.mark.parametrize("kind", ["bbox", "bbox_full", "class", "class_packed"])
    def test_counts_vs_numpy_at_odd_block_sizes(self, kind, n_valid, block):
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        rng = np.random.default_rng(n_valid)
        if kind.startswith("bbox"):
            x, y, z = _random_block(n_valid, seed=n_valid, pad_to=block)
            if kind == "bbox_full":
                lo = np.full(3, -(2**31), np.int32)
                hi = np.full(3, 2**31 - 1, np.int32)
            else:
                lo = np.array([-(2**29), -(2**30), -(2**31)], np.int32)
                hi = np.array([2**30, 2**29, 0], np.int32)
            v = slice(0, n_valid)
            oracle = int(np.sum(
                (x[v] >= lo[0]) & (x[v] <= hi[0]) & (y[v] >= lo[1]) & (y[v] <= hi[1])
                & (z[v] >= lo[2]) & (z[v] <= hi[2])
            ))
            got = int(bbox_count(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                                 jnp.asarray(lo), jnp.asarray(hi), n_valid))
        else:
            # padding holds the target class: only the n_valid mask excludes it
            cls = np.full(block, 6, np.uint8)
            cls[:n_valid] = rng.integers(0, 8, n_valid).astype(np.uint8)
            oracle = int(np.sum(cls[:n_valid] == 6))
            if kind == "class":
                got = int(class_count(jnp.asarray(cls), 6, n_valid))
            else:
                got = int(P.class_count_packed_jnp(
                    jnp.asarray(P.pack_class_words(cls)), jnp.asarray(6),
                    jnp.asarray(n_valid, jnp.int32)))
        assert got == oracle


class TestCompaction:
    def test_compact_indices_sorted_and_exact(self):
        rng = np.random.default_rng(6)
        mask = rng.random(8192) < 0.1
        cnt = int(mask.sum())
        cap = compact.pow2_bucket(cnt, 8192)
        idx, got_cnt = compact.compact_indices(jnp.asarray(mask), cap=cap)
        assert int(got_cnt) == cnt
        np.testing.assert_array_equal(np.asarray(idx)[:cnt], np.nonzero(mask)[0])
        assert np.all(np.asarray(idx)[cnt:] == 8192)

    def test_pow2_bucket(self):
        assert compact.pow2_bucket(0, 1024) == 0
        assert compact.pow2_bucket(1, 1024) == 1
        assert compact.pow2_bucket(3, 1024) == 4
        assert compact.pow2_bucket(1024, 1024) == 1024
        assert compact.pow2_bucket(1025, 1024) == 1024


class TestDensity:
    """Device candidate selection + host-exact f64 resolution vs an
    independent oracle that replicates the reference SparseGrid math
    (grid_sampling.rs:18-105) including `as u64` truncation/saturation and
    the per-axis bit-mask key wrap."""

    @staticmethod
    def _oracle(world, bounds, cell_size):
        """dict of masked-key -> (d2, first-strictly-closest index)."""
        bmin = np.asarray(bounds.min, np.float64)
        ext = np.asarray(bounds.max, np.float64) - bmin
        ncf = np.ceil(ext / cell_size)
        dims = np.maximum(ncf, 0.0)
        bits = []
        for v in ncf:
            b = np.ceil(np.log2(v)) if v > 0 else -np.inf
            bits.append(int(max(b, 0.0)) if np.isfinite(b) else 0)
        masks = [(1 << b) - 1 for b in bits]
        cells = {}
        for i in range(len(world)):
            with np.errstate(divide="ignore", invalid="ignore"):
                r = (world[i] - bmin) * dims / ext
            c = []
            for v in r:
                if np.isnan(v) or v < 0:
                    c.append(0)
                elif v >= 2.0**64:
                    c.append(2**64 - 1)
                else:
                    c.append(int(v))
            key = (
                (c[0] & masks[0])
                | ((c[1] & masks[1]) << bits[0])
                | ((c[2] & masks[2]) << (bits[0] + bits[1]))
            )
            center = (np.asarray(c, np.float64) + 0.5) * cell_size + bmin
            d2 = float(np.sum((world[i] - center) ** 2))
            if key not in cells or d2 < cells[key][0]:
                cells[key] = (d2, i)
        return cells

    @staticmethod
    def _run(raw, scale, offset, bounds, cell, mask=None, base=0, state=None,
             file_idx=0, cap=None, device=None):
        from adhoc_queries_pointclouds_tpu.ops.density import GridSpec3D

        if device is not None:
            with jax.default_device(device):
                return TestDensity._run(raw, scale, offset, bounds, cell, mask,
                                        base, state, file_idx, cap)
        grid = GridSpec3D.create(bounds, cell)
        tables = {
            k: jnp.asarray(v) for k, v in grid.file_tables(scale, offset).items()
        }
        n = len(raw)
        m = jnp.ones(n, bool) if mask is None else jnp.asarray(mask)
        cap = cap or max(n, 1)
        cnt, idx = block_density_candidates(
            jnp.asarray(raw[:, 0]), jnp.asarray(raw[:, 1]), jnp.asarray(raw[:, 2]),
            m, n, tables, cap=cap,
        )
        c = int(cnt)
        assert c <= cap
        local = np.asarray(idx[:c], np.int64)
        world = raw[local].astype(np.float64) * np.asarray(scale) + np.asarray(offset)
        winners = grid.make_winners(world, local + base, file_idx)
        return merge_winners_host(state, winners), grid

    def test_single_point(self):
        bounds = AABB((-5.0, -5.0, -5.0), (5.0, 5.0, 5.0))
        raw = np.array([[-45, -46, -47]], np.int32)  # world (-4.5,-4.6,-4.7)
        state, _ = self._run(raw, (0.1, 0.1, 0.1), (0.0, 0.0, 0.0), bounds, 1.0)
        assert len(state) == 1 and state["gidx"][0] == 0

    def test_same_cell_keeps_closest_to_center(self):
        # reference test grid_sampling.rs:181-208
        bounds = AABB((-5.0, -5.0, -5.0), (5.0, 5.0, 5.0))
        raw = np.array([[-48, -46, -47], [-45, -44, -46]], np.int32)
        state, _ = self._run(raw, (0.1, 0.1, 0.1), (0.0, 0.0, 0.0), bounds, 1.0)
        assert len(state) == 1 and state["gidx"][0] == 1

    def test_different_cells_kept(self):
        bounds = AABB((-5.0, -5.0, -5.0), (5.0, 5.0, 5.0))
        raw = np.array([[-45, -46, -47], [-35, -45, -44]], np.int32)
        state, _ = self._run(raw, (0.1, 0.1, 0.1), (0.0, 0.0, 0.0), bounds, 1.0)
        assert len(state) == 2

    def test_masked_sampling(self):
        bounds = AABB((0.0, 0.0, 0.0), (10.0, 10.0, 10.0))
        raw = np.array([[1, 1, 1], [2, 2, 2], [3, 3, 3]], np.int32)
        mask = np.array([False, True, False])
        state, _ = self._run(raw, (1.0,) * 3, (0.0,) * 3, bounds, 10.0, mask=mask)
        assert len(state) == 1 and state["gidx"][0] == 1

    def test_oracle_random(self):
        rng = np.random.default_rng(7)
        n = 5_000
        scale, offset = (0.001, 0.001, 0.001), (100.0, 200.0, 0.0)
        bounds = AABB((100.0, 200.0, 0.0), (110.0, 210.0, 5.0))
        raw = rng.integers(0, 10_001, (n, 3), dtype=np.int64).astype(np.int32)
        raw[:, 2] //= 2
        state, _ = self._run(raw, scale, offset, bounds, 1.0)
        world = raw.astype(np.float64) * scale + np.asarray(offset)
        oracle = self._oracle(world, bounds, 1.0)
        assert sorted(state["gidx"].tolist()) == sorted(v[1] for v in oracle.values())

    def test_boundary_epsilon_points_exact(self):
        self._check_boundary_epsilon_points(None)

    @pytest.mark.gpu
    def test_boundary_epsilon_points_exact_on_gpu(self, gpu_device):
        self._check_boundary_epsilon_points(gpu_device)

    def _check_boundary_epsilon_points(self, device):
        """Points at the closest representable coordinates around every cell
        boundary (and exactly ON f64-exact boundaries) must land in the
        reference's f64 cell — no tolerance. This is where a pure-f32 kernel
        diverges; the exact integer boundary tables must not."""
        from adhoc_queries_pointclouds_tpu.ops.density import GridSpec3D

        scale, offset = (0.001, 0.002, 0.0005), (100.0, -50.0, 3.0)
        bounds = AABB((100.0, -50.0, 3.0), (107.3, -42.7, 9.1))
        cell = 0.7300000000000001
        grid = GridSpec3D.create(bounds, cell)
        tables = grid.file_tables(scale, offset)
        pts = []
        for ax, name in enumerate("xyz"):
            b = tables[f"b{name}"].astype(np.int64)
            interior = b[(b > -2**31) & (b < 2**31 - 1)]
            for t in interior[1:-1]:
                for delta in (-1, 0, 1):
                    v = int(np.clip(t + delta, -2**31 + 1, 2**31 - 2))
                    p = [5000, 5000, 5000]
                    p[ax] = v
                    pts.append(p)
        raw = np.asarray(pts, np.int32)
        state, _ = self._run(raw, scale, offset, bounds, cell, device=device)
        world = raw.astype(np.float64) * scale + np.asarray(offset)
        oracle = self._oracle(world, bounds, cell)
        assert sorted(state["gidx"].tolist()) == sorted(v[1] for v in oracle.values())

    def test_exact_integer_boundaries(self):
        """World coordinates that are exactly representable on cell edges:
        scale 0.001, cell 1.0 -> every 1000th raw coord sits exactly on a
        boundary in f64."""
        bounds = AABB((0.0, 0.0, 0.0), (10.0, 10.0, 10.0))
        vals = [0, 999, 1000, 1001, 4999, 5000, 5001, 9999, 10000]
        raw = np.asarray(
            [[a, b, c] for a in vals for b in vals for c in vals], np.int32
        )
        state, _ = self._run(raw, (0.001,) * 3, (0.0,) * 3, bounds, 1.0)
        world = raw.astype(np.float64) * 0.001
        oracle = self._oracle(world, bounds, 1.0)
        assert sorted(state["gidx"].tolist()) == sorted(v[1] for v in oracle.values())

    def test_max_face_pow2_wrap(self):
        """dims = 8 (power of two): a point exactly on the max face truncates
        to cell 8, whose 3-bit mask wraps to 0 — it must compete with cell-0
        points under the reference's key-wrap semantics, with d2 measured to
        the UNMASKED cell-8 center."""
        bounds = AABB((0.0, 0.0, 0.0), (8.0, 8.0, 8.0))
        raw = np.array(
            [[100, 100, 100], [8000, 100, 100]], np.int32  # w=(0.1..), (8.0,..)
        )
        state, _ = self._run(raw, (0.001,) * 3, (0.0,) * 3, bounds, 1.0)
        world = raw.astype(np.float64) * 0.001
        oracle = self._oracle(world, bounds, 1.0)
        assert sorted(state["gidx"].tolist()) == sorted(v[1] for v in oracle.values())
        # both share key 0 -> exactly one winner
        assert len(state) == 1

    def test_near_tie_d2_resolved_in_f64(self):
        self._check_near_tie_d2(None)

    @pytest.mark.gpu
    def test_near_tie_d2_resolved_in_f64_on_gpu(self, gpu_device):
        self._check_near_tie_d2(gpu_device)

    def _check_near_tie_d2(self, device):
        """Two points whose d2 differ by ~1e-12 relative: f32 cannot order
        them; the candidate margin must pass both to the exact host merge
        (also where the GPU contracts the d2 sum into FMAs)."""
        bounds = AABB((0.0, 0.0, 0.0), (10.0, 10.0, 10.0))
        scale = (1e-7, 1e-7, 1e-7)
        # cell 0 center at (0.5, 0.5, 0.5) = raw 5e6; two opposite offsets
        c = 5_000_000
        raw = np.array(
            [[c + 1000, c, c], [c - 1001, c, c], [c, c + 1000, c]], np.int32
        )
        state, _ = self._run(raw, scale, (0.0,) * 3, bounds, 1.0, device=device)
        world = raw.astype(np.float64) * np.asarray(scale)
        oracle = self._oracle(world, bounds, 1.0)
        assert sorted(state["gidx"].tolist()) == sorted(v[1] for v in oracle.values())

    def test_exact_tie_keeps_first_inserted(self):
        """Exactly equidistant points: strict < keeps the first inserted."""
        bounds = AABB((0.0, 0.0, 0.0), (10.0, 10.0, 10.0))
        c = 500  # center of cell 0 at raw 500 (scale 0.001, cell 1.0)
        raw = np.array([[c + 100, c, c], [c - 100, c, c]], np.int32)
        state, _ = self._run(raw, (0.001,) * 3, (0.0,) * 3, bounds, 1.0)
        assert len(state) == 1 and state["gidx"][0] == 0

    def test_cross_block_merge_tie_keeps_first(self):
        from adhoc_queries_pointclouds_tpu.ops.density import (
            WINNER_DTYPE, merge_winners_host,
        )

        a = np.zeros(1, dtype=WINNER_DTYPE)
        a[0] = (0, 1.0, 0, 5)
        b = np.zeros(1, dtype=WINNER_DTYPE)
        b[0] = (0, 1.0, 0, 9)  # same cell, same d2, later point
        state = merge_winners_host(merge_winners_host(None, a), b)
        assert len(state) == 1 and state["gidx"][0] == 5

    def test_cross_block_merge_better_wins(self):
        from adhoc_queries_pointclouds_tpu.ops.density import (
            WINNER_DTYPE, merge_winners_host,
        )

        a = np.zeros(1, dtype=WINNER_DTYPE)
        a[0] = (0, 1.0, 0, 5)
        b = np.zeros(1, dtype=WINNER_DTYPE)
        b[0] = (0, 0.5, 0, 9)
        state = merge_winners_host(merge_winners_host(None, a), b)
        assert state["gidx"][0] == 9

    def test_winner_accum_matches_per_block_fold(self):
        """WinnerAccum (deferred logarithmic merge) == folding
        merge_winners_host batch by batch, incl. d2 ties resolved by
        insertion order across many small batches."""
        from adhoc_queries_pointclouds_tpu.ops.density import (
            WINNER_DTYPE, WinnerAccum, merge_winners_host,
        )

        rng = np.random.default_rng(7)
        gidx = 0
        batches = []
        for _ in range(57):
            n = int(rng.integers(0, 200))
            b = np.zeros(n, dtype=WINNER_DTYPE)
            b["key"] = rng.integers(0, 40, n)  # heavy key collisions
            # quantized d2 so exact ties happen often
            b["d2"] = rng.integers(0, 5, n) * 0.25
            b["file_idx"] = 0
            b["gidx"] = np.arange(gidx, gidx + n)
            gidx += n
            batches.append(b)

        ref = None
        for b in batches:
            ref = merge_winners_host(ref, b)

        # accumulate with a tiny floor so several internal merges happen
        acc = WinnerAccum(floor=64)
        for b in batches:
            acc.add(b, 0)
        got = acc.result()

        ref = np.sort(ref, order="key")
        got = np.sort(got, order="key")
        assert np.array_equal(ref, got)

    def test_winner_accum_file_seq_orders_ties(self):
        """Across files, earlier-processed file wins d2 ties regardless of
        gidx magnitude (file_seq is the primary insertion key)."""
        from adhoc_queries_pointclouds_tpu.ops.density import (
            WINNER_DTYPE, WinnerAccum,
        )

        a = np.zeros(1, dtype=WINNER_DTYPE)
        a[0] = (3, 1.0, 0, 900)  # file seq 0, huge gidx
        b = np.zeros(1, dtype=WINNER_DTYPE)
        b[0] = (3, 1.0, 1, 2)  # file seq 1, tiny gidx, same key+d2
        acc = WinnerAccum()
        acc.add(a, 0)
        acc.add(b, 1)
        got = acc.result()
        assert len(got) == 1 and got["gidx"][0] == 900

    def test_winner_accum_native_fallback_parity(self, monkeypatch):
        """The pure-numpy WinnerAccum path (native unavailable) produces the
        identical winner set as the native dedupe+merge path."""
        from adhoc_queries_pointclouds_tpu import native
        from adhoc_queries_pointclouds_tpu.ops.density import (
            WINNER_DTYPE, WinnerAccum,
        )

        rng = np.random.default_rng(11)
        batches = []
        gidx = 0
        for _ in range(23):
            n = int(rng.integers(0, 500))
            b = np.zeros(n, dtype=WINNER_DTYPE)
            b["key"] = rng.integers(0, 120, n)
            b["d2"] = rng.integers(0, 4, n) * 0.5  # exact ties
            b["file_idx"] = rng.integers(0, 3, n)
            b["gidx"] = np.arange(gidx, gidx + n)
            gidx += n
            batches.append(b)

        acc_native = WinnerAccum(floor=128)
        for s, b in enumerate(batches):
            acc_native.add(b, s)
        got_native = acc_native.result()

        monkeypatch.setattr(native, "winner_dedupe", lambda *a, **k: None)
        monkeypatch.setattr(native, "winner_merge", lambda *a, **k: None)
        acc_py = WinnerAccum(floor=128)
        for s, b in enumerate(batches):
            acc_py.add(b, s)
        got_py = acc_py.result()
        assert np.array_equal(np.sort(got_native, order="key"),
                              np.sort(got_py, order="key"))

    def test_exact_keys_d2_raw_matches_numpy(self, monkeypatch):
        """Fused native exact pass == world-convert + numpy exact_keys_d2,
        bit for bit (keys AND f64 d2), incl. int32 extremes and points far
        beyond the grid max face (masked-key wrap)."""
        from adhoc_queries_pointclouds_tpu import native
        from adhoc_queries_pointclouds_tpu.ops.density import GridSpec3D
        from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

        rng = np.random.default_rng(13)
        grid = GridSpec3D.create(
            AABB((100.0, -50.0, 0.0), (2100.0, 1950.0, 123.7)), 3.3)
        scale, offset = (0.001, 0.01, 0.0025), (90.0, -60.0, -5.0)
        n = 50_000
        xi = rng.integers(-2**31, 2**31, n).astype(np.int32)
        yi = rng.integers(-2**25, 2**25, n).astype(np.int32)
        zi = rng.integers(-2**25, 2**25, n).astype(np.int32)
        ii = np.iinfo(np.int32)
        xi[:4] = [ii.min, ii.max, 0, -1]

        k_nat, d_nat = grid.exact_keys_d2_raw(xi, yi, zi, scale, offset)
        monkeypatch.setattr(native, "density_exact", lambda *a, **k: None)
        k_py, d_py = grid.exact_keys_d2_raw(xi, yi, zi, scale, offset)
        assert np.array_equal(k_nat, k_py)
        assert np.array_equal(d_nat.view(np.uint64), d_py.view(np.uint64))

    def test_candidate_cap_overflow_detected(self):
        """counts report the true candidate total even when idx truncates."""
        from adhoc_queries_pointclouds_tpu.ops.density import (
            GridSpec3D, block_density_candidates,
        )

        bounds = AABB((0.0, 0.0, 0.0), (10.0, 10.0, 10.0))
        grid = GridSpec3D.create(bounds, 0.001)  # every point its own cell
        tables = {
            k: jnp.asarray(v)
            for k, v in grid.file_tables((0.001,) * 3, (0.0,) * 3).items()
        }
        rng = np.random.default_rng(2)
        raw = rng.integers(0, 10000, (512, 3), dtype=np.int64).astype(np.int32)
        cnt, idx = block_density_candidates(
            jnp.asarray(raw[:, 0]), jnp.asarray(raw[:, 1]), jnp.asarray(raw[:, 2]),
            jnp.ones(512, bool), 512, tables, cap=16,
        )
        assert int(cnt) > 16  # true count, not clamped


class TestMultiBlock:
    def test_bbox_multi_jnp_vs_single(self):
        from adhoc_queries_pointclouds_tpu.ops.predicate import (
            bbox_count_jnp, bbox_count_jnp_multi,
        )
        import jax.numpy as jnp
        rng = np.random.default_rng(8)
        K, B = 3, 4096
        xs = rng.integers(-2**30, 2**30, (K, B)).astype(np.int32)
        ys = rng.integers(-2**30, 2**30, (K, B)).astype(np.int32)
        zs = rng.integers(-2**30, 2**30, (K, B)).astype(np.int32)
        los = rng.integers(-2**29, 0, (K, 3)).astype(np.int32)
        his = rng.integers(0, 2**29, (K, 3)).astype(np.int32)
        nvs = np.array([B, B - 100, 0], np.int32)
        multi = np.asarray(bbox_count_jnp_multi(
            jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(zs),
            jnp.asarray(los), jnp.asarray(his), jnp.asarray(nvs)))
        for k in range(K):
            single = int(bbox_count_jnp(
                jnp.asarray(xs[k]), jnp.asarray(ys[k]), jnp.asarray(zs[k]),
                jnp.asarray(los[k]), jnp.asarray(his[k]), jnp.asarray(nvs[k])))
            assert multi[k] == single

    def test_class_multi_vs_oracle(self):
        from adhoc_queries_pointclouds_tpu.ops.predicate import class_count_jnp_multi
        import jax.numpy as jnp
        rng = np.random.default_rng(10)
        K, B = 4, 2048
        cls = rng.integers(0, 8, (K, B)).astype(np.uint8)
        targets = np.array([1, 6, 19, 3], np.int32)
        nvs = np.array([B, B, B, 500], np.int32)
        got = np.asarray(class_count_jnp_multi(
            jnp.asarray(cls), jnp.asarray(targets), jnp.asarray(nvs)))
        for k in range(K):
            oracle = int(np.sum(cls[k, :nvs[k]] == targets[k]))
            assert got[k] == oracle


class TestGpsTimeEncoding:
    """Order-preserving f64 -> (i32, i32) split encoding for device-side
    GPS-time predicates (exact f64 semantics with int32 compares)."""

    def test_encoding_preserves_total_order(self):
        import numpy as np
        from adhoc_queries_pointclouds_tpu.ops.predicate import encode_f64_sortable

        rng = np.random.default_rng(3)
        vals = np.concatenate([
            rng.uniform(-1e9, 1e9, 3000),
            rng.uniform(-1e-300, 1e-300, 100),  # subnormal-adjacent
            np.array([0.0, -0.0, 1e-308, -1e-308, np.inf, -np.inf,
                      1.0, np.nextafter(1.0, 2.0), np.nextafter(1.0, 0.0)]),
        ])
        hi, lo = encode_f64_sortable(vals)
        # lexicographic (hi, lo) order == f64 order (stable total order on
        # non-NaN; -0.0 sorts before +0.0 which a >=/< range cannot observe
        # except at the exact boundary 0.0 where -0.0 == 0.0 numerically)
        key = hi.astype(np.int64) * (1 << 32) + (lo.astype(np.int64) & 0xFFFFFFFF)
        finite = vals[~np.isnan(vals)]
        kf = key[~np.isnan(vals)]
        order_f = np.argsort(finite, kind="stable")
        order_k = np.argsort(kf, kind="stable")
        np.testing.assert_array_equal(finite[order_f], finite[order_k])

    def test_range_mask_matches_f64_oracle(self):
        import numpy as np
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops.predicate import (
            encode_f64_scalar, encode_f64_sortable, time_mask_jnp,
        )

        rng = np.random.default_rng(4)
        t = rng.uniform(0.0, 1e6, 8192)
        # adversarial: values exactly at the range endpoints
        t[:4] = [250_000.0, np.nextafter(250_000.0, 0), 600_000.0,
                 np.nextafter(600_000.0, 0)]
        th, tl = encode_f64_sortable(t)
        q = np.asarray(
            encode_f64_scalar(250_000.0) + encode_f64_scalar(600_000.0), np.int32
        )
        got = np.asarray(
            time_mask_jnp(jnp.asarray(th), jnp.asarray(tl), jnp.asarray(q),
                          jnp.asarray(len(t), jnp.int32))
        )
        oracle = (t >= 250_000.0) & (t < 600_000.0)
        np.testing.assert_array_equal(got, oracle)


class TestPackedClassKernels:
    """4x-packed class scan: u8 column viewed as int32 words, exact-match
    byte test per word (predicate.py packed kernels)."""

    def test_all_256_class_values(self):
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        rng = np.random.default_rng(40)
        n = 4096
        cls = rng.integers(0, 256, n).astype(np.uint8)
        words = jnp.asarray(P.pack_class_words(cls))
        nv = jnp.asarray(n, jnp.int32)
        for target in range(256):
            got = int(P.class_count_packed_jnp(words, jnp.asarray(target), nv))
            assert got == int(np.sum(cls == target)), f"class {target}"

    def test_every_tail_alignment(self):
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        rng = np.random.default_rng(41)
        n = 512
        # padding bytes equal to the target: they must never be counted
        cls = np.full(n, 6, np.uint8)
        cls[: n // 2] = rng.integers(0, 8, n // 2).astype(np.uint8)
        words = jnp.asarray(P.pack_class_words(cls))
        for nv in range(0, n + 1):
            got = int(P.class_count_packed_jnp(words, jnp.asarray(6),
                                               jnp.asarray(nv, jnp.int32)))
            assert got == int(np.sum(cls[:nv] == 6)), f"n_valid {nv}"

    def test_zero_byte_trick_has_no_borrow_false_positives(self):
        # adjacent (0, 1) byte pairs are exactly where the classic
        # (v-REP)&~v&HI formula false-positives; the carry-free form must not
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        cls = np.array(
            [0, 1, 0, 1, 1, 0, 1, 0, 0, 0, 1, 1, 255, 0, 128, 1], np.uint8
        )
        words = jnp.asarray(P.pack_class_words(cls))
        nv = jnp.asarray(len(cls), jnp.int32)
        for target in (0, 1, 128, 255):
            got = int(P.class_count_packed_jnp(words, jnp.asarray(target), nv))
            assert got == int(np.sum(cls == target)), f"class {target}"

    def test_packed_multi_vs_unpacked(self):
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        rng = np.random.default_rng(42)
        K, B = 4, 8192
        cls = rng.integers(0, 256, (K, B)).astype(np.uint8)
        targets = np.array([0, 6, 255, 77], np.int32)
        nvs = np.array([B, B - 1, B - 3, 1], np.int32)
        ref = np.asarray(P.class_count_jnp_multi(
            jnp.asarray(cls), jnp.asarray(targets), jnp.asarray(nvs)))
        got = np.asarray(P.class_count_packed_jnp_multi(
            jnp.asarray(P.pack_class_words(cls)), jnp.asarray(targets),
            jnp.asarray(nvs)))
        np.testing.assert_array_equal(got, ref)

    def test_sharded_class_count_packs(self, monkeypatch):
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P
        from adhoc_queries_pointclouds_tpu.parallel import mesh as M

        rng = np.random.default_rng(44)
        mesh = M.make_mesh()
        d = mesh.devices.size
        B = 4096
        cls = rng.integers(0, 256, (d, B)).astype(np.uint8)
        targets = np.full(d, 6, np.int32)
        nvs = np.asarray([B - k for k in range(d)], np.int32)
        got = int(M.sharded_class_count(mesh, cls, targets, nvs))
        oracle = sum(int(np.sum(cls[k, : nvs[k]] == 6)) for k in range(d))
        assert got == oracle


class TestPackedTransport:
    """Bit-planar packed coordinate transport (predicate.pack_bits_into /
    unpack_bits_jnp / bbox_count_packed_jnp_multi)."""

    def _roundtrip(self, col, block_size=None):
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        n = col.shape[0]
        B = block_size or n
        mn, mx = int(col.min()), int(col.max())
        k = P.bits_width(mx - mn)
        base = mn
        if k >= 32:
            k, base = 32, 0
        row = np.zeros(P.packed_row_width(k, B), np.uint8)
        P.pack_bits_into(row, col, k, base, B)
        back = np.asarray(P.unpack_bits_jnp(jnp.asarray(row[None, :]), k, B))[0, :n]
        return back.astype(np.int64) + base if k < 32 else back, k

    def test_roundtrip_every_width(self):
        rng = np.random.default_rng(50)
        for k_target in range(0, 33):
            lo = -(1 << max(k_target - 1, 0))
            hi = lo + (1 << k_target) - 1
            if k_target == 32:
                lo, hi = -(2**31), 2**31 - 1
            col = rng.integers(lo, int(hi) + 1, 512, dtype=np.int64).astype(np.int32)
            col[0], col[1] = lo, hi  # force the full range
            back, k = self._roundtrip(col)
            assert k == k_target or (k_target == 0 and k == 0), (k_target, k)
            np.testing.assert_array_equal(back, col.astype(np.int64))

    def test_roundtrip_ragged_tail(self):
        rng = np.random.default_rng(51)
        col = rng.integers(0, 1 << 20, 1000).astype(np.int32)
        back, k = self._roundtrip(col, block_size=1024)
        np.testing.assert_array_equal(back[:1000], col.astype(np.int64))

    def test_full_range_int32_exact(self):
        rng = np.random.default_rng(52)
        col = rng.integers(-(2**31), 2**31, 4096, dtype=np.int64).astype(np.int32)
        col[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
        back, k = self._roundtrip(col)
        assert k == 32
        np.testing.assert_array_equal(back, col)

    def test_packed_count_matches_unpacked(self):
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        rng = np.random.default_rng(53)
        K, B = 4, 4096
        i32 = np.iinfo(np.int32)
        # one narrow block, one medium, one odd-bit-width, one full-range:
        # all stacked into one step at the max width
        ranges = [(0, 250), (-30_000, 30_000), (0, (1 << 21) - 5), (i32.min, i32.max)]
        cols = {a: np.empty((K, B), np.int32) for a in "xyz"}
        bases = np.zeros((K, 3), np.int64)
        widths = np.zeros((K, 3), np.int64)
        for k, (lo, hi) in enumerate(ranges):
            for a_i, a in enumerate("xyz"):
                c = rng.integers(lo, int(hi) + 1, B, dtype=np.int64).astype(np.int32)
                cols[a][k] = c
                mn = int(c.min())
                kb = P.bits_width(int(c.max()) - mn)
                if kb >= 32:
                    kb, mn = 32, 0
                widths[k, a_i] = kb
                bases[k, a_i] = mn
        wmax = widths.max(axis=0).astype(int)
        stacked = {}
        for a_i, a in enumerate("xyz"):
            kstep = int(wmax[a_i])
            out = np.zeros((K, P.packed_row_width(kstep, B)), np.uint8)
            for k in range(K):
                P.pack_bits_into(out[k], cols[a][k], kstep,
                                 int(bases[k, a_i]), B)
            stacked[a] = out
        los = np.tile(np.array([100, -5000, 0], np.int32), (K, 1))
        his = np.tile(np.array([1 << 20, 5000, i32.max], np.int32), (K, 1))
        nvs = np.array([B, B - 1, B // 2, B], np.int32)
        ref = np.asarray(P.bbox_count_jnp_multi(
            jnp.asarray(cols["x"]), jnp.asarray(cols["y"]), jnp.asarray(cols["z"]),
            jnp.asarray(los), jnp.asarray(his), jnp.asarray(nvs)))
        plos = np.clip(los.astype(np.int64) - bases, i32.min, i32.max).astype(np.int32)
        phis = np.clip(his.astype(np.int64) - bases, i32.min, i32.max).astype(np.int32)
        got = np.asarray(P.bbox_count_packed_jnp_multi(
            jnp.asarray(stacked["x"]), jnp.asarray(stacked["y"]),
            jnp.asarray(stacked["z"]), jnp.asarray(plos), jnp.asarray(phis),
            jnp.asarray(nvs), tuple(int(w) for w in wmax), B))
        np.testing.assert_array_equal(got, ref)

    def test_engine_packed_vs_unpacked_counts(self, tmp_path, monkeypatch):
        from adhoc_queries_pointclouds_tpu.engine import run_query
        from adhoc_queries_pointclouds_tpu.formats import synth
        from adhoc_queries_pointclouds_tpu.models.query import BoundsQuery, QueryPlan
        from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

        synth.write_dataset(tmp_path, n_files=2, points_per_file=30_000,
                            seed=53, formats=("last",))
        box = AABB((100200.0, 200300.0, 10.0), (101500.0, 200800.0, 60.0))
        plan = QueryPlan(bounds=BoundsQuery(box))
        monkeypatch.setenv("AQPC_PACK", "0")
        unpacked = run_query(tmp_path / "last", plan, block_size=1 << 14).match_count
        monkeypatch.setenv("AQPC_PACK", "1")
        packed = run_query(tmp_path / "last", plan, block_size=1 << 14).match_count
        assert packed == unpacked > 0

    def test_native_packer_matches_numpy(self):
        from adhoc_queries_pointclouds_tpu import native
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        if not native.available():
            import pytest
            pytest.skip("native library unavailable")
        rng = np.random.default_rng(54)
        B = 1024
        for k, lo, hi in [(0, 5, 5), (7, 0, 100), (8, 0, 255), (13, 0, 8000),
                          (20, -500_000, 500_000), (31, -(2**30), 2**30 - 7),
                          (32, -(2**31), 2**31 - 1)]:
            col = rng.integers(lo, int(hi) + 1, 1000, dtype=np.int64).astype(np.int32)
            base = 0 if k == 32 else int(col.min())
            kk = P.bits_width(int(col.max()) - int(col.min())) if k < 32 else 32
            row_native = np.zeros(P.packed_row_width(kk, B), np.uint8)
            assert native.pack_bits(col, base, kk, row_native, B)
            row_numpy = np.zeros_like(row_native)
            r = P.residual_u32(col, kk, base)
            nbytes, nbits = kk // 8, kk % 8
            for p in range(nbytes):
                row_numpy[p * B : p * B + 1000] = (r >> np.uint32(8 * p)).astype(np.uint8)
            for q in range(nbits):
                off = nbytes * B + q * (B // 8)
                row_numpy[off : off + 125] = np.packbits(
                    ((r >> np.uint32(8 * nbytes + q)) & np.uint32(1)).astype(np.uint8),
                    bitorder="little")
            np.testing.assert_array_equal(row_native, row_numpy, err_msg=f"k={kk}")


class TestPackedTransportReviewFindings:
    """Regression tests for two round-3 code-review findings in the packed
    transport: (a) the numpy-fallback packer rejected k=32 with base != 0 —
    a narrow block stacked into a 32-bit-wide step; (b) exact per-block
    widths let a k=31 residual collide with the saturating clip bound and
    count a point OUTSIDE the box (engine now nibble-rounds widths, capping
    sub-32 widths at 28 bits)."""

    def test_numpy_fallback_packs_narrow_block_at_k32(self, monkeypatch):
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        # force the numpy fallback path
        monkeypatch.setattr("adhoc_queries_pointclouds_tpu.native.pack_bits",
                            lambda *a, **kw: False)
        rng = np.random.default_rng(60)
        base = 123_456
        col = (rng.integers(0, 1 << 20, 512) + base).astype(np.int32)
        B = 512
        row = np.zeros(P.packed_row_width(32, B), np.uint8)
        P.pack_bits_into(row, col, 32, base, B)  # raised AssertionError before
        back = np.asarray(P.unpack_bits_jnp(jnp.asarray(row[None, :]), 32, B))[0]
        np.testing.assert_array_equal(back.astype(np.int64),
                                      col.astype(np.int64) - base)

    def test_saturating_clip_cannot_false_match(self):
        """The raw predicate-level repro of finding (b): a k=31 block whose
        max residual equals the saturated lo bound. The engine's width rule
        (nibble-round, 29-31 -> 32 with base 0) makes this state unreachable
        from run_query; this documents WHY the clip is exact there."""
        import jax.numpy as jnp
        from adhoc_queries_pointclouds_tpu.ops import predicate as P

        B = 512
        base = -(2**30)
        col = np.full(B, 2**30 - 1, np.int32)  # block range needs 31 bits
        # engine width rule: bits_width(2^31-1)=31 -> nibble-round -> 32,
        # base forced to 0; lo - base passes through UNclipped and no point
        # can match a box strictly above the block max
        k = (P.bits_width(int(col.max()) - base) + 3) // 4 * 4
        if k >= 32:
            k, base = 32, 0
        assert k == 32 and base == 0
        row = np.zeros(P.packed_row_width(k, B), np.uint8)
        P.pack_bits_into(row, col, k, base, B)
        lo = np.full((1, 3), 2**30, np.int64) - base  # just above block max
        hi = np.full((1, 3), 2**31 - 1, np.int64) - base
        i32 = np.iinfo(np.int32)
        lo32 = np.clip(lo, i32.min, i32.max).astype(np.int32)
        hi32 = np.clip(hi, i32.min, i32.max).astype(np.int32)
        xp = jnp.asarray(row[None, :])
        count = int(np.asarray(P.bbox_count_packed_jnp_multi(
            xp, xp, xp, lo32, hi32, np.full(1, B, np.int32), (k, k, k), B))[0])
        assert count == 0  # with exact k=31 widths this was 512

"""End-to-end engine tests: count/collect/density parity with a NumPy oracle
across formats, multi-file datasets, and the virtual 8-device CPU mesh.
Count invariance under shard count is the distributed-correctness test the
reference never had (SURVEY §4 rebuild implication)."""

from pathlib import Path

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu.engine import discover_files, run_query
from adhoc_queries_pointclouds_tpu.formats import LasFile, open_point_cloud, synth
from adhoc_queries_pointclouds_tpu.models.query import (
    BoundsQuery,
    ClassQuery,
    DensityConfig,
    QueryPlan,
)
from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

BLOCK = 1 << 14  # small blocks so multi-block paths are exercised on CPU

QUERY_BOX = AABB((100200.0, 200300.0, 10.0), (100700.0, 200800.0, 60.0))


def oracle_bbox_count(paths, bounds):
    total = 0
    for p in paths:
        r = open_point_cloud(p)
        w = r.positions_world()
        total += int(np.sum(bounds.contains_points(w)))
        r.close()
    return total


def oracle_class_count(paths, cls):
    total = 0
    for p in paths:
        r = open_point_cloud(p)
        total += int(np.sum(r.column("classification") == cls))
        r.close()
    return total


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    files = synth.write_dataset(
        root, n_files=3, points_per_file=40_000, seed=11,
        formats=("las", "last", "lazer"),
    )
    return root, files


class TestCount:
    @pytest.mark.parametrize("fmt", ["las", "last", "lazer"])
    def test_bbox_count_parity(self, dataset, fmt):
        root, files = dataset
        oracle = oracle_bbox_count(files[fmt], QUERY_BOX)
        assert oracle > 0, "query box should hit some points"
        res = run_query(
            root / fmt,
            QueryPlan(bounds=BoundsQuery(QUERY_BOX)),
            block_size=BLOCK,
        )
        assert res.match_count == oracle

    @pytest.mark.parametrize("fmt", ["las", "last", "lazer"])
    def test_class_count_parity(self, dataset, fmt):
        root, files = dataset
        oracle = oracle_class_count(files[fmt], 6)
        res = run_query(
            root / fmt,
            QueryPlan(classification=ClassQuery(6)),
            block_size=BLOCK,
        )
        assert res.match_count == oracle

    def test_class_absent_is_zero(self, dataset):
        root, _ = dataset
        res = run_query(
            root / "las", QueryPlan(classification=ClassQuery(19)), block_size=BLOCK
        )
        assert res.match_count == 0  # paper's "noclass" experiment

    def test_count_invariant_under_device_count(self, dataset):
        root, files = dataset
        oracle = oracle_bbox_count(files["last"], QUERY_BOX)
        for nd in (1, 2, 8):
            res = run_query(
                root / "last",
                QueryPlan(bounds=BoundsQuery(QUERY_BOX)),
                block_size=BLOCK,
                n_devices=nd,
            )
            assert res.match_count == oracle, f"count changed with {nd} devices"

    def test_single_file_input(self, dataset):
        root, files = dataset
        one = files["las"][0]
        oracle = oracle_bbox_count([one], QUERY_BOX)
        res = run_query(one, QueryPlan(bounds=BoundsQuery(QUERY_BOX)), block_size=BLOCK)
        assert res.match_count == oracle

    def test_no_hits_disjoint_box(self, dataset):
        root, _ = dataset
        box = AABB((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
        res = run_query(root / "las", QueryPlan(bounds=BoundsQuery(box)), block_size=BLOCK)
        assert res.match_count == 0


class TestCollect:
    @pytest.mark.parametrize("fmt", ["las", "last", "lazer"])
    def test_collect_writes_las_with_exact_hits(self, dataset, tmp_path, fmt):
        root, files = dataset
        out = tmp_path / f"out_{fmt}"
        out.mkdir()
        res = run_query(
            root / fmt,
            QueryPlan(bounds=BoundsQuery(QUERY_BOX), output_dir=out),
            block_size=BLOCK,
            keep_hits=True,
        )
        oracle = oracle_bbox_count(files[fmt], QUERY_BOX)
        assert res.match_count == oracle
        # read back all written files, verify every point is inside the box
        total_written = 0
        for f in res.output_files:
            back = LasFile(f)
            w = back.positions_world()
            assert np.all(QUERY_BOX.contains_points(w))
            total_written += back.point_count
            back.close()
        assert total_written == oracle

    def test_collect_attributes_match_source(self, dataset, tmp_path):
        root, files = dataset
        res = run_query(
            root / "last",
            QueryPlan(bounds=BoundsQuery(QUERY_BOX), output_dir=tmp_path),
            block_size=BLOCK,
            keep_hits=True,
        )
        # oracle: recompute hit rows for file 0 and compare attrs
        r = open_point_cloud(files["last"][0])
        w = r.positions_world()
        mask = QUERY_BOX.contains_points(w)
        idx = np.nonzero(mask)[0]
        hits0 = res.hits[0]
        np.testing.assert_allclose(hits0.position_world, w[idx])
        np.testing.assert_array_equal(
            hits0.classification, r.column("classification")[idx]
        )
        np.testing.assert_array_equal(hits0.color, r.column("color")[idx])
        np.testing.assert_array_equal(hits0.intensity, r.column("intensity")[idx])
        r.close()


class TestCollectMesh:
    """Mesh-parallel streaming collect: invariance + bounded-memory paths."""

    def test_collect_count_invariant_under_device_count(self, dataset, tmp_path):
        root, files = dataset
        oracle = oracle_bbox_count(files["last"], QUERY_BOX)
        for nd in (1, 2, 8):
            out = tmp_path / f"nd{nd}"
            out.mkdir()
            res = run_query(
                root / "last",
                QueryPlan(bounds=BoundsQuery(QUERY_BOX), output_dir=out),
                block_size=BLOCK,
                n_devices=nd,
            )
            assert res.match_count == oracle, f"collect changed with {nd} devices"
            written = 0
            for f in res.output_files:
                back = LasFile(f)
                written += back.point_count
                back.close()
            assert written == oracle

    def test_collect_exact_with_inflight_pipeline(self, dataset, tmp_path, monkeypatch):
        """AQPC_INFLIGHT>1 (H2D/scan overlap) must not change results."""
        import adhoc_queries_pointclouds_tpu.engine as eng

        root, files = dataset
        oracle = oracle_bbox_count(files["last"], QUERY_BOX)
        monkeypatch.setattr(eng, "MAX_INFLIGHT_STEPS", 3)
        res = run_query(
            root / "last",
            QueryPlan(bounds=BoundsQuery(QUERY_BOX), output_dir=tmp_path),
            block_size=BLOCK,
            keep_hits=True,
        )
        assert res.match_count == oracle
        res2 = run_query(
            root / "last", QueryPlan(bounds=BoundsQuery(QUERY_BOX)), block_size=BLOCK
        )
        assert res2.match_count == oracle

    def test_collect_full_match_streams_with_spool_spill(
        self, dataset, tmp_path, monkeypatch
    ):
        """A query matching ~100% of points must not buffer hits in RAM:
        force the spool to spill to disk almost immediately and verify the
        written LAS is still byte-exact complete."""
        monkeypatch.setenv("AQPC_SPOOL_MB", "0.25")
        root, files = dataset
        huge = AABB((-1e9,) * 3, (1e9,) * 3)
        res = run_query(
            root / "last",
            QueryPlan(bounds=BoundsQuery(huge), output_dir=tmp_path),
            block_size=BLOCK,
            use_index=False,
        )
        total_pts = sum(
            open_point_cloud(p).point_count for p in files["last"]
        )
        assert res.match_count == total_pts
        written = 0
        for f in res.output_files:
            back = LasFile(f)
            written += back.point_count
            back.close()
        assert written == total_pts

    def test_print_points_streams_to_given_stream(self, dataset):
        import io

        root, files = dataset
        oracle = oracle_bbox_count(files["last"], QUERY_BOX)
        buf = io.StringIO()
        res = run_query(
            root / "last",
            QueryPlan(bounds=BoundsQuery(QUERY_BOX), print_points=True),
            block_size=BLOCK,
            print_stream=buf,
        )
        lines = [l for l in buf.getvalue().splitlines() if l.startswith("Found point:")]
        assert len(lines) == oracle == res.match_count
        # spot-check the first point's formatting fields
        assert "class=" in lines[0] and "rgb=(" in lines[0] and "intensity=" in lines[0]

    def test_collect_overflow_retry_path(self, dataset, tmp_path, monkeypatch):
        """Tiny initial cap forces the overflow->pow2-retry path."""
        monkeypatch.setenv("AQPC_COLLECT_CAP", "4")
        root, files = dataset
        oracle = oracle_bbox_count(files["last"], QUERY_BOX)
        res = run_query(
            root / "last",
            QueryPlan(bounds=BoundsQuery(QUERY_BOX), output_dir=tmp_path),
            block_size=BLOCK,
            keep_hits=True,
        )
        assert res.match_count == oracle


class TestDensity:
    def _oracle_density(self, paths, bounds, cell, scope="global"):
        """Dict-based SparseGrid oracle: full reference semantics
        (grid_sampling.rs:18-105) — f64 r, `as u64` trunc/saturate, per-axis
        ceil(log2) bit masks wrapping the packed key."""
        bmin = np.asarray(bounds.min, np.float64)
        ext = np.asarray(bounds.max, np.float64) - bmin
        ncf = np.ceil(ext / cell)
        dims = np.maximum(ncf, 0.0)
        bits = []
        for v in ncf:
            b = np.ceil(np.log2(v)) if v > 0 else -np.inf
            bits.append(int(max(b, 0.0)) if np.isfinite(b) else 0)
        masks = [(1 << b) - 1 for b in bits]

        def insert(cells, w, tag):
            r = (w - bmin) * dims / ext
            c = [0 if (np.isnan(v) or v < 0) else int(min(v, 2.0**64 - 1)) for v in r]
            key = (
                (c[0] & masks[0])
                | ((c[1] & masks[1]) << bits[0])
                | ((c[2] & masks[2]) << (bits[0] + bits[1]))
            )
            center = (np.asarray(c, np.float64) + 0.5) * cell + bmin
            d2 = float(np.sum((w - center) ** 2))
            if key not in cells or d2 < cells[key][0]:
                cells[key] = (d2, tag)

        states = []
        cells = {}
        for p in paths:
            if scope == "file":
                cells = {}
            r = open_point_cloud(p)
            w = r.positions_world()
            m = bounds.contains_points(w)
            for i in np.nonzero(m)[0]:
                insert(cells, w[i], (str(p), int(i)))
            r.close()
            if scope == "file":
                states.append(dict(cells))
        if scope == "file":
            return sum(len(s) for s in states)
        return len(cells)

    @pytest.mark.parametrize("scope", ["global", "file"])
    def test_density_count_vs_oracle(self, dataset, scope):
        root, files = dataset
        cell = 50.0
        oracle = self._oracle_density(files["last"], QUERY_BOX, cell, scope)
        res = run_query(
            root / "last",
            QueryPlan(
                bounds=BoundsQuery(QUERY_BOX),
                density=DensityConfig(cell, scope),
            ),
            block_size=BLOCK,
            keep_hits=True,
        )
        assert res.match_count == oracle

    def test_density_points_inside_box_and_sparse(self, dataset, tmp_path):
        root, files = dataset
        cell = 100.0
        res = run_query(
            root / "last",
            QueryPlan(
                bounds=BoundsQuery(QUERY_BOX),
                density=DensityConfig(cell, "global"),
                output_dir=tmp_path,
            ),
            block_size=BLOCK,
            keep_hits=True,
        )
        assert res.match_count > 0
        pts = np.concatenate([h.position_world for h in res.hits if h.count])
        assert np.all(QUERY_BOX.contains_points(pts))
        # at most one point per cell
        bmin = np.asarray(QUERY_BOX.min)
        dims = np.maximum(np.ceil(np.asarray(QUERY_BOX.extent) / cell), 1)
        keys = np.floor((pts - bmin) * dims / np.asarray(QUERY_BOX.extent)).astype(int)
        assert len(np.unique(keys, axis=0)) == len(keys)

    def test_density_sparse_gather_path_exact(self, dataset):
        """A tiny box whose hits are scattered across many engine blocks
        routes them through the sparse gather-pack path (one shared device
        sort instead of a full 2M-row sort per touched block) — winners
        identical to the dense path, per-file AND global scope."""
        import adhoc_queries_pointclouds_tpu.engine as eng

        root, files = dataset
        # small box: few hits per engine block -> sparse threshold applies
        small = AABB(
            (100200.0, 200300.0, 10.0), (100600.0, 200700.0, 60.0)
        )
        for scope in ("file", "global"):
            plan = QueryPlan(
                bounds=BoundsQuery(small), density=DensityConfig(7.0, scope)
            )
            state_sparse: dict = {}
            res = run_query(root / "last", plan, block_size=BLOCK,
                            density_state_out=state_sparse)
            assert res.timer.counts.get("density_sparse_blocks", 0) > 0
            # force every block down the dense path by zeroing the
            # threshold (sparse_max = block_size // 8 -> monkeypatch via a
            # huge block count is invasive; instead compare against the
            # host oracle)
            oracle = self._oracle_density(files["last"], small, 7.0, scope)
            assert res.match_count == oracle

    def test_density_without_bounds_uses_total_bounds(self, dataset):
        root, files = dataset
        res = run_query(
            root / "last",
            QueryPlan(
                classification=ClassQuery(6),
                density=DensityConfig(200.0, "global"),
            ),
            block_size=BLOCK,
            keep_hits=True,
        )
        assert res.match_count > 0
        pts = np.concatenate([h.position_world for h in res.hits if h.count])
        cls = np.concatenate([h.classification for h in res.hits if h.count])
        assert np.all(cls == 6)


class TestDiscovery:
    def test_mixed_extensions_filtered(self, dataset, tmp_path):
        root, files = dataset
        (root / "las" / "notes.txt").write_text("ignore me")
        found = discover_files(root / "las")
        assert all(f.suffix == ".las" for f in found)
        assert len(found) == 3

    def test_missing_path_raises(self):
        with pytest.raises(FileNotFoundError):
            discover_files("/nonexistent/path")

    def test_plan_validation(self):
        with pytest.raises(ValueError):
            QueryPlan()  # neither bounds nor class
        with pytest.raises(ValueError):
            QueryPlan(
                bounds=BoundsQuery(QUERY_BOX), classification=ClassQuery(1)
            )  # both


class TestExtendedFormats:
    """Engine end-to-end on extended point formats (6-10) and format 1."""

    @pytest.mark.parametrize("fmt,exts", [(1, ("las", "last", "lazer", "laz")),
                                          (7, ("las", "last", "lazer", "laz"))])
    def test_bbox_and_class_parity(self, tmp_path, fmt, exts):
        exts = synth.formats_available(*exts)
        files = synth.write_dataset(
            tmp_path, n_files=2, points_per_file=15_000, seed=50 + fmt,
            formats=exts, point_format=fmt,
        )
        box = AABB((100200.0, 200300.0, 10.0), (100900.0, 200900.0, 70.0))
        bbox_oracle = oracle_bbox_count(files[exts[0]], box)
        class_oracle = oracle_class_count(files[exts[0]], 6)
        assert bbox_oracle > 0 and class_oracle > 0
        for ext in exts:
            res = run_query(tmp_path / ext, QueryPlan(bounds=BoundsQuery(box)),
                            block_size=BLOCK)
            assert res.match_count == bbox_oracle, f"bbox {ext} fmt{fmt}"
            res = run_query(tmp_path / ext, QueryPlan(classification=ClassQuery(6)),
                            block_size=BLOCK)
            assert res.match_count == class_oracle, f"class {ext} fmt{fmt}"


class TestEverythingAtOnce:
    """Combined stressor: overlapped device steps (inflight 3), forced
    pow2 overflow retries (cap 8), spool disk spill, streamed printing, and
    LAS write-back all at once — every collect-path feature interacting."""

    def test_collect_stress_all_features(self, dataset, tmp_path, monkeypatch):
        import io

        import adhoc_queries_pointclouds_tpu.engine as eng

        monkeypatch.setenv("AQPC_COLLECT_CAP", "8")
        monkeypatch.setenv("AQPC_SPOOL_MB", "0.25")
        monkeypatch.setattr(eng, "MAX_INFLIGHT_STEPS", 3)
        root, files = dataset
        oracle = oracle_bbox_count(files["last"], QUERY_BOX)
        buf = io.StringIO()
        res = run_query(
            root / "last",
            QueryPlan(bounds=BoundsQuery(QUERY_BOX), output_dir=tmp_path,
                      print_points=True),
            block_size=BLOCK,
            print_stream=buf,
            use_index=False,
        )
        assert res.match_count == oracle
        printed = sum(1 for l in buf.getvalue().splitlines()
                      if l.startswith("Found point:"))
        assert printed == oracle
        written = 0
        for f in res.output_files:
            back = LasFile(f)
            assert np.all(QUERY_BOX.contains_points(back.positions_world()))
            written += back.point_count
            back.close()
        assert written == oracle


class TestHostMemoryBounded:
    """Regression guard for the round-3 host-memory work (engine._gc_tick +
    _init_malloc): anonymous RSS must not grow with scanned bytes. A broken
    gc tick leaks ~10 B per scanned point (jax.Array cycles + glibc arena
    growth), which at this test's 12.6M scanned points would add ~120 MiB;
    the bound below allows ample jit/runtime noise but fails on a real
    per-point leak."""

    def test_anon_rss_flat_across_repeat_scans(self, dataset):
        def anon_mib():
            for line in open("/proc/self/status"):
                if line.startswith("RssAnon:"):
                    return int(line.split()[1]) / 1024
            pytest.skip("RssAnon unavailable on this kernel")

        root, files = dataset
        plan = QueryPlan(bounds=BoundsQuery(QUERY_BOX))
        oracle = oracle_bbox_count(files["last"], QUERY_BOX)
        # warm: jit compiles + allocator high-water
        assert run_query(root / "last", plan, block_size=BLOCK,
                         use_index=False).match_count == oracle
        base = anon_mib()
        for _ in range(6):
            assert run_query(root / "last", plan, block_size=BLOCK,
                             use_index=False).match_count == oracle
        grown = anon_mib() - base
        assert grown < 100, f"anonymous RSS grew {grown:.0f} MiB over 6 scans"

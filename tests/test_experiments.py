"""Experiment-harness tests: one real subprocess cell (warm-cache, filtered
to keep it fast), the synthesize layout, and error-tolerance (--keep-going)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu import experiments
from adhoc_queries_pointclouds_tpu.engine import run_query
from adhoc_queries_pointclouds_tpu.formats import synth
from adhoc_queries_pointclouds_tpu.models.query import BoundsQuery, QueryPlan


def test_stats_row_format():
    row = experiments._stats_row("x_y_z", [1.0, 2.0, 3.0], 42)
    name, mean, median, stddev, count, nruns = row.split(";")
    assert name == "x_y_z"
    assert float(mean) == 2.0
    assert float(median) == 2.0
    assert float(stddev) == 1.0
    assert int(count) == 42
    assert int(nruns) == 3
    # count column stays parseable when the CLI output had no count line
    assert experiments._stats_row("a", [1.0], None).split(";")[4] == ""
    assert experiments._stats_row("a", [1.0, 9.0], None).endswith(";2")


def test_published_constants_present():
    # the paper's hard-coded boxes (run_query_experiments.rs:130-140)
    assert experiments.AABBS["ca13"]["s"].min == (665000.0, 3910000.0, 0.0)
    assert experiments.AABBS["ca13"]["xl"].max == (736910.93, 3977026.735, 47285.025)
    assert experiments.DENSITIES == {"navvis3": 0.1, "doc": 25.0, "ca13": 100.0}
    assert experiments.CLASS_EXPERIMENTS == [("building", 6), ("noclass", 19)]


def test_synthesize_layout(tmp_path):
    experiments.synthesize_dataset(tmp_path, "navvis3", n_files=2, points_per_file=2_000)
    for fmt in experiments.FORMATS:
        files = list((tmp_path / "navvis3" / fmt).glob(f"*.{fmt}"))
        assert len(files) == 2, fmt
    # points actually land inside the published xl box for the dataset
    from adhoc_queries_pointclouds_tpu.formats import open_point_cloud

    r = open_point_cloud(next((tmp_path / "navvis3" / "las").glob("*.las")))
    w = r.positions_world()
    xl = experiments.AABBS["navvis3"]["xl"]
    assert np.all(xl.contains_points(w))
    r.close()


def test_one_subprocess_cell(tmp_path):
    """Run one real harness cell end-to-end (warm cache, las only, size s)."""
    experiments.synthesize_dataset(tmp_path, "navvis3", n_files=1, points_per_file=3_000)
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-m", "adhoc_queries_pointclouds_tpu.cli", "experiments",
         "-i", str(tmp_path), "-e", "1", "--runs", "1", "--warm",
         "--formats", "las", "--sizes", "s", "--skip-density"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    rows = [l for l in proc.stdout.splitlines() if l.startswith("navvis3_s_full_las;")]
    assert len(rows) == 1
    assert float(rows[0].split(";")[1]) > 0


def test_keep_going_skips_bad_file(tmp_path):
    files = synth.write_dataset(tmp_path, n_files=2, points_per_file=5_000,
                                seed=2, formats=("las",))
    # corrupt one file's signature
    bad = files["las"][1]
    data = bytearray(bad.read_bytes())
    data[0:4] = b"XXXX"
    bad.write_bytes(bytes(data))
    box = experiments.AABBS  # unused; build a covering box instead
    from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

    plan = QueryPlan(bounds=BoundsQuery(AABB((0, 0, 0), (1e7, 1e7, 1e7))))
    with pytest.raises(ValueError):
        run_query(tmp_path / "las", plan, block_size=8192)
    res = run_query(tmp_path / "las", plan, block_size=8192, keep_going=True)
    assert res.match_count == 5_000  # the good file's points


# the experiment protocol includes LAZ cells; without the native codec the
# harness legitimately cannot synthesize them
import pytest as _pytest

from adhoc_queries_pointclouds_tpu import native as _native

pytestmark = _pytest.mark.skipif(
    not _native.available(), reason="native codec unavailable"
)

"""Serving-mode tests: the JSON-lines protocol over a real subprocess, plus
the in-process request handler against the oracle."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from adhoc_queries_pointclouds_tpu.formats import open_point_cloud, synth
from adhoc_queries_pointclouds_tpu.parallel.resident import ResidentDataset
from adhoc_queries_pointclouds_tpu.serve import handle_request


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    files = synth.write_dataset(root, n_files=2, points_per_file=15_000, seed=41,
                                formats=("last",))
    return root / "last", files["last"]


def test_handle_requests(ds_dir):
    path, files = ds_dir
    ds = ResidentDataset.load(path, block_size=1 << 14)
    info = handle_request(ds, {"cmd": "info"}, str(path))
    assert info["points"] == 30_000 and info["devices"] == 8

    box = [100200.0, 200300.0, 10.0, 100900.0, 200900.0, 70.0]
    r = handle_request(ds, {"bounds": box}, str(path))
    oracle = 0
    for f in files:
        rd = open_point_cloud(f)
        w = rd.positions_world()
        m = np.all((w >= np.asarray(box[:3])) & (w <= np.asarray(box[3:])), axis=1)
        oracle += int(m.sum())
        rd.close()
    assert r["count"] == oracle > 0
    assert "ms" in r

    rc = handle_request(ds, {"class": 6}, str(path))
    assert rc["count"] > 0
    assert handle_request(ds, {"class": 19}, str(path))["count"] == 0

    err = handle_request(ds, {"bounds": [1, 2, 3]}, str(path))
    assert "error" in err
    err2 = handle_request(ds, {}, str(path))
    assert "error" in err2

    # density runs resident too; parity with the streaming engine
    rd_ = handle_request(ds, {"bounds": box, "density": 100.0}, str(path))
    assert "path" not in rd_  # resident, not streaming fallback
    from adhoc_queries_pointclouds_tpu.engine import run_query
    from adhoc_queries_pointclouds_tpu.models.query import (
        BoundsQuery, DensityConfig, QueryPlan,
    )
    from adhoc_queries_pointclouds_tpu.utils.aabb import AABB

    streaming = run_query(
        path,
        QueryPlan(
            bounds=BoundsQuery(AABB(tuple(box[:3]), tuple(box[3:]))),
            density=DensityConfig(100.0),
        ),
        block_size=1 << 14,
    ).match_count
    assert rd_["count"] == streaming > 0


def test_serve_subprocess_protocol(ds_dir):
    path, _ = ds_dir
    env = dict(os.environ)
    requests = "\n".join([
        json.dumps({"cmd": "info"}),
        json.dumps({"bounds": [100200.0, 200300.0, 10.0, 100900.0, 200900.0, 70.0]}),
        json.dumps({"class": 6}),
        "not json",
        json.dumps({"cmd": "quit"}),
    ])
    proc = subprocess.run(
        [sys.executable, "-m", "adhoc_queries_pointclouds_tpu.cli", "serve",
         "-i", str(path), "--block-size", "16384"],
        input=requests, capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.strip()]
    assert lines[0]["ready"] is True
    assert lines[1]["points"] == 30_000
    assert lines[2]["count"] > 0
    assert lines[3]["count"] > 0
    assert "error" in lines[4]
    assert lines[5]["bye"] is True


def test_serve_collect_and_output(ds_dir, tmp_path):
    """The serve protocol answers collect requests with points and can write
    matching points as LAS (the full resident query surface)."""
    path, files = ds_dir
    ds = ResidentDataset.load(path, block_size=1 << 14)
    box = [100200.0, 200300.0, 10.0, 100900.0, 200900.0, 70.0]

    r = handle_request(ds, {"bounds": box, "collect": True, "limit": 50}, str(path))
    assert r["count"] > 50
    assert len(r["points"]) == 50 and r["truncated"] is True
    for p in r["points"]:
        assert len(p) == 4  # x y z class
        assert all(box[k] <= p[k] <= box[k + 3] for k in range(3))

    out = tmp_path / "served"
    out.mkdir()
    r2 = handle_request(ds, {"bounds": box, "output": str(out)}, str(path))
    assert r2["count"] == r["count"]
    assert r2["files"], "expected written LAS files"
    from adhoc_queries_pointclouds_tpu.formats import LasFile

    written = sum(LasFile(f).point_count for f in r2["files"])
    assert written == r2["count"]

    # density + collect composes
    r3 = handle_request(ds, {"bounds": box, "density": 100.0, "collect": True}, str(path))
    assert 0 < r3["count"] <= r["count"]
    assert len(r3["points"]) == r3["count"]

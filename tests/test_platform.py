"""Platform plumbing: block-size clamping, compile-cache placement, the
native library's build key, the distributed bring-up order, and
chip_smoke.py's refusal to report without a GPU."""

import ctypes
import os
import socket
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import pytest

from adhoc_queries_pointclouds_tpu import engine, native
from adhoc_queries_pointclouds_tpu.formats import synth
from adhoc_queries_pointclouds_tpu.models.query import ClassQuery, QueryPlan
from adhoc_queries_pointclouds_tpu.parallel.resident import ResidentDataset

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("block,max_pts,want", [
    (1 << 21, 0, 1 << 21),            # no points: unchanged
    (1 << 21, 5_000_000, 1 << 21),    # big files: unchanged
    (1 << 21, 30_000, 32_768),        # small file: rounded up to the quantum
    (1 << 21, 8192, 8192),            # exactly one quantum
    (10_000, 9_000, 10_000),          # never above the requested block
])
def test_clamp_block_size(block, max_pts, want):
    assert engine.clamp_block_size(block, max_pts) == want


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
def test_block_size_same_on_every_backend(backend, tmp_path, monkeypatch):
    """The engine and the resident loader pick one block size for a
    dataset, whatever backend JAX reports."""
    files = synth.write_dataset(tmp_path, n_files=2, points_per_file=20_000,
                                seed=4, formats=("last",))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    want = engine.clamp_block_size(engine.DEFAULT_BLOCK_SIZE, 20_000)
    seen = {}

    def fake_count(*args, **kw):
        seen["block_size"] = kw["block_size"]
        return 0, [], []

    monkeypatch.setattr(engine, "_run_count", fake_count)
    engine.run_query(files["last"][0].parent, QueryPlan(classification=ClassQuery(6)),
                     use_index=False)
    ds = ResidentDataset.load(files["last"][0].parent, attrs=("classification",))
    assert seen["block_size"] == ds.block_size == want == 24_576


def test_compile_cache_dir_set_by_environment():
    assert engine.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/somewhere"}) is None


def test_compile_cache_dir_defaults_inside_checkout():
    got = Path(engine.compile_cache_dir({}))
    assert got == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert f"{got.name}/" in ignored


@pytest.mark.parametrize("change", ["flags", "cpu", "source"])
def test_native_library_key(change, tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    flags, cpu = ("-O3", "-march=native"), "model name: one"
    key = native.library_key([src], flags, cpu)
    assert key == native.library_key([src], flags, cpu)
    if change == "flags":
        other = native.library_key([src], ("-O2", "-march=native"), cpu)
    elif change == "cpu":
        other = native.library_key([src], flags, "model name: two")
    else:
        src.write_text("int f() { return 2; }\n")
        other = native.library_key([src], flags, cpu)
    assert other != key


def test_native_library_is_keyed_on_this_host():
    lib = native.load()
    assert lib is not None
    want = native.library_key(native._SOURCES, native._FLAGS, native.host_cpu())
    assert Path(lib._name).name == f"_aqpc_native_{want}.so"


@pytest.mark.parametrize("race", ["threads", "lands_mid_build"])
def test_native_concurrent_builds(race, tmp_path, monkeypatch):
    """Builds of one key racing in one directory all load the library; a
    stale build of another key goes, the shared target never."""
    src = tmp_path / "a.cpp"
    src.write_text('extern "C" int f() { return 7; }\n')
    stale = tmp_path / "_aqpc_native_0000000000000000.so"
    stale.write_bytes(b"")
    flags = ("-O1", "-shared", "-fPIC")

    def build():
        return ctypes.CDLL(str(native.build_if_needed(tmp_path, [src], flags))).f()

    if race == "threads":
        barrier = threading.Barrier(4)
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda _: (barrier.wait(), build())[1], range(4)))
    else:
        # another process finishes the same build while this one compiles
        real_run, other = subprocess.run, []

        def run(cmd, **kw):
            if not other:
                monkeypatch.setattr(native.subprocess, "run", real_run)
                other.append(build())
            return real_run(cmd, **kw)

        monkeypatch.setattr(native.subprocess, "run", run)
        got = [build(), *other]
        assert len(other) == 1
    assert got == [7] * len(got)
    key = native.library_key([src], flags, native.host_cpu())
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"_aqpc_native_{key}.so", "a.cpp"]


def test_synth_workers_write_the_same_files(tmp_path):
    kw = dict(n_files=3, points_per_file=4_000, formats=("las", "last"), seed=9,
              point_format=1, clustered=True, time_start=5.0)
    one = synth.write_dataset(tmp_path / "one", **kw)
    many = synth.write_dataset(tmp_path / "many", workers=3, **kw)
    for fmt in kw["formats"]:
        assert [p.name for p in many[fmt]] == [p.name for p in one[fmt]]
        for a, b in zip(one[fmt], many[fmt]):
            assert a.read_bytes() == b.read_bytes()


def test_distributed_cli_initializes_before_the_backend(tmp_path):
    """--distributed with a coordinator brings jax.distributed up before
    anything touches a JAX backend (one process, so it runs here)."""
    files = synth.write_dataset(tmp_path, n_files=1, points_per_file=5_000,
                                seed=6, formats=("last",))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "adhoc_queries_pointclouds_tpu.cli",
         "-i", str(files["last"][0].parent), "--class", "6", "--distributed",
         "--coordinator", f"localhost:{port}", "--num-processes", "1",
         "--process-id", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Found" in proc.stdout and "1 process(es)" in proc.stdout


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert not (REPO / ".smoke_data").exists()


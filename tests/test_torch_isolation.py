"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU
fallback, and the slices still to come refuse loudly."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu_torch as bt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "bloomsearch_tpu_torch")


def test_port_runs_without_jax_or_the_jax_package(tmp_path):
    """A fresh interpreter (this one has jax: conftest imports it) ingests,
    flushes and queries through the port on the CPU."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        import bloomsearch_tpu_torch as bt
        store = bt.FileSystemDataStore({str(tmp_path)!r})
        config = bt.BloomSearchEngineConfig(
            row_data_compression="none", probe_backend="device", device="cpu"
        )
        engine = bt.BloomSearchEngine(config, store, store)
        engine.start()
        engine.ingest_rows([{{"svc": "a", "msg": "needle here"}}, {{"svc": "b"}}], timeout=30)
        engine.flush(timeout=30)
        rows = engine.query_sync(bt.new_query().token("needle").build(), timeout=30)
        engine.stop(timeout=30)
        assert rows == [{{"svc": "a", "msg": "needle here"}}], rows
        assert engine._device_backend.launches > 0
        assert "jax" not in sys.modules
        leaked = [
            m for m in sys.modules
            if m == "bloomsearch_tpu" or m.startswith("bloomsearch_tpu.")
        ]
        assert not leaked, leaked
        print("isolated ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=240, cwd=str(tmp_path), env=env,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    assert "isolated ok" in result.stdout


def _imports(path: str):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_sources_import_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 15
    bad = []
    for path in sources:
        for module in _imports(path):
            top = module.split(".")[0]
            if top in ("jax", "jaxlib", "bloomsearch_tpu"):
                bad.append((os.path.relpath(path, REPO), module))
    assert not bad, bad


def test_default_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    store = bt.FileSystemDataStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.BloomSearchEngine(bt.BloomSearchEngineConfig(), store, store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.BloomSearchEngine(bt.BloomSearchEngineConfig(probe_backend="auto"), store, store)


@pytest.mark.parametrize("overrides", [{"mesh_devices": 2}])
def test_later_slices_raise_not_implemented(tmp_path, overrides):
    store = bt.FileSystemDataStore(str(tmp_path))
    config = bt.BloomSearchEngineConfig(device="cpu", **overrides)
    with pytest.raises(NotImplementedError):
        bt.BloomSearchEngine(config, store, store)


@pytest.mark.parametrize("sidecar", [False, True])
def test_serving_mode_builds_a_row_cache_on_the_configured_device(tmp_path, sidecar):
    from bloomsearch_tpu_torch.rowcache import DeviceRowCache
    from bloomsearch_tpu_torch.servingcache import ServingStateCache

    store = bt.FileSystemDataStore(str(tmp_path / "store"))
    config = bt.BloomSearchEngineConfig(
        device="cpu", row_cache_bytes=1 << 20,
        serving_cache_dir=str(tmp_path / "sidecar") if sidecar else None,
    )
    engine = bt.BloomSearchEngine(config, store, store)
    assert isinstance(engine._row_cache, DeviceRowCache)
    assert engine._row_cache.device == torch.device("cpu")
    assert isinstance(engine._serving_cache, ServingStateCache) == sidecar
    assert engine.stats()["row_cache"]["pinned_blocks"] == 0


def test_row_cache_on_cuda_raises_without_a_card():
    from bloomsearch_tpu_torch.rowcache import DeviceRowCache

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceRowCache(1 << 20)
    with pytest.raises(NotImplementedError):
        DeviceRowCache(1 << 20, mesh_devices=2, device="cpu")


def test_host_probe_backend_needs_no_device(tmp_path):
    store = bt.FileSystemDataStore(str(tmp_path))
    engine = bt.BloomSearchEngine(bt.BloomSearchEngineConfig(probe_backend="host"), store, store)
    assert engine._device_backend is None

"""The port's engine over a 4-shard mesh against the JAX engine's 4-device
mesh, on the same files.

The port runs ``device="cpu", mesh_devices=4`` (four CPU shards, the
kernels' plain versions); the JAX engine runs ``mesh_devices=4`` on four of
the conftest's virtual CPU devices. Every query must return the same row
multiset, in probe and in serving mode, through growth and merge-driven
compaction, and every superbank and the serving stream must stay sharded.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
import bloomsearch_tpu_torch.rowcache as rc  # noqa: E402
from bloomsearch_tpu_torch.bloom import bank as tbank  # noqa: E402
from bloomsearch_tpu_torch.kernels import probe as pk  # noqa: E402
from bloomsearch_tpu_torch.parallel import mesh as pm  # noqa: E402

from test_torch_engine import BATCHES, QUERIES, TIMEOUT, multiset  # noqa: E402

N = 4
BASE = dict(
    row_data_compression="none",
    partition_func=lambda row: row["tenant"],
    min_max_indexes=["ts"],
    max_row_group_rows=40,
    block_bloom_expected_items=200,
    probe_backend="device",
    mesh_devices=N,
)
SERVING = dict(row_cache_bytes=8 << 20, row_cache_async_pins=False)


def open_engine(pkg, directory, **kw):
    store = pkg.FileSystemDataStore(str(directory))
    config = dict(BASE, **kw)
    if pkg is bt:
        config["device"] = "cpu"
    engine = pkg.BloomSearchEngine(pkg.BloomSearchEngineConfig(**config), store, store)
    engine.start()
    return engine


def write_store(pkg, directory, batches=BATCHES, **kw) -> None:
    engine = open_engine(pkg, directory, **kw)
    try:
        for batch in batches:
            engine.ingest_rows(batch, timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def assert_sharded(engine, ref=None):
    """Every superbank is N shards of capacity / N columns on the mesh
    devices; with ``ref`` (the JAX engine) the capacities are equal."""
    backend = engine._device_backend
    assert backend.mesh is not None and backend.mesh.size == N
    assert backend._superbanks, "device path not exercised"
    for sb in backend._superbanks.values():
        assert tuple(s.device for s in sb.bank2d) == backend.mesh.devices
        assert [s.shape[1] for s in sb.bank2d] == [sb.capacity // N] * N
        assert sb.capacity % (128 * N) == 0
    if ref is not None:
        want = {k: v["capacity"] for k, v in ref.stats()["device"]["superbanks"].items()}
        got = {k: v["capacity"] for k, v in engine.stats()["device"]["superbanks"].items()}
        assert got == want


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mesh_engine")
    write_store(bt, root / "store")
    opened = {"jax": open_engine(bs, root / "store"), "port": open_engine(bt, root / "store")}
    opened["port"].warmup(block=True, timeout=120)
    yield opened
    for engine in opened.values():
        engine.stop(timeout=TIMEOUT)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_mesh_query_matches_reference(engines, name):
    want = multiset(engines["jax"].query_sync(QUERIES[name](bs), timeout=TIMEOUT))
    got = multiset(engines["port"].query_sync(QUERIES[name](bt), timeout=TIMEOUT))
    assert got == want
    if name != "token_absent":
        assert want


def test_mesh_engine_is_sharded_like_the_reference(engines):
    engines["jax"].query_sync(QUERIES["and_of_or"](bs), timeout=TIMEOUT)
    engines["port"].query_sync(QUERIES["and_of_or"](bt), timeout=TIMEOUT)
    assert_sharded(engines["port"], engines["jax"])
    stats = engines["port"].stats()["device"]
    assert stats["mesh_devices"] == N and stats["probe_launches"] > 0


def test_growth_and_merge_compaction_stay_sharded(tmp_path):
    """Many small flushes grow the superbanks (columns move shards); a merge
    tombstones the files (segments removed, banks compacted)."""
    small = [[{"n": f * 10 + i, "tag": f"t{f}", "tenant": "x", "ts": i} for i in range(10)]
             for f in range(6)]
    out = {}
    for pkg, name in ((bs, "jax"), (bt, "port")):
        write_store(pkg, tmp_path / name, small)
        engine = open_engine(pkg, tmp_path / name, max_row_group_rows=400)
        try:
            runs = [multiset(engine.query_sync(pkg.new_query().token("t4").build(), timeout=TIMEOUT))]
            if pkg is bt:
                assert_sharded(engine)
                grown = {k: v["capacity"] for k, v in engine.stats()["device"]["superbanks"].items()}
            assert engine.merge().files_processed == 6
            runs.append(multiset(engine.query_sync(pkg.new_query().token("t4").build(), timeout=TIMEOUT)))
            runs.append(multiset(engine.query_sync(pkg.new_query().token("t1").build(), timeout=TIMEOUT)))
            if pkg is bt:
                assert_sharded(engine, out["jax_engine"])
                stats = engine.stats()["device"]["superbanks"]
                assert sum(v["dead"] for v in stats.values()) < sum(grown.values())
            out[name] = runs
            if pkg is bs:
                out["jax_engine"] = engine
                continue
        finally:
            if pkg is bt:
                engine.stop(timeout=TIMEOUT)
                out["jax_engine"].stop(timeout=TIMEOUT)
    assert out["port"] == out["jax"]
    assert all(out["port"])


def test_mesh_devices_one_gives_no_mesh(tmp_path):
    engine = open_engine(bt, tmp_path, mesh_devices=1, **SERVING)
    try:
        assert engine._device_backend.mesh is None and engine._row_cache.mesh is None
        row = {"a": "solo", "tenant": "t0", "ts": 1}
        engine.ingest_rows([row], timeout=TIMEOUT)
        engine.flush(timeout=TIMEOUT)
        assert engine.query_sync(bt.new_query().token("solo").build(), timeout=TIMEOUT) == [row]
        assert isinstance(next(iter(engine._device_backend._superbanks.values())).bank2d, torch.Tensor)
    finally:
        engine.stop(timeout=TIMEOUT)


@pytest.mark.parametrize("cls", ["backend", "row_cache", "engine"])
def test_mesh_devices_beyond_the_visible_cards_raises(tmp_path, monkeypatch, cls):
    """Two cards asked for and one visible: the constructor raises; it
    never shrinks the mesh or moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="mesh_devices=2 but only 1 device"):
        if cls == "backend":
            tbank.DeviceProbeBackend(device="cuda", mesh_devices=2)
        elif cls == "row_cache":
            rc.DeviceRowCache(1 << 20, mesh_devices=2, device="cuda")
        else:
            store = bt.FileSystemDataStore(str(tmp_path))
            bt.BloomSearchEngine(bt.BloomSearchEngineConfig(mesh_devices=2), store, store)


# -- serving mode on the mesh ------------------------------------------------


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """The JAX serving engine (mesh 4, synchronous pins) and the port's
    (mesh 4, warmed up: every block pinned) on one store, and the launch
    modes the port's scans took."""
    root = tmp_path_factory.mktemp("torch_mesh_serving")
    write_store(bt, root / "store")
    ref = open_engine(bs, root / "store", **SERVING)
    port = open_engine(bt, root / "store", **SERVING)
    port.warmup(block=True, timeout=120)
    yield {"jax": ref, "port": port, "root": root}
    ref.stop(timeout=TIMEOUT)
    port.stop(timeout=TIMEOUT)


def single_device_rule(ranges, cap: int) -> str:
    """The mode the JAX single-device row cache launches for a batch's
    requested ranges on a stream of ``cap`` chunks (its ``sparse`` rule in
    ``DeviceRowCache._launch_bucket_scan``): pow2 segments of at least 512
    chunks, a pow2 count of at most 4, a quarter of the stream at most."""
    def pow2(n):
        return 1 << (max(n, 1) - 1).bit_length()

    seg = max(pow2(max((n for _, n in ranges), default=1)), 512)
    n_segs = pow2(len(ranges)) if ranges else 0
    sparse = 0 < n_segs <= 4 and seg <= cap and n_segs * seg * 4 <= cap
    return "sharded_scan_segments" if sparse else "sharded_scan_all_rows"


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_mesh_serving_query_matches_reference(serving, monkeypatch, name):
    cache = serving["port"]._row_cache
    modes, batches = [], []
    for fn in ("sharded_scan_all_rows", "sharded_scan_segments"):
        orig = getattr(rc, fn)
        monkeypatch.setattr(
            rc, fn, lambda *a, _o=orig, _f=fn, **k: modes.append(_f) or _o(*a, **k)
        )
    orig_launch = cache._launch_bucket_scan

    def launch(bucket, matrix, version, batch):
        ranges = sorted({seg for r in batch for seg in r.segments if seg is not None and seg[1]})
        before = len(modes)
        orig_launch(bucket, matrix, version, batch)
        batches.append((modes[before:], single_device_rule(ranges, pm.logical_size(matrix, 0))))

    monkeypatch.setattr(cache, "_launch_bucket_scan", launch)
    cache.needle_cache_enabled = False
    want = None
    for key in ("jax", "port"):
        pkg = bs if key == "jax" else bt
        for _ in range(2):  # the JAX engine's second run scans its pins
            got = multiset(serving[key].query_sync(QUERIES[name](pkg), timeout=TIMEOUT))
            want = got if want is None else want
            assert got == want, key
    # Each launch is the mode the single-device rule picks for its batch.
    assert all(launched and set(launched) == {rule} for launched, rule in batches)


def test_mesh_serving_scans_sparse_where_one_device_would(serving, monkeypatch):
    """A needle under a narrow min/max prefilter asks for one block: the
    mesh scans just its range (one ``sharded_scan_segments`` call, as the
    single-device rule says), and the rows equal the JAX mesh engine's."""
    cache = serving["port"]._row_cache
    calls = []
    for fn in ("sharded_scan_all_rows", "sharded_scan_segments"):
        orig = getattr(rc, fn)
        monkeypatch.setattr(rc, fn, lambda *a, _o=orig, _f=fn, **k: calls.append(_f) or _o(*a, **k))
    cache.needle_cache_enabled = False
    rows = {}
    for key, pkg in (("jax", bs), ("port", bt)):
        query = (pkg.new_query()
                 .match_prefilter(pkg.and_(pkg.partition(pkg.partition_equals("t1")),
                                           pkg.min_max("ts", pkg.numeric_between(10_100, 10_110))))
                 .field("level").build())
        rows[key] = [multiset(serving[key].query_sync(query, timeout=TIMEOUT)) for _ in range(2)]
    assert rows["port"] == rows["jax"] and rows["port"][0]
    assert calls == ["sharded_scan_segments"] * 2


def test_mesh_serving_stream_is_sharded(serving):
    port = serving["port"]
    port._row_cache.needle_cache_enabled = False
    launches = port.stats()["row_cache"]["scan_launches"]
    port.query_sync(QUERIES["and_2"](bt), timeout=TIMEOUT)
    stats = port.stats()["row_cache"]
    assert stats["scan_launches"] > launches and stats["mesh_devices"] == N
    cache = port._row_cache
    store = bt.FileSystemDataStore(str(serving["root"] / "store"))
    n_blocks = sum(len(mf.metadata.data_blocks) for mf in store.get_maybe_files_for_query(None))
    assert stats["pinned_blocks"] == n_blocks
    assert cache._chunk_unit == 512 * N and cache._bucket.cap % (512 * N) == 0
    assert [s.shape[0] for s in cache._bucket.matrix] == [cache._bucket.cap // N] * N
    # A dense sharded call and a sparse one (a block that size scans sparse).
    assert port.stats()["warmup"]["scan_aot_programs"] == 2


def test_single_device_sidecar_loads_into_a_sharded_cache(tmp_path):
    """A sidecar written by the single-device port warms a 4-shard cache
    from packed state alone, and both scan to the same rows."""
    write_store(bt, tmp_path / "store")
    sidecar = str(tmp_path / "sidecar")
    results = []
    for mesh_devices in (1, N):
        engine = open_engine(
            bt, tmp_path / "store", mesh_devices=mesh_devices, serving_cache_dir=sidecar,
            row_cache_host_shadow=False, **SERVING,
        )
        try:
            engine.warmup(block=True, timeout=120)
            engine._row_cache.needle_cache_enabled = False
            if mesh_devices == N:
                stats = engine.stats()
                assert stats["serving_cache"]["hits"] == stats["row_cache"]["pinned_blocks"] > 0
                assert len(engine._row_cache._bucket.matrix) == N
            results.append([
                multiset(engine.query_sync(QUERIES[q](bt), timeout=TIMEOUT))
                for q in ("token", "and_2", "or", "regex", "common")
            ])
        finally:
            engine.stop(timeout=TIMEOUT)
    assert results[0] == results[1] and all(results[0])


def test_mesh_shard_launch_failure_fails_the_query(tmp_path, monkeypatch):
    """No fallback: a failed launch over a card's shards fails the query
    (no per-shard retry, no host probe)."""
    write_store(bt, tmp_path / "store")
    engine = open_engine(bt, tmp_path / "store", warmup_on_start=False)
    try:
        query = QUERIES["and_of_or"](bt)
        assert engine.query_sync(query, timeout=TIMEOUT)
        calls = []

        def clauses_launch_fails(out, plan, *a, _orig=pk.probe_plan_into, **kw):
            calls.append([len(banks) for _, banks in plan])
            if a[-1] == "clauses":
                raise RuntimeError("probe plan failed: cudaError 98")
            return _orig(out, plan, *a, **kw)

        monkeypatch.setattr(pk, "probe_plan_into", clauses_launch_fails)
        with pytest.raises(RuntimeError, match="cudaError 98"):
            engine.query_sync(query, timeout=TIMEOUT)
        assert calls == [[N]]  # one plan call, one launch over the mesh's N CPU shards
    finally:
        engine.stop(timeout=TIMEOUT)


def test_sharded_wrappers_count_only_cuda_launches():
    mesh = pm.default_mesh(2, "cpu")
    pm.reset_launch_counts()
    bank = pm.shard_bank(mesh, np.ones((6, 256), np.uint32))
    zero = np.zeros(1, np.int32)
    pm.sharded_probe_packed(mesh, bank, zero, zero, 1, 1)
    assert pm.launch_counts() == dict.fromkeys(pm.launch_counts(), 0)

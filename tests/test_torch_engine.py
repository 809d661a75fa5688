"""The port's engine against the JAX package's, on the same rows.

The JAX engine runs its device probe backend on CPU JAX (``probe_backend=
"device"``, ``mesh_devices=1``); the port's runs its backend on
``device="cpu"``, i.e. the probe kernel's plain version. Each package writes
its own store from the same rows, and every query must return the same row
multiset from four pairings: each engine on its own store and on the other
package's store (the file format is shared).
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
from bloomsearch_tpu_torch.bloom.bank import BankChurnError  # noqa: E402

TIMEOUT = 30.0
WORDS = [f"w{i}" for i in range(24)]
WIDE = [f"k{i}" for i in range(18)]  # 18 terms: more than one launch's 16


def make_rows(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {
            "service": ["payment", "auth", "search", "billing"][rng.integers(4)],
            "level": ["info", "warn", "error"][rng.integers(3)],
            "msg": " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), rng.integers(1, 5))),
            "tenant": f"t{rng.integers(4)}",
            "ts": int(seed * 10_000 + i * 7),
        }
        if rng.random() < 0.2:
            row["user"] = {"name": ["john doe", "ann lee"][rng.integers(2)]}
        if rng.random() < 0.1:
            row["amount"] = float(rng.integers(1, 100))
        rows.append(row)
    rows[seed % n]["msg"] = " ".join(WIDE)  # one row holds every wide term
    return rows


BATCHES = [make_rows(seed, 120) for seed in range(3)]


def config(pkg, **kw):
    common = dict(
        row_data_compression="none",
        partition_func=lambda row: row["tenant"],
        min_max_indexes=["ts"],
        max_row_group_rows=40,
        block_bloom_expected_items=200,
        probe_backend="device",
    )
    common.update(kw)
    if pkg is bs:
        return bs.BloomSearchEngineConfig(mesh_devices=1, **common)
    return bt.BloomSearchEngineConfig(device="cpu", **common)


def open_engine(pkg, directory, **kw):
    store = pkg.FileSystemDataStore(str(directory))
    engine = pkg.BloomSearchEngine(config(pkg, **kw), store, store)
    engine.start()
    return engine


def write_store(pkg, directory) -> None:
    engine = open_engine(pkg, directory)
    try:
        for batch in BATCHES:
            engine.ingest_rows(batch, timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def multiset(rows) -> list[str]:
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


# Each query is a function of the package, so each engine gets its own
# package's query objects.
QUERIES = {
    "token": lambda m: m.new_query().token("w3").build(),
    "token_absent": lambda m: m.new_query().token("nosuchtoken").build(),
    "field": lambda m: m.new_query().field("user.name").build(),
    "field_sparse": lambda m: m.new_query().field("amount").build(),
    "field_token": lambda m: m.new_query().field_token("service", "payment").build(),
    "field_token_nested": lambda m: m.new_query().field_token("user.name", "john").build(),
    "and_2": lambda m: m.new_query().token("w5").field_token("level", "error").build(),
    "and_3": lambda m: m.new_query().token("w1").field("service").field_token("level", "info").build(),
    "or": lambda m: m.new_query().match(m.or_(m.token("w7"), m.token("w8"))).build(),
    "or_of_and": lambda m: m.new_query().match(
        m.or_(m.and_(m.token("w1"), m.token("w9")), m.field("amount"))
    ).build(),
    "and_of_or": lambda m: m.new_query().match(
        m.and_(
            m.or_(m.field_token("service", "auth"), m.field_token("service", "search")),
            m.token("w4"),
        )
    ).build(),
    "wide_and": lambda m: m.new_query().match(m.and_(*[m.token(t) for t in WIDE])).build(),
    "wide_or": lambda m: m.new_query().match(
        m.or_(*[m.token(t) for t in WIDE[:9]], *[m.token(f"absent{i}") for i in range(9)])
    ).build(),
    "regex": lambda m: m.new_query().field_regex("msg", "w1[0-9] w2").build(),
    "regex_and_token": lambda m: m.new_query().field_regex("service", "^pay").token("w6").build(),
    "partition": lambda m: m.new_query()
    .match_prefilter(m.partition(m.partition_equals("t1")))
    .token("w4")
    .build(),
    "partition_in": lambda m: m.new_query()
    .match_prefilter(m.partition(m.partition_in("t0", "t3")))
    .field("user.name")
    .build(),
    "minmax": lambda m: m.new_query()
    .match_prefilter(m.min_max("ts", m.numeric_between(10_100, 10_500)))
    .token("w2")
    .build(),
    "minmax_or": lambda m: m.new_query()
    .match_prefilter(m.min_max("ts", m.numeric_less_than(300)))
    .match(m.or_(m.field_token("level", "warn"), m.token("w0")))
    .build(),
    "prefilter_only": lambda m: m.new_query()
    .match_prefilter(m.prefilter_and(
        m.partition(m.partition_equals("t2")), m.min_max("ts", m.numeric_greater_than(20_000))
    ))
    .build(),
    "field_and_token_or": lambda m: m.new_query().field("user.name").match(
        m.or_(m.token("w10"), m.token("w11"), m.field_token("level", "info"))
    ).build(),
    "common": lambda m: m.new_query().field("msg").build(),
}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine")
    write_store(bs, root / "jax")
    write_store(bt, root / "port")
    opened = {
        (pkg_name, store): open_engine(pkg, root / store)
        for pkg_name, pkg in (("jax", bs), ("port", bt))
        for store in ("jax", "port")
    }
    yield opened
    for engine in opened.values():
        engine.stop(timeout=TIMEOUT)


def test_at_least_20_query_shapes():
    assert len(QUERIES) >= 20


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_reference(engines, name):
    results = {
        key: multiset(engine.query_sync(QUERIES[name](bs if key[0] == "jax" else bt), timeout=TIMEOUT))
        for key, engine in engines.items()
    }
    want = results[("jax", "jax")]
    for key, got in results.items():
        assert got == want, key
    if name != "token_absent":
        assert want, "every query shape but one should find rows"


def test_port_probes_went_through_the_device_backend(engines):
    engine = engines[("port", "port")]
    engine.query_sync(bt.new_query().token("w3").build(), timeout=TIMEOUT)
    stats = engine.stats()["device"]
    assert stats["platform"] == "cpu" and stats["probe_launches"] > 0


def test_merge_then_requery(tmp_path):
    for pkg, name in ((bs, "jax"), (bt, "port")):
        write_store(pkg, tmp_path / name)
    out = {}
    for pkg, name in ((bs, "jax"), (bt, "port")):
        # Larger row groups than at ingest, so the 40-row blocks merge.
        engine = open_engine(pkg, tmp_path / name, max_row_group_rows=400)
        try:
            stats = engine.merge()
            assert stats.files_processed == 3
            out[name] = [
                multiset(engine.query_sync(QUERIES[q](pkg), timeout=TIMEOUT))
                for q in ("token", "or", "wide_and", "partition")
            ]
            assert len(pkg.FileSystemDataStore(str(tmp_path / name)).get_maybe_files_for_query(None)) == 1
        finally:
            engine.stop(timeout=TIMEOUT)
    assert out["port"] == out["jax"]
    assert all(out["port"])


class KernelFailure(RuntimeError):
    pass


@pytest.mark.parametrize("error", [BankChurnError, KernelFailure])
def test_only_bank_churn_degrades_to_host_probing(tmp_path, monkeypatch, error):
    """Churn falls back to the host probe; a kernel or device failure
    (any other RuntimeError, CUDA OOM among them) fails the query."""
    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", warmup_on_start=False)
    query = QUERIES["and_of_or"](bt)
    try:
        want = multiset(engine.query_sync(query, timeout=TIMEOUT))

        def failing_probe(*args, **kwargs):
            raise error("probe failed")

        monkeypatch.setattr(engine._device_backend, "probe_groups", failing_probe)
        if error is BankChurnError:
            assert multiset(engine.query_sync(query, timeout=TIMEOUT)) == want
        else:
            with pytest.raises(KernelFailure):
                engine.query_sync(query, timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_warmup_raises_device_failures(tmp_path, monkeypatch):
    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", warmup_on_start=False)
    try:
        def failing_launch(*args, **kwargs):
            raise KernelFailure("kernel did not build")

        monkeypatch.setattr(
            engine._device_backend, "precompile_probe_programs", failing_launch
        )
        with pytest.raises(KernelFailure):
            engine.warmup(block=True, timeout=120)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_warmup_then_query(tmp_path):
    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port")
    try:
        engine.warmup(block=True, timeout=120)
        backend = engine._device_backend
        store = bt.FileSystemDataStore(str(tmp_path / "port"))
        for mf in store.get_maybe_files_for_query(None):
            for gi, group in enumerate(mf.metadata.bank_groups):
                mk = (group.m_bits, group.k, group.params.layout)
                assert backend.is_resident(mk, backend.segment_key(mf.pointer, gi))
        got = multiset(engine.query_sync(QUERIES["and_of_or"](bt), timeout=TIMEOUT))
    finally:
        engine.stop(timeout=TIMEOUT)
    ref = open_engine(bs, tmp_path / "port")
    try:
        assert got == multiset(ref.query_sync(QUERIES["and_of_or"](bs), timeout=TIMEOUT))
    finally:
        ref.stop(timeout=TIMEOUT)


# -- serving mode: the device row cache and its scan kernel ------------------

SERVING = dict(row_cache_bytes=8 << 20, row_cache_async_pins=False)


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """The JAX serving engine and the port's, shadowed and shadow-free, on
    one store. The port's engines warm up (every block pinned); the JAX
    engine pins each block on its first query (synchronous pins)."""
    root = tmp_path_factory.mktemp("torch_serving")
    write_store(bt, root / "store")
    opened = {"jax": open_engine(bs, root / "store", **SERVING)}
    for shadow in (True, False):
        engine = open_engine(bt, root / "store", row_cache_host_shadow=shadow, **SERVING)
        engine.warmup(block=True, timeout=120)
        opened[f"port_shadow_{shadow}"] = engine
    yield opened
    for engine in opened.values():
        engine.stop(timeout=TIMEOUT)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_serving_query_matches_reference(serving, name):
    want = None
    for key, engine in serving.items():
        pkg = bs if key == "jax" else bt
        for _ in range(2):  # the JAX engine's second run scans its pins
            got = multiset(engine.query_sync(QUERIES[name](pkg), timeout=TIMEOUT))
            want = got if want is None else want
            assert got == want, key


def test_serving_engines_scan_on_the_device(serving):
    for key in ("port_shadow_True", "port_shadow_False"):
        engine = serving[key]
        engine.query_sync(QUERIES["and_2"](bt), timeout=TIMEOUT)
        stats = engine.stats()
        assert stats["row_cache"]["pinned_blocks"] > 0
        assert stats["row_cache"]["scan_launches"] > 0
        assert stats["background_pin_failures"] == 0
        cache = engine._row_cache
        assert cache.device.type == "cpu" and cache._bucket.matrix.device.type == "cpu"
        shadowed = next(iter(cache._blocks.values())).data is not None
        assert shadowed == (key == "port_shadow_True")


def test_serving_sparse_and_dense_launches_match_reference(tmp_path, monkeypatch):
    """A stream large enough for the segment mode: needle queries over 1-3
    blocks launch segments, a common token launches the dense scan, and
    both return the JAX serving engine's rows."""
    import bloomsearch_tpu_torch.rowcache as rc

    rows = [
        {"i": i, "msg": f"tok{i} " + " ".join(WORDS[j % 24] for j in range(i, i + 40))}
        for i in range(9000)
    ]
    kw = dict(SERVING, partition_func=None, max_row_group_rows=300,
              block_bloom_expected_items=2000)
    for pkg, name in ((bs, "jax"), (bt, "port")):
        engine = open_engine(pkg, tmp_path / name, **kw)
        try:
            for lo in range(0, len(rows), 300):  # one block per 300 rows
                engine.ingest_rows(rows[lo : lo + 300], timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
        finally:
            engine.stop(timeout=TIMEOUT)
    modes = []
    for fn in ("byte_scan_stream", "byte_scan_segments"):
        orig = getattr(rc, fn)
        monkeypatch.setattr(
            rc, fn, lambda *a, _orig=orig, _fn=fn, **k: modes.append(_fn) or _orig(*a, **k)
        )
    ref = open_engine(bs, tmp_path / "port", **kw)
    port = open_engine(bt, tmp_path / "port", **kw)
    try:
        port.warmup(block=True, timeout=120)
        # 30 blocks of under 512 chunks each: two 512-chunk segments are
        # under a quarter of the stream, so needle queries go sparse.
        assert len(port._row_cache._blocks) == 30
        assert port._row_cache._bucket.cap >= 4096
        queries = {
            "needle": lambda m: m.new_query().token("tok4321").build(),
            "two_needles": lambda m: m.new_query().match(
                m.or_(m.token("tok17"), m.token("tok8999"))).build(),
            "common": lambda m: m.new_query().token("w3").build(),
        }
        for qname, make in queries.items():
            modes.clear()
            for _ in range(2):
                ref.query_sync(make(bs), timeout=TIMEOUT)
            got = multiset(port.query_sync(make(bt), timeout=TIMEOUT))
            assert got == multiset(ref.query_sync(make(bs), timeout=TIMEOUT)), qname
            assert got, qname
            assert modes == (["byte_scan_stream"] if qname == "common" else ["byte_scan_segments"]), (qname, modes)
    finally:
        ref.stop(timeout=TIMEOUT)
        port.stop(timeout=TIMEOUT)


def test_serving_warmup_then_query(tmp_path):
    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", row_cache_bytes=8 << 20)
    try:
        engine.warmup(block=True, timeout=120)
        store = bt.FileSystemDataStore(str(tmp_path / "port"))
        n_blocks = sum(
            len(mf.metadata.data_blocks) for mf in store.get_maybe_files_for_query(None)
        )
        stats = engine.stats()
        assert stats["row_cache"]["pinned_blocks"] == n_blocks
        assert stats["warmup"]["scan_aot_programs"] >= 1
        launches = stats["row_cache"]["scan_launches"]
        got = multiset(engine.query_sync(QUERIES["and_of_or"](bt), timeout=TIMEOUT))
        assert engine.stats()["row_cache"]["scan_launches"] > launches
    finally:
        engine.stop(timeout=TIMEOUT)
    ref = open_engine(bs, tmp_path / "port")
    try:
        assert got == multiset(ref.query_sync(QUERIES["and_of_or"](bs), timeout=TIMEOUT))
    finally:
        ref.stop(timeout=TIMEOUT)


def test_serving_merge_then_requery(tmp_path):
    """Merge tombstones the old files: their pins are invalidated and the
    merged file's blocks pin on the next queries; rows match the JAX
    serving engine's after the same merge."""
    for pkg, name in ((bs, "jax"), (bt, "port")):
        write_store(pkg, tmp_path / name)
    out = {}
    for pkg, name in ((bs, "jax"), (bt, "port")):
        engine = open_engine(pkg, tmp_path / name, max_row_group_rows=400, **SERVING)
        try:
            if pkg is bt:
                engine.warmup(block=True, timeout=120)
                pinned = {k[0] for k in engine._row_cache._blocks}
                assert len(pinned) == 3
            assert engine.merge().files_processed == 3
            if pkg is bt:
                assert not pinned & {k[0] for k in engine._row_cache._blocks}
            out[name] = [
                [multiset(engine.query_sync(QUERIES[q](pkg), timeout=TIMEOUT)) for _ in range(2)]
                for q in ("token", "or", "wide_and", "partition")
            ]
            if pkg is bt:
                assert engine.stats()["row_cache"]["pinned_blocks"] > 0
        finally:
            engine.stop(timeout=TIMEOUT)
    assert out["port"] == out["jax"]
    assert all(runs[0] for runs in out["port"])


def _failing(*args, **kwargs):
    raise KernelFailure("scan kernel did not launch")


def test_scan_kernel_failure_fails_the_query(tmp_path, monkeypatch):
    """No per-block fallback: a scan kernel error fails the query."""
    import bloomsearch_tpu_torch.rowcache as rc

    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", **SERVING)
    try:
        engine.warmup(block=True, timeout=120)
        query = QUERIES["and_2"](bt)
        assert engine.query_sync(query, timeout=TIMEOUT)
        engine._row_cache.needle_cache_enabled = False
        monkeypatch.setattr(rc, "byte_scan_stream", _failing)
        monkeypatch.setattr(rc, "byte_scan_segments", _failing)
        with pytest.raises(KernelFailure):
            engine.query_sync(query, timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_scan_kernel_failure_fails_warmup(tmp_path, monkeypatch):
    import bloomsearch_tpu_torch.rowcache as rc

    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", **SERVING)
    try:
        monkeypatch.setattr(rc, "byte_scan_stream", _failing)
        with pytest.raises(KernelFailure):
            engine.warmup(block=True, timeout=120)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_device_failure_of_a_background_pin_reaches_the_next_query(tmp_path, monkeypatch):
    import bloomsearch_tpu_torch.rowcache as rc

    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", row_cache_bytes=8 << 20)
    try:
        monkeypatch.setattr(rc, "_update_rows", _failing)
        query = QUERIES["token"](bt)
        engine.query_sync(query, timeout=TIMEOUT)  # cold: pins in the background
        engine.drain_background_pins(timeout=TIMEOUT)
        assert engine.stats()["background_pin_failures"] > 0
        with pytest.raises(KernelFailure):
            engine.query_sync(query, timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_host_fault_of_a_background_pin_is_not_held(tmp_path, monkeypatch):
    """Only device failures reach the next query: a host-side fault (bad
    block bytes) leaves the block a cache miss and fails no query."""
    import bloomsearch_tpu_torch.rowcache as rc

    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", row_cache_bytes=8 << 20)
    try:
        def bad_bytes(*args, **kwargs):
            raise ValueError("malformed block")

        monkeypatch.setattr(rc, "pack_block", bad_bytes)
        query = QUERIES["token"](bt)
        want = multiset(engine.query_sync(query, timeout=TIMEOUT))
        engine.drain_background_pins(timeout=TIMEOUT)
        assert engine.stats()["background_pin_failures"] == 0
        assert engine.stats()["row_cache"]["pinned_blocks"] == 0
        assert multiset(engine.query_sync(query, timeout=TIMEOUT)) == want
    finally:
        engine.stop(timeout=TIMEOUT)


def test_warmup_loads_the_scan_kernel_before_pinning(tmp_path, monkeypatch):
    """The scan library loads first, so no query waits behind a build on a
    host path; a build error fails warmup() before anything is pinned."""
    import bloomsearch_tpu_torch.rowcache as rc

    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", **SERVING)
    pins_at_load = []

    def failing_load(cache):
        pins_at_load.append(cache.pins)
        raise KernelFailure("scan kernel did not build")

    monkeypatch.setattr(rc.DeviceRowCache, "load_scan_kernel", failing_load)
    try:
        with pytest.raises(KernelFailure):
            engine.warmup(block=True, timeout=120)
        assert pins_at_load == [0]
        assert engine.stats()["row_cache"]["pinned_blocks"] == 0
    finally:
        engine.stop(timeout=TIMEOUT)


def test_query_during_warmup_scans_pinned_blocks_on_the_device(tmp_path, monkeypatch):
    """While warmup runs, a pinned block is scanned by the kernel and never
    re-read from the store for a host scan (shadowed pins hold their rows,
    so the query opens no store file at all)."""
    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", row_cache_host_shadow=True, **SERVING)
    try:
        engine.warmup(block=True, timeout=120)
        engine._row_cache.needle_cache_enabled = False
        engine._warmup_active.set()  # as while a warmup pass runs
        opened = []
        open_file = engine.data_store.open_file
        monkeypatch.setattr(
            engine.data_store, "open_file", lambda p: opened.append(p) or open_file(p)
        )
        launches = engine.stats()["row_cache"]["scan_launches"]
        query = QUERIES["and_2"](bt)
        got = multiset(engine.query_sync(query, timeout=TIMEOUT))
        assert engine.stats()["row_cache"]["scan_launches"] > launches
        assert engine._query_timings[-1]["pinned"] > 0
        assert opened == []
        engine._warmup_active.clear()
    finally:
        engine.stop(timeout=TIMEOUT)
    ref = open_engine(bs, tmp_path / "port")
    try:
        assert got == multiset(ref.query_sync(QUERIES["and_2"](bs), timeout=TIMEOUT))
    finally:
        ref.stop(timeout=TIMEOUT)


def test_query_during_the_warmup_scan_check_uses_the_kernel(tmp_path, monkeypatch):
    """A query that arrives while warmup's first pins wait for their launch
    check scans those pins on the device: no gate routes them to the host."""
    import threading

    import bloomsearch_tpu_torch.rowcache as rc

    write_store(bt, tmp_path / "port")
    engine = open_engine(bt, tmp_path / "port", row_cache_host_shadow=True, **SERVING)
    reached, release = threading.Event(), threading.Event()
    precompile = rc.DeviceRowCache.precompile_scan_programs

    def held(cache, *args, **kwargs):
        reached.set()
        release.wait(TIMEOUT)
        return precompile(cache, *args, **kwargs)

    monkeypatch.setattr(rc.DeviceRowCache, "precompile_scan_programs", held)
    try:
        warm = engine.warmup(block=False)
        assert reached.wait(TIMEOUT)
        launches = engine.stats()["row_cache"]["scan_launches"]
        got = multiset(engine.query_sync(QUERIES["and_2"](bt), timeout=TIMEOUT))
        assert engine._query_timings[-1]["pinned"] > 0
        assert engine.stats()["row_cache"]["scan_launches"] > launches
        release.set()
        warm.result(timeout=120)
    finally:
        release.set()
        engine.stop(timeout=TIMEOUT)
    ref = open_engine(bs, tmp_path / "port")
    try:
        assert got == multiset(ref.query_sync(QUERIES["and_2"](bs), timeout=TIMEOUT))
    finally:
        ref.stop(timeout=TIMEOUT)

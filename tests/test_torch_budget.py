"""Serving beyond both cache budgets: the port's engine against the JAX one.

One dataset, written by the JAX package, holds more filter-bank columns
than ``bank_cache_bytes`` and more row-stream chunks than
``row_cache_bytes`` (the JAX bench's xlscale regime at test scale, in
the refscale dataset's layout: files of 10 partitions, a block each, so
bank groups of 10 columns; 30 files, 300 columns). Every engine opens it
with the same budgets, so every query mixes device-probed resident groups
with sparse cold probes of the rest, background bank warms insert into the
superbank, evict from it and compact it, and on-demand pins evict blocks
from the stream in place and compact it. ``SPARSE_BANK_BYTES`` is 0 in both engine modules, so every
non-resident group takes the sparse cold path, as a refscale group of 54 MB
does against the 4 MB default.

The JAX engine runs its device backend on CPU JAX (``mesh_devices=1``); the
port's runs on ``device="cpu"`` (the kernels' plain versions), and on a
2-shard CPU mesh. Every query's rows must be identical across the engines,
and after each query the background warms drain, so both engines make the
same residency decisions and their shared ``stats()`` counters agree.

The rest of the file holds the port's counterparts of the reference's
beyond-budget engine tests (``tests/test_warmup.py``
``TestIncrementalWarmup.test_beyond_budget_serving_evicts_in_place`` and
``TestWarmupBankBudget``, and the engine cases of
``tests/test_sparse_probe.py``).
"""

import json
import logging
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu.bloom.bank as jax_bank  # noqa: E402
import bloomsearch_tpu.bloom.probe as jax_probe  # noqa: E402
import bloomsearch_tpu.engine as jax_engine  # noqa: E402
import bloomsearch_tpu.rowcache as jax_rowcache  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
import bloomsearch_tpu_torch.bloom.bank as port_bank  # noqa: E402
import bloomsearch_tpu_torch.bloom.probe as port_probe  # noqa: E402
import bloomsearch_tpu_torch.engine as port_engine  # noqa: E402
import bloomsearch_tpu_torch.rowcache as port_rowcache  # noqa: E402

TIMEOUT = 60.0
FILES = 30
PARTITIONS = 10  # one block a partition a file, as refscale
ROWS = 40
PAD_BYTES = 400  # random hex: ~19 KB, ~40 stream chunks a block
NEEDLE_ROWS = ((1, 3, 5), (9, 0, 0), (20, 8, 9))  # (file, partition, row)
ABSENT = [f"absentword{i}q" for i in range(17)]

PACKAGES = {"jax": (bs, jax_engine, jax_bank, jax_probe, jax_rowcache),
            "port": (bt, port_engine, port_bank, port_probe, port_rowcache)}


def make_rows(f: int, p: int, rng) -> list[dict]:
    rows = []
    for i in range(ROWS):
        row = {
            "uid": f"u{f:02x}{p:02x}{i:04x}", "part": f"p{p:02d}",
            "msg": f"w{(i * 7 + p) % 40} blk{f}x{p}tok" + (f" file{f}tok" if i % 10 == 0 else ""),
            "pad": rng.bytes(PAD_BYTES // 2).hex(),
        }
        if (f, p, i) in NEEDLE_ROWS:
            row["msg"] += " needletok"
            row["needlefield"] = "v"
            row["svc"] = "needlesvc"
        rows.append(row)
    return rows


def write_dataset(directory) -> None:
    """The JAX package writes every file: a file per flush, a block per
    partition."""
    store = bs.FileSystemDataStore(str(directory))
    engine = bs.BloomSearchEngine(
        bs.BloomSearchEngineConfig(
            probe_backend="host", row_data_compression="snappy",
            partition_func=lambda row: row["part"], max_row_group_rows=10_000,
            block_bloom_expected_items=200,
        ),
        store, store,
    )
    engine.start()
    rng = np.random.default_rng(0)
    try:
        for f in range(FILES):
            for p in range(PARTITIONS):
                engine.ingest_rows(make_rows(f, p, rng), timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def budgets(directory) -> dict:
    """Budgets below the data in the smoke's beyond-budget regime: the bank
    budget holds a superbank of 256 columns (one device's first doubling,
    a 2-shard mesh's capacity unit) and a group's headroom, not the next
    doubling, so one budget churns both; the row budget is 36% of the
    stream."""
    store = bs.FileSystemDataStore(str(directory))
    files = store.get_maybe_files_for_query(None)
    groups = [g for mf in files for g in mf.metadata.bank_groups]
    column = 3 * ((groups[0].m_bits + 31) // 32) * 4
    columns = sum(g.num_blocks for g in groups)
    group_bytes = max(g.size for g in groups)
    stream = sum(-(-b.uncompressed_size // 480) * 512
                 for mf in files for b in mf.metadata.data_blocks)
    bank = int(columns * column * 0.9)
    assert 256 * column + group_bytes < bank < columns * column, (columns, column, bank)
    return {"bank_cache_bytes": bank, "row_cache_bytes": int(stream * 0.36)}


def config(pkg, budget: dict, **kw):
    common = dict(
        probe_backend="device", row_data_compression="snappy",
        partition_func=lambda row: row["part"], max_row_group_rows=10_000,
        block_bloom_expected_items=200, row_cache_async_pins=False,
        # One block worker: blocks pin and bump the row cache's LRU in job
        # order, so both engines evict the same blocks.
        max_query_concurrency=1, **budget,
    )
    common.update(kw)
    if pkg is bs:
        return bs.BloomSearchEngineConfig(mesh_devices=1, **common)
    return bt.BloomSearchEngineConfig(device="cpu", **common)


def multiset(rows) -> list[str]:
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


def shapes(m) -> dict:
    """The smoke's query shapes at this scale, then the sweep: every file
    twice, and point lookups of one row in each of eight blocks."""
    q = m.new_query
    out = {
        "token": q().token("needletok").build(),
        "field": q().field("needlefield").build(),
        "field_token": q().field_token("svc", "needlesvc").build(),
        "or_tree": q().match(m.or_(
            m.token("needletok"), m.and_(m.field("needlefield"), m.token("absentword0q")),
            m.field_token("svc", "needlesvc"),
        )).build(),
        "wide_or": q().match(m.or_(m.token("needletok"), *[m.token(a) for a in ABSENT])).build(),
        "partition_common": q().match_prefilter(m.partition(m.partition_equals("p07")))
        .token("w14").build(),
    }
    for rep in range(2):
        for f in range(FILES):
            out[f"sweep{rep}_file{f}"] = q().token(f"file{f}tok").build()
    for j in range(8):
        f, p, i = (3 * j) % FILES, (5 * j + 1) % PARTITIONS, (11 * j) % ROWS
        out[f"point{j}"] = q().token(f"u{f:02x}{p:02x}{i:04x}").build()
    return out


class Churn:
    """Counts, in one package, what beyond-budget serving does: bank
    segments evicted and superbanks compacted (``Superbank.remove`` and
    ``maybe_compact``: nothing is tombstoned here, so every removal is an
    eviction), sparse cold probes (``bloom.probe.probe_rows_sparse``, which
    the engine imports at call time), and row-cache compactions; and, on a
    mesh, whether a bank or the stream evicted while a live placement
    straddled a shard boundary (a mesh's column or chunk shards), and
    whether a compaction laid a placement across one."""

    def __init__(self, monkeypatch, bank, probe, rowcache, shards: int = 1):
        self.counts = {"bank_evictions": 0, "bank_compactions": 0, "sparse_probes": 0,
                       "stream_compactions": 0}
        self.straddled = {"bank_eviction": False, "bank_compaction": False,
                          "stream_eviction": False, "stream_compaction": False}
        self.shards = shards
        remove, compact = bank.Superbank.remove, bank.Superbank.maybe_compact
        sparse = probe.probe_rows_sparse
        rc_remove, rc_compact = rowcache.DeviceRowCache._remove_locked, \
            rowcache.DeviceRowCache._maybe_compact
        churn = self

        def counted_remove(sb, key):
            seg = sb.segments.get(key)
            if seg is not None:
                churn.counts["bank_evictions"] += 1
                churn.note("bank_eviction", sb.segments.values(), sb.capacity)
            return remove(sb, key)

        def counted_compact(sb, force=False):
            dead = sb.dead
            compact(sb, force)
            if dead and not sb.dead:
                churn.counts["bank_compactions"] += 1
                churn.note("bank_compaction", sb.segments.values(), sb.capacity)

        def counted_sparse(*args, **kwargs):
            churn.counts["sparse_probes"] += 1
            return sparse(*args, **kwargs)

        def counted_rc_remove(cache, key):
            seg = cache._bucket.segments.get(key)
            if seg is not None:
                churn.note("stream_eviction", cache._bucket.segments.values(),
                           cache._bucket.cap)
            return rc_remove(cache, key)

        def counted_rc_compact(cache, force=False):
            version = cache._bucket.version
            rc_compact(cache, force)
            if cache._bucket.version != version:
                churn.counts["stream_compactions"] += 1
                churn.note("stream_compaction", cache._bucket.segments.values(),
                           cache._bucket.cap)

        monkeypatch.setattr(bank.Superbank, "remove", counted_remove)
        monkeypatch.setattr(bank.Superbank, "maybe_compact", counted_compact)
        monkeypatch.setattr(probe, "probe_rows_sparse", counted_sparse)
        monkeypatch.setattr(rowcache.DeviceRowCache, "_remove_locked", counted_rc_remove)
        monkeypatch.setattr(rowcache.DeviceRowCache, "_maybe_compact", counted_rc_compact)

    def note(self, what: str, segments, capacity: int) -> None:
        if self.shards < 2 or not capacity:
            return
        width = capacity // self.shards
        if any(n and start // width != (start + n - 1) // width for start, n in segments):
            self.straddled[what] = True


def replay_reference_warm_probe(engine, store) -> None:
    """The JAX engine's warmup ends with its warm-shape probe passes over
    the first file's group (XLA compiles, which the port drops by design):
    they make that group resident again and the most recently used. One
    probe of that group gives the port's engine the same residency."""
    from bloomsearch_tpu_torch.bloom.probe import compile_bloom_terms
    from bloomsearch_tpu_torch.file_format import read_bank_group

    mf = store.get_maybe_files_for_query(None)[0]
    group = mf.metadata.bank_groups[0]

    def load():
        with store.open_file(mf.pointer) as fh:
            return read_bank_group(fh, group)

    terms = compile_bloom_terms(bt.new_query().token("\x00warm\x00").build().bloom)
    engine._device_backend.probe_groups(
        [(mf.pointer, 0, (group.m_bits, group.k, group.params.layout), load)],
        terms, reduce_and=True)


def settle(engine) -> None:
    """Wait for the background bank warms a query scheduled."""
    deadline = time.monotonic() + TIMEOUT
    while True:
        with engine._warm_lock:
            if not engine._warming:
                return
        assert time.monotonic() < deadline, "background bank warms did not finish"
        time.sleep(0.005)


# stats() counters both packages keep. The launch and request counts are
# compared over the queries only: the JAX warmup also launches its XLA
# warm-shape programs, which the port drops by design. Scan launches are
# not compared: the JAX scan on the CPU (XLA, not its Pallas kernel) takes
# 64 needles a launch, where its kernel and the port's take 8.
SHARED_COUNTERS = ("background_pins_churn_skipped", "bank_warms_churn_skipped",
                   "file_bank_groups", "host_bank_cache_entries")
ROW_CACHE_COUNTERS = ("pinned_blocks", "pins", "evictions", "compactions", "device_bytes",
                      "mesh_devices")
QUERY_COUNTERS = (("device", "probe_launches"), ("device", "probe_requests"),
                  ("row_cache", "scan_requests"))


def serve(pkg_name: str, directory, budget: dict, monkeypatch, shards: int = 1) -> dict:
    """Warm one engine up and run every shape once, settling after each
    -> the rows of each shape, the churn counts and the final stats."""
    pkg, engine_mod, bank, probe, rowcache = PACKAGES[pkg_name]
    monkeypatch.setattr(engine_mod, "SPARSE_BANK_BYTES", 0)
    churn = Churn(monkeypatch, bank, probe, rowcache, shards)
    kw = {"mesh_devices": shards} if pkg is bt else {}
    store = pkg.FileSystemDataStore(str(directory))
    engine = pkg.BloomSearchEngine(config(pkg, budget, **kw), store, store)
    engine.start()
    rows, residency = {}, []
    try:
        engine.warmup(block=True, timeout=120)
        if pkg is bt:
            replay_reference_warm_probe(engine, store)
        warm = dict(churn.counts)
        warm_stats = engine.stats()
        for name, query in shapes(pkg).items():
            rows[name] = multiset(engine.query_sync(query, timeout=TIMEOUT))
            settle(engine)
            backend = engine._device_backend
            with backend._lock:
                residency.append(sorted(
                    (sb.capacity, sb.used, sb.dead) for sb in backend._superbanks.values()))
        stats = engine.stats()
    finally:
        engine.stop(timeout=TIMEOUT)
    stats["queries"] = {f"{part}.{key}": stats[part][key] - warm_stats[part][key]
                        for part, key in QUERY_COUNTERS}
    return {"rows": rows, "warmup": warm, "counts": churn.counts, "stats": stats,
            "straddled": churn.straddled, "residency": residency}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_budget")
    write_dataset(root)
    return root, budgets(root)


@pytest.fixture(scope="module")
def runs(dataset):
    root, budget = dataset
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name in ("jax", "port"):
            out[name] = serve(name, root, budget, mp)
            mp.undo()
        out["mesh"] = serve("port", root, budget, mp, shards=2)
        mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("shape", sorted(shapes(bs)))
def test_rows_match_reference_beyond_budget(runs, shape):
    want = runs["jax"]["rows"][shape]
    assert want, shape
    assert runs["port"]["rows"][shape] == want
    assert runs["mesh"]["rows"][shape] == want


@pytest.mark.parametrize("engine", ["jax", "port", "mesh"])
def test_every_engine_evicted_compacted_and_probed_sparse(runs, engine):
    counts = runs[engine]["counts"]
    stats = runs[engine]["stats"]
    assert counts["bank_evictions"] > 0 and counts["bank_compactions"] > 0, counts
    assert counts["sparse_probes"] > 0, counts
    assert stats["row_cache"]["evictions"] > 0, stats["row_cache"]
    assert stats["row_cache"]["compactions"] > 0, stats["row_cache"]
    assert counts["stream_compactions"] == stats["row_cache"]["compactions"]
    # Churn under queries, not only in warmup: the sweep evicts and
    # compacts after warmup too.
    warm = runs[engine]["warmup"]
    assert counts["bank_evictions"] > warm["bank_evictions"], (warm, counts)
    assert counts["sparse_probes"] > warm["sparse_probes"], (warm, counts)


def test_port_counters_and_residency_agree_with_reference(runs):
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run["counts"] == jax_run["counts"]
    assert port_run["residency"] == jax_run["residency"]
    for key in SHARED_COUNTERS:
        assert port_run["stats"][key] == jax_run["stats"][key], key
    for key in ROW_CACHE_COUNTERS:
        assert port_run["stats"]["row_cache"][key] == jax_run["stats"]["row_cache"][key], key
    assert port_run["stats"]["queries"] == jax_run["stats"]["queries"]
    jax_banks = jax_run["stats"]["device"]["superbanks"]
    port_banks = port_run["stats"]["device"]["superbanks"]
    assert {k: (v["blocks"], v["dead"], v["capacity"]) for k, v in port_banks.items()} == {
        k: (v["blocks"], v["dead"], v["capacity"]) for k, v in jax_banks.items()}


def test_mesh_churn_straddles_the_shard_boundary(runs):
    mesh = runs["mesh"]
    assert mesh["stats"]["device"]["mesh_devices"] == 2
    assert mesh["stats"]["row_cache"]["mesh_devices"] == 2
    assert all(mesh["straddled"].values()), mesh["straddled"]


def test_port_burst_under_churn_matches_reference(dataset, runs, monkeypatch):
    """The smoke's burst at test scale: 12 threads of mixed shapes on the
    port's engine with asynchronous background pins and churn budgets that
    admit within milliseconds, so pins evict and compact the stream and
    warms the superbank while queries scan and probe; every row set must be
    the JAX engine's."""
    import threading

    root, budget = dataset
    monkeypatch.setattr(port_engine, "SPARSE_BANK_BYTES", 0)
    churn = port_engine._ChurnBudget
    monkeypatch.setattr(port_engine, "_ChurnBudget",
                        lambda capacity, frac=0.05, period_s=60.0: churn(capacity, 50 * frac,
                                                                         period_s))
    store = bt.FileSystemDataStore(str(root))
    engine = bt.BloomSearchEngine(
        config(bt, budget, row_cache_async_pins=True, max_query_concurrency=100), store, store)
    engine.start()
    queries = shapes(bt)
    names = sorted(queries)
    wrong: list = []
    try:
        engine.warmup(block=True, timeout=120)
        before = engine.stats()["row_cache"]

        def worker(tid: int) -> None:
            try:
                for i in range(16):
                    name = names[(7 * tid + 3 * i) % len(names)]
                    got = multiset(engine.query_sync(queries[name], timeout=TIMEOUT))
                    if got != runs["jax"]["rows"][name]:
                        wrong.append(name)
            except BaseException as exc:  # reported on the main thread
                wrong.append(repr(exc))

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(12)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # more thread switches inside the caches' sections
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        engine.drain_background_pins(timeout=TIMEOUT)
        settle(engine)
        after = engine.stats()
    finally:
        engine.stop(timeout=TIMEOUT)
    assert not wrong, wrong
    assert after["row_cache"]["evictions"] > before["evictions"]
    assert after["row_cache"]["compactions"] > before["compactions"]
    assert after["background_pin_failures"] == 0


# -- the reference's beyond-budget engine tests, on the port ------------------


def port_engine_on(store, **kw):
    engine = bt.BloomSearchEngine(
        bt.BloomSearchEngineConfig(device="cpu", **kw), store, store)
    engine.start()
    return engine


def port_blocks_store(tmp_path, blocks: int, rows: int, pad: int):
    """``tests/test_warmup.py``'s serving store, written by the port: a
    file a block, ``blk{b}tok`` in every row of block b."""
    store = bt.FileSystemDataStore(str(tmp_path / "data"))
    engine = port_engine_on(store, probe_backend="host")
    filler = "x" * pad
    try:
        for b in range(blocks):
            engine.ingest_rows(
                [{"b": b, "n": i, "w": f"blk{b}tok filler {i}", "p": filler}
                 for i in range(rows)], timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)
    return store


def test_beyond_budget_serving_evicts_in_place(tmp_path):
    """The stream beyond ``row_cache_bytes``: pins stop at the reservation,
    queries pin on demand with LRU evict-in-place, the stream's shape never
    moves, and every result stays exact."""
    # ~8 blocks x ~90 KB: the 300 KB budget reserves 512 chunks (256 KB)
    # and holds ~3 blocks at a time.
    store = port_blocks_store(tmp_path, blocks=8, rows=400, pad=180)
    engine = port_engine_on(store, probe_backend="device", row_cache_bytes=300 << 10)
    try:
        engine.warmup(block=True, timeout=120)
        rc = engine._row_cache
        cap0 = rc._bucket.cap
        assert rc._reserved_cap == cap0
        assert len(rc._blocks) < 8  # the budget cannot hold every block
        for _ in range(2):
            for b in range(8):
                res = engine.query_sync(bt.new_query().token(f"blk{b}tok").build(),
                                        timeout=TIMEOUT)
                assert len(res) == 400 and all(r["b"] == b for r in res)
        assert rc._bucket.cap == cap0  # the shape never moved
        assert rc.stats()["device_bytes"] == cap0 * 512
    finally:
        engine.stop(timeout=TIMEOUT)


def port_files_store(tmp_path, files: int, rows: int):
    """``TestWarmupBankBudget``'s store: a file per flush, ``file{f}tok``
    in every row of file f."""
    store = bt.FileSystemDataStore(str(tmp_path / "data"))
    engine = port_engine_on(store, probe_backend="host")
    try:
        for f in range(files):
            engine.ingest_rows(
                [{"f": f, "n": i, "w": f"file{f}tok {i}"} for i in range(rows)],
                timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)
    total = sum(g.size for mf in store.get_maybe_files_for_query(None)
                for g in mf.metadata.bank_groups)
    return store, total


def assert_each_file(engine, files: int, rows: int) -> None:
    for f in range(files):
        res = engine.query_sync(bt.new_query().token(f"file{f}tok").build(), timeout=TIMEOUT)
        assert len(res) == rows and all(r["f"] == f for r in res)


def test_device_warmup_stops_at_bank_budget(tmp_path):
    """Warmup loads bank groups only up to ``bank_cache_bytes``; sparse
    cold probes serve the rest, exactly."""
    store, total = port_files_store(tmp_path, files=5, rows=300)
    engine = port_engine_on(store, probe_backend="device",
                            bank_cache_bytes=max(total // 3, 1))
    try:
        engine.warmup(block=True, timeout=120)
        assert engine._warmup_timeline.get("bank_budget_hit") is True
        assert len(engine._device_backend._by_file) < 5
        assert_each_file(engine, 5, 300)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_probe_overflow_degrades_to_host_not_churn_error(tmp_path):
    """One query whose bank groups exceed the device cache is served by
    budget admission and the host probe, never by a churn error."""
    store, total = port_files_store(tmp_path, files=6, rows=200)
    engine = port_engine_on(store, probe_backend="device",
                            bank_cache_bytes=max(total // 4, 1))
    try:
        assert_each_file(engine, 6, 200)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_device_warmup_stops_on_cumulative_load_despite_plateau(tmp_path):
    """Superbank capacity plateaus once eviction recycles columns, so the
    cumulative loaded bytes, not ``total_bytes()``, must stop warmup."""
    store, total = port_files_store(tmp_path, files=6, rows=200)
    engine = port_engine_on(store, probe_backend="device",
                            bank_cache_bytes=max(total // 3, 1))
    try:
        # The plateau: total_bytes() reports an empty cache throughout.
        engine._device_backend.total_bytes = lambda: 0
        engine.warmup(block=True, timeout=120)
        assert engine._warmup_timeline.get("bank_budget_hit") is True
        assert len(engine._device_backend._by_file) < 6
        assert_each_file(engine, 6, 200)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_host_warmup_stops_at_bank_budget(tmp_path):
    store, total = port_files_store(tmp_path, files=5, rows=300)
    engine = port_engine_on(store, probe_backend="host",
                            bank_cache_bytes=max(total // 3, 1))
    try:
        engine.warmup(block=True, timeout=120)
        assert engine._warmup_timeline.get("bank_budget_hit") is True
        assert engine._host_bank_bytes <= engine.config.bank_cache_bytes
        assert_each_file(engine, 5, 300)
    finally:
        engine.stop(timeout=TIMEOUT)


# -- tests/test_sparse_probe.py's engine cases ---------------------------------


def sparse_engine(tmp_path, monkeypatch, **overrides):
    # Every test-sized bank group takes the sparse path.
    monkeypatch.setattr(port_engine, "SPARSE_BANK_BYTES", 0)
    store = bt.FileSystemDataStore(str(tmp_path / "data"))
    return port_engine_on(store, row_data_compression="none", **overrides), store


def invalidate_all(engine, store) -> None:
    """Drop what flush warmed, so the first probe is cold."""
    for mf in store.get_maybe_files_for_query(None):
        engine._device_backend.invalidate(mf.pointer)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_cold_sparse_query_exact_then_resident(tmp_path, monkeypatch, backend):
    engine, store = sparse_engine(tmp_path, monkeypatch, probe_backend=backend)
    try:
        engine.ingest_rows([{"n": i, "w": f"word{i}", "tag": "all"} for i in range(200)],
                           timeout=TIMEOUT)
        engine.flush(timeout=TIMEOUT)
        if backend == "device":
            invalidate_all(engine, store)
        got = engine.query_sync(bt.new_query().token("word42").build(), timeout=TIMEOUT)
        assert got == [{"n": 42, "w": "word42", "tag": "all"}]
        got = engine.query_sync(bt.new_query().match(
            bt.or_(bt.token("word7"), bt.field_token("w", "word9"))).build(), timeout=TIMEOUT)
        assert sorted(r["n"] for r in got) == [7, 9]

        # The background warm lands and the bank becomes resident.
        def resident():
            if backend == "host":
                return len(engine._host_bank_cache) > 0
            return any(sb.segments for sb in engine._device_backend._superbanks.values())

        deadline = time.monotonic() + TIMEOUT
        while not resident():
            assert time.monotonic() < deadline, "bank never warmed"
            time.sleep(0.05)
        got = engine.query_sync(bt.new_query().token("all").build(), timeout=TIMEOUT)
        assert len(got) == 200
    finally:
        engine.stop(timeout=TIMEOUT)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_corrupt_bank_never_false_negative_on_cold_query(tmp_path, monkeypatch, backend):
    """Bit rot in the bank section never drops rows on the first (cold,
    sparse) query: it raises, or the rows are exact."""
    from bloomsearch_tpu_torch.file_format import InvalidHashError

    engine, store = sparse_engine(tmp_path, monkeypatch, probe_backend=backend)
    try:
        engine.ingest_rows([{"n": i, "w": f"word{i}"} for i in range(300)], timeout=TIMEOUT)
        engine.flush(timeout=TIMEOUT)
        mf = store.get_maybe_files_for_query(None)[0]
        group = mf.metadata.bank_groups[0]
        # Zero the whole bank region and its row CRCs: unverified, every
        # probe would read 0 bits and skip every block.
        with open(mf.pointer.decode(), "r+b") as fh:
            fh.seek(group.offset)
            fh.write(b"\x00" * group.size)
        store._metadata_cache.clear()
        if backend == "device":
            engine._device_backend.invalidate(mf.pointer)
        try:
            got = engine.query_sync(bt.new_query().token("word42").build(), timeout=TIMEOUT)
        except InvalidHashError:
            pass  # a loud failure
        else:
            assert got == [{"n": 42, "w": "word42"}], got
    finally:
        engine.stop(timeout=TIMEOUT)


def test_old_file_without_row_crcs_takes_full_verified_read(tmp_path, monkeypatch):
    engine, store = sparse_engine(tmp_path, monkeypatch, probe_backend="host")
    try:
        engine.ingest_rows([{"n": i, "w": f"word{i}"} for i in range(100)], timeout=TIMEOUT)
        engine.flush(timeout=TIMEOUT)
        # An old file: no row-CRC pointer in the metadata the engine plans on.
        for mf in store.get_maybe_files_for_query(None):
            for g in mf.metadata.bank_groups:
                g.row_crc_offset = None
        got = engine.query_sync(bt.new_query().token("word7").build(), timeout=TIMEOUT)
        assert got == [{"n": 7, "w": "word7"}]
        assert len(engine._host_bank_cache) > 0  # the full read, no sparse path
    finally:
        engine.stop(timeout=TIMEOUT)


def test_corrupt_bank_surfaces_in_background_warm(tmp_path, monkeypatch, caplog):
    engine, store = sparse_engine(tmp_path, monkeypatch, probe_backend="host")
    try:
        engine.ingest_rows([{"w": "hello"}], timeout=TIMEOUT)
        engine.flush(timeout=TIMEOUT)
        mf = store.get_maybe_files_for_query(None)[0]
        group = mf.metadata.bank_groups[0]
        with open(mf.pointer.decode(), "r+b") as fh:  # flip a bank byte
            fh.seek(group.offset)
            b = fh.read(1)
            fh.seek(group.offset)
            fh.write(bytes([b[0] ^ 0xFF]))
        store._metadata_cache.clear()
        with caplog.at_level(logging.ERROR, logger="bloomsearch_tpu_torch.engine"):
            engine.query_sync(bt.new_query().token("hello").build(), timeout=TIMEOUT)
            deadline = time.monotonic() + TIMEOUT
            while not any("bank warm failed" in r.message for r in caplog.records):
                assert time.monotonic() < deadline, "corruption never surfaced"
                time.sleep(0.05)
    finally:
        engine.stop(timeout=TIMEOUT)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_many_files_cold_exact(tmp_path, monkeypatch, backend):
    """Sparse cold probes of many files fan over the I/O pool and return
    the serial path's rows."""
    engine, store = sparse_engine(tmp_path, monkeypatch, probe_backend=backend)
    try:
        for f in range(8):
            engine.ingest_rows([{"n": f * 100 + i, "w": f"word{f}_{i}", "tag": "all"}
                                for i in range(50)], timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
        assert len(store.get_maybe_files_for_query(None)) == 8
        if backend == "device":
            invalidate_all(engine, store)
        got = engine.query_sync(bt.new_query().token("word5_7").build(), timeout=TIMEOUT)
        assert got == [{"n": 507, "w": "word5_7", "tag": "all"}]
        got = engine.query_sync(bt.new_query().token("all").build(), timeout=TIMEOUT)
        assert sorted(r["n"] for r in got) == sorted(
            f * 100 + i for f in range(8) for i in range(50))
    finally:
        engine.stop(timeout=TIMEOUT)


def test_pool_shutdown_with_engine_stop(tmp_path, monkeypatch):
    engine, _ = sparse_engine(tmp_path, monkeypatch, probe_backend="host")
    pool = engine._sparse_probe_pool
    engine.stop(timeout=TIMEOUT)
    with pytest.raises(RuntimeError):
        pool.submit(lambda: None)

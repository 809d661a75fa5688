"""The write side under a serving engine: the port's engine against the JAX one.

A base dataset written by the JAX package, in the refscale dataset's layout
(files of 10 partitions, a block each, so bank groups of 10 columns), is
opened by the JAX engine (its device backend on CPU JAX, ``mesh_devices=1``),
the port's engine on ``device="cpu"`` and the port's engine on a 2-shard CPU
mesh, each in serving mode with a restart sidecar and the needle cache at
its default (on). Each engine, in its own copy of the directory, takes the
same sequence: ``warmup()``; batches through ``ingest_serialized`` with a
``partition_id``, each round flushed, so warm-on-flush inserts grow the
superbank past one 128-column unit; the query set; a merge whose
``ttl_predicate`` expires one partition; the query set; a second merge; a
stop and a restart from the sidecar; the query set. After every step the row
sets and the ``stats()`` counters both packages keep must agree.

The rest of the file holds the port's counterparts of the reference's
concurrency tests (``tests/test_chaos.py`` and
``tests/test_merge_query_race.py``) on the port's device backend, the
warm-on-flush checks, and the tests of late background work for a file
that a merge has tombstoned.
"""

import json
import os
import queue
import shutil
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402

TIMEOUT = 60.0
FILES = 12
PARTITIONS = 10  # one block a partition a file, as refscale
ROWS = 30
PAD_BYTES = 200
LIVE_ROUNDS = 2  # flushed files of 10 blocks: 120 + 20 columns, past 128
LIVE_ROWS = 12  # rows a partition a round
EXPIRED = "p00"
MESH_SHARDS = 2


def base_rows(f: int, p: int, rng) -> list[dict]:
    rows = []
    for i in range(ROWS):
        row = {"uid": f"b{f:02x}{p:02x}{i:04x}", "part": f"p{p:02d}",
               "msg": f"w{(i * 7 + p) % 20} file{f}tok", "pad": rng.bytes(PAD_BYTES // 2).hex()}
        if i == 3 and f % 4 == 1:
            row["msg"] += " needletok"
        rows.append(row)
    return rows


def live_batch(round_: int, p: int) -> list[bytes]:
    """One partition's serialized rows of an ingest round."""
    out = []
    for i in range(LIVE_ROWS):
        row = {"uid": f"l{round_:02x}{p:02x}{i:04x}", "part": f"p{p:02d}",
               "msg": f"w{(i * 3 + p) % 20} live{round_}tok" + (" needletok" if i == 5 else "")}
        out.append(json.dumps(row, separators=(",", ":")).encode())
    return out


def write_base(directory) -> None:
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
                engine.ingest_rows(base_rows(f, p, rng), timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def serving_config(pkg, directory, **kw):
    common = dict(
        probe_backend="device", row_data_compression="snappy",
        partition_func=lambda row: row["part"], max_row_group_rows=10_000,
        block_bloom_expected_items=200, row_cache_bytes=64 << 20,
        serving_cache_dir=str(directory) + "-sidecar", row_cache_async_pins=False,
        max_query_concurrency=1, max_buffered_rows=100_000, max_buffered_bytes=64 << 20,
        max_buffered_time=3600.0,
        ttl_predicate=pkg.prefilter_expiry(pkg.partition(pkg.partition_equals(EXPIRED))),
    )
    common.update(kw)
    if pkg is bs:
        common.setdefault("mesh_devices", 1)
        return bs.BloomSearchEngineConfig(**common)
    return bt.BloomSearchEngineConfig(device="cpu", **common)


def multiset(rows) -> list[str]:
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


def queries(m) -> dict:
    q = m.new_query
    return {
        "needle": q().token("needletok").build(),
        "live0": q().token("live0tok").build(),
        "live1": q().token("live1tok").build(),
        "base_file": q().token("file5tok").build(),
        "expired_part": q().match_prefilter(m.partition(m.partition_equals(EXPIRED)))
        .token("w4").build(),
        "kept_part": q().match_prefilter(m.partition(m.partition_equals("p03")))
        .token("w3").build(),
        "base_uid": q().token("b0703000b").build(),
        "live_uid": q().token("l01040007").build(),
        "or_tree": q().match(m.or_(m.token("needletok"),
                                   m.and_(m.field("msg"), m.token("absentword0q")))).build(),
    }


def counters(engine) -> dict:
    """The residency both packages keep: each superbank's capacity, used
    and dead columns and resident groups; the stream's used and dead chunks
    and pinned blocks."""
    backend = engine._device_backend
    with backend._lock:
        banks = sorted((sb.capacity, sb.used, sb.dead, len(sb.segments))
                       for sb in backend._superbanks.values())
    cache = engine._row_cache
    with cache._lock:
        stream = (cache._bucket.used, cache._bucket.dead, len(cache._blocks))
    return {"superbanks": banks, "stream": stream}


def drive(pkg, directory, **kw) -> list[tuple]:
    """The write sequence on one engine -> [(step, rows of each query,
    counters)] after each step."""
    store = pkg.FileSystemDataStore(str(directory))
    engine = pkg.BloomSearchEngine(serving_config(pkg, directory, **kw), store, store)
    engine.start()
    steps = []

    def record(step: str, run_queries: bool = True) -> None:
        rows = ({name: multiset(engine.query_sync(query, timeout=TIMEOUT))
                 for name, query in queries(pkg).items()} if run_queries else {})
        steps.append((step, rows, counters(engine)))

    try:
        engine.warmup(block=True, timeout=120)
        record("warmup", run_queries=False)
        for r in range(LIVE_ROUNDS):
            for p in range(PARTITIONS):
                engine.ingest_serialized(live_batch(r, p), timeout=TIMEOUT,
                                         partition_id=f"p{p:02d}")
            engine.flush(timeout=TIMEOUT)
            record(f"flush{r}", run_queries=False)
        record("ingested")
        engine.merge()
        record("merge")
        engine.merge()
        record("merge2")
    finally:
        engine.stop(timeout=TIMEOUT)
    engine = pkg.BloomSearchEngine(serving_config(pkg, directory, **kw), store, store)
    engine.start()
    try:
        engine.warmup(block=True, timeout=120)
        record("restart")
        sidecar = serving_config(pkg, directory).serving_cache_dir
        live = {engine._serving_cache._prefix(mf.pointer)
                for mf in store.get_maybe_files_for_query(None)}
        names = [n for n in os.listdir(sidecar) if n.endswith(".srv")]
        steps.append(("sidecar", {"stale": sorted(n for n in names
                                                  if n.split("-")[0] not in live)},
                      {"entries": len(names)}))
    finally:
        engine.stop(timeout=TIMEOUT)
    return steps


# Each package's engine on one device and on a 2-shard mesh: a stream's
# chunk unit and a superbank's column unit scale with the mesh size, so
# capacities, and the in-place evictions of pins past the stream's
# reservation, are compared between engines of one mesh size.
ENGINES = (("jax", bs, {}), ("jax_mesh", bs, {"mesh_devices": MESH_SHARDS}),
           ("port", bt, {}), ("mesh", bt, {"mesh_devices": MESH_SHARDS}))
PAIRS = (("jax", "port"), ("jax_mesh", "mesh"))
STEPS = ("warmup", "flush0", "flush1", "ingested", "merge", "merge2", "restart")


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_writes")
    write_base(root / "base")
    out = {}
    for name, pkg, kw in ENGINES:
        shutil.copytree(root / "base", root / name)
        out[name] = {step: (rows, c) for step, rows, c in drive(pkg, root / name, **kw)}
    return out


@pytest.mark.parametrize("step", STEPS)
def test_rows_agree_after_each_step(parity, step):
    rows = {name: steps[step][0] for name, steps in parity.items()}
    for name in rows:
        assert rows[name] == rows["jax"], (name, step)
    if rows["jax"]:
        got = {q: len(r) for q, r in rows["jax"].items()}
        merged = step in ("merge", "merge2", "restart")
        # needletok: 3 base rows, one a live round a partition; the merge
        # expires partition p00 (its base and live rows).
        assert got["needle"] == 3 * PARTITIONS - (3 if merged else 0) + 2 * PARTITIONS \
            - (2 if merged else 0)
        assert got["live0"] == got["live1"] == LIVE_ROWS * (PARTITIONS - merged)
        assert got["expired_part"] == (0 if merged else 14)
        assert got["base_uid"] == got["live_uid"] == 1


@pytest.mark.parametrize("step", STEPS)
def test_counters_agree_after_each_step(parity, step):
    """Superbank used and dead columns and resident groups agree across the
    four engines; capacities and the stream's used and dead chunks and
    pinned blocks agree within each mesh size."""
    c = {name: steps[step][1] for name, steps in parity.items()}
    columns = [[(u, d, g) for _, u, d, g in c[name]["superbanks"]] for name in c]
    assert all(col == columns[0] for col in columns), (step, c)
    for ref, port in PAIRS:
        assert c[port] == c[ref], (step, ref, c[ref], port, c[port])


def test_warm_on_flush_grew_past_one_unit(parity):
    """The first flushed round's ten groups landed on 120 resident columns:
    the single-device superbank doubled from 128 to 256 columns before any
    query, and the second round inserted in place."""
    for name in ("jax", "port"):
        assert parity[name]["warmup"][1]["superbanks"] == [(128, 120, 0, FILES)]
        assert parity[name]["flush0"][1]["superbanks"] == [(256, 130, 0, FILES + 1)]
        assert parity[name]["flush1"][1]["superbanks"] == [(256, 140, 0, FILES + 2)]


def test_merges_leave_no_dead_columns_or_chunks(parity):
    """Both merges tombstone every input: its columns and chunks go dead
    and compaction reclaims them (the merged files load on demand)."""
    for name in parity:
        for step in ("merge", "merge2", "restart"):
            (_, _, dead, _), = parity[name][step][1]["superbanks"]
            assert dead == 0 and parity[name][step][1]["stream"][1] == 0, (name, step)


def test_sidecar_holds_no_tombstoned_file(parity):
    for name in parity:
        stale, entries = parity[name]["sidecar"]
        assert stale == {"stale": []} and entries["entries"] > 0, name


# -- concurrency: the reference's chaos and merge-race tests on the port ------

CHAOS_TIMEOUT = 120.0


class Tombstones:
    """Wraps one engine's ``_tombstone_or_defer`` and ``_tombstone_everywhere``:
    counts tombstones applied at once and deferred behind in-flight queries,
    and checks, as each is applied, that none of the file's superbank
    segments or stream blocks is left live."""

    def __init__(self, engine, monkeypatch):
        self.engine = engine
        self.deferred = 0
        self.applied = 0
        self.left_live: list = []
        defer, everywhere = engine._tombstone_or_defer, engine._tombstone_everywhere
        tombstones = self

        def counted_defer(pointer):
            before = len(engine._deferred_tombstones)
            defer(pointer)
            if len(engine._deferred_tombstones) > before:
                tombstones.deferred += 1

        def checked_everywhere(pointer):
            everywhere(pointer)
            tombstones.applied += 1
            live = resident_pointers(engine) & {pointer}
            if live:
                tombstones.left_live.append(pointer)

        monkeypatch.setattr(engine, "_tombstone_or_defer", counted_defer)
        monkeypatch.setattr(engine, "_tombstone_everywhere", checked_everywhere)


def resident_pointers(engine) -> set:
    """Files with a superbank segment or a pinned stream block."""
    out = set()
    backend = engine._device_backend
    if backend is not None:
        with backend._lock:
            out |= set(backend._by_file)
    cache = engine._row_cache
    if cache is not None:
        with cache._lock:
            out |= {key[0] for key in cache._blocks}
    return out


def gate_merges(engine, monkeypatch):
    """-> a lock that every ``merge()`` of the engine (the background merge
    loop's too) holds while it runs: holding it quiesces merging."""
    import threading

    gate = threading.Lock()
    merge = engine.merge

    def gated():
        with gate:
            return merge()

    monkeypatch.setattr(engine, "merge", gated)
    return gate


def assert_no_stale_residency(engine, meta_store, gate) -> None:
    """With merges held off and no query in flight, every resident segment
    and pinned block belongs to a published file: nothing a tombstone
    removed came back."""
    with gate:
        # A query's caller has its rows before the query applies the
        # tombstones it drained: wait for every query to finish that too.
        with engine._queries_drained:
            assert engine._queries_drained.wait_for(
                lambda: not engine._active_query_ids, CHAOS_TIMEOUT)
        engine.drain_background_pins(timeout=CHAOS_TIMEOUT)
        assert not engine._deferred_tombstones
        live = {mf.pointer for mf in meta_store.get_maybe_files_for_query(None)}
        stale = resident_pointers(engine) - live
    assert not stale, stale


class Ingested:
    """Rows whose ``done`` future resolved, with the time it resolved."""

    def __init__(self):
        self.durable: dict[int, float] = {}

    def ingest(self, engine, batch: list[dict], key) -> None:
        import concurrent.futures
        import time

        done = concurrent.futures.Future()
        engine.ingest_rows(batch, done=done, timeout=CHAOS_TIMEOUT)

        def resolved(fut, ns=[r[key] for r in batch if key in r]):
            if fut.exception() is None:
                t = time.monotonic()
                for n in ns:
                    self.durable[n] = t

        done.add_done_callback(resolved)


def checked_query(engine, query, want, ingested: Ingested, errors: list,
                  atomic: bool = True) -> None:
    """One query: every row matches (``want``); when the MetaStore publishes
    a merge atomically (``atomic``), no row comes twice and every matching
    row whose ``done`` resolved before the query started is there. (A
    ``FileSystemDataStore`` serving as its own MetaStore is not atomic, as
    its docstring says: a merged file shows before its inputs leave, and a
    listing can miss both, so a query may see a merge's rows twice or not
    at all.)"""
    import queue
    import time

    started = time.monotonic()
    result_q: queue.Queue = queue.Queue()
    error_q: queue.Queue = queue.Queue()
    engine.query(query, result_q, error_q)
    rows = []
    while (item := result_q.get(timeout=CHAOS_TIMEOUT)) is not None:
        rows.append(item)
    if not error_q.empty():
        errors.append(error_q.get_nowait())
        return
    ns = [r["n"] for r in rows]
    if atomic and len(ns) != len(set(ns)):
        errors.append(AssertionError(f"a row twice: {sorted(ns)}"))
    durable = {n for n, t in list(ingested.durable.items()) if t < started and want(n)}
    if atomic and not durable <= set(ns):
        errors.append(AssertionError(f"durable rows missing: {sorted(durable - set(ns))}"))
    if not all(want(n) for n in ns):
        errors.append(AssertionError("a row that does not match"))


def run_threads(threads) -> None:
    for t in threads:
        t.start()
    for t in threads:
        t.join(CHAOS_TIMEOUT)
        assert not t.is_alive(), "chaos thread deadlocked"


@pytest.mark.parametrize("store_kind", ["fs", "object"])
def test_concurrent_ingest_query_merge(tmp_path, monkeypatch, store_kind):
    """``tests/test_chaos.py::test_concurrent_ingest_query_merge`` on the
    port's device backend (on the CPU)."""
    import random
    import threading

    if store_kind == "fs":
        meta_store = data_store = bt.FileSystemDataStore(str(tmp_path / "data"))
    else:
        client = bt.InMemoryObjectStore()
        meta_store = bt.ObjectStoreMetaStore(client)
        data_store = bt.ObjectStoreDataStore(client)
    config = bt.BloomSearchEngineConfig(
        row_data_compression="snappy", probe_backend="device", device="cpu",
        max_buffered_rows=200, merge_interval_seconds=0.1,
    )
    engine = bt.BloomSearchEngine(config, meta_store, data_store)
    tombstones = Tombstones(engine, monkeypatch)
    gate = gate_merges(engine, monkeypatch)
    engine.start()
    errors: list[BaseException] = []
    ingested = Ingested()
    total_rows = 3000
    try:
        def ingester():
            try:
                for i in range(0, total_rows, 100):
                    ingested.ingest(engine, [{"n": i + j, "w": f"w{(i + j) % 97}", "tag": "chaos"}
                                             for j in range(100)], "n")
            except BaseException as exc:
                errors.append(exc)

        def querier(seed):
            rng = random.Random(seed)
            try:
                for _ in range(25):
                    k = rng.randrange(97)
                    checked_query(engine, bt.new_query().token(f"w{k}").build(),
                                  lambda n, k=k: n % 97 == k, ingested, errors,
                                  atomic=store_kind == "object")
            except BaseException as exc:
                errors.append(exc)

        run_threads([threading.Thread(target=ingester, daemon=True)] + [
            threading.Thread(target=querier, args=(s,), daemon=True) for s in (2, 3, 4)])
        assert not errors, f"chaos errors: {errors[:3]}"

        engine.flush(timeout=CHAOS_TIMEOUT)
        rows = engine.query_sync(bt.new_query().token("chaos").build(), timeout=CHAOS_TIMEOUT)
        assert sorted(r["n"] for r in rows) == list(range(total_rows))
        engine.merge()
        assert_no_stale_residency(engine, meta_store, gate)
        assert tombstones.applied > 0 and not tombstones.left_live
    finally:
        engine.stop(timeout=CHAOS_TIMEOUT)


@pytest.mark.parametrize("meta_kind", ["fs", "memory"])
def test_kitchen_sink_chaos(tmp_path, monkeypatch, meta_kind):
    """``tests/test_chaos.py::test_kitchen_sink_chaos`` on the port: the
    device backend on an 8-shard CPU mesh (the reference's size), the
    serving row cache, auto block sizing, background merge, sparse cold
    probes (forced), a TTL predicate, concurrent ingest and queries. The
    reference's store serves as its own MetaStore (``fs``); with a
    ``MemoryMetaStore`` in front of it (``memory``) merges publish
    atomically, so every query is held to exactly its durable rows."""
    import threading

    import bloomsearch_tpu_torch.engine as eng_mod

    store = meta_store = bt.FileSystemDataStore(str(tmp_path / "data"))
    if meta_kind == "memory":
        meta_store = bt.MemoryMetaStore()
    config = bt.BloomSearchEngineConfig(
        row_data_compression="snappy", probe_backend="device", device="cpu",
        mesh_devices=8, row_cache_bytes=256 << 20, block_bloom_expected_items="auto",
        max_buffered_rows=300, merge_interval_seconds=0.1,
        ttl_predicate=bt.prefilter_expiry(bt.partition(bt.partition_equals("expired"))),
        partition_func=lambda r: r.get("part", ""),
    )
    engine = bt.BloomSearchEngine(config, meta_store, store)
    monkeypatch.setattr(eng_mod, "SPARSE_BANK_BYTES", 0)
    tombstones = Tombstones(engine, monkeypatch)
    gate = gate_merges(engine, monkeypatch)
    engine.start()
    errors: list[BaseException] = []
    ingested = Ingested()
    total_rows = 1500
    try:
        def ingester():
            try:
                for i in range(0, total_rows, 100):
                    batch = [{"n": i + j, "w": f"w{(i + j) % 53}", "tag": "live", "part": "keep"}
                             for j in range(100)]
                    batch.append({"junk": i, "part": "expired", "tag": "doomed"})
                    ingested.ingest(engine, batch, "n")
            except BaseException as exc:
                errors.append(exc)

        def querier(seed):
            import random

            rng = random.Random(seed)
            try:
                for _ in range(15):
                    k = rng.randrange(53)
                    checked_query(engine, bt.new_query().token(f"w{k}").build(),
                                  lambda n, k=k: n % 53 == k, ingested, errors,
                                  atomic=meta_kind == "memory")
            except BaseException as exc:
                errors.append(exc)

        run_threads([threading.Thread(target=ingester, daemon=True)] + [
            threading.Thread(target=querier, args=(s,), daemon=True) for s in (1, 2, 3)])
        assert not errors, f"chaos errors: {errors[:3]}"

        engine.flush(timeout=CHAOS_TIMEOUT)
        rows = engine.query_sync(bt.new_query().token("live").build(), timeout=CHAOS_TIMEOUT)
        assert sorted(r["n"] for r in rows) == list(range(total_rows))
        engine.merge()
        doomed = engine.query_sync(bt.new_query().token("doomed").build(), timeout=CHAOS_TIMEOUT)
        assert doomed == []
        assert_no_stale_residency(engine, meta_store, gate)
        assert tombstones.applied > 0 and not tombstones.left_live
        assert engine.stats()["background_pin_failures"] == 0
        # The mesh really is under the superbanks and the stream (a
        # superbank whose only loads were refused holds no tensor).
        banks = [sb.bank2d for sb in engine._device_backend._superbanks.values()
                 if sb.capacity]
        assert banks and all(isinstance(b, tuple) and len(b) == 8 for b in banks)
        assert engine._row_cache.mesh.size == 8
    finally:
        engine.stop(timeout=CHAOS_TIMEOUT)


RACE_TIMEOUT = 15.0


class HeldOpenStore(bt.FileSystemDataStore):
    """Holds every file open made off the test's own thread (a query's
    block reads) while ``hold`` is clear, so a merge on the test's thread
    lands mid-query; ``held`` is set once a read waits."""

    def __init__(self, root):
        import threading

        super().__init__(root)
        self.hold = threading.Event()
        self.hold.set()
        self.held = threading.Event()

    def open_file(self, pointer):
        import threading

        if threading.current_thread() is not threading.main_thread() and \
                not self.hold.is_set():
            self.held.set()
            self.hold.wait(RACE_TIMEOUT)
        return super().open_file(pointer)


def race_engine(store, **kw):
    """The port's serving engine on the CPU, one block worker: a query's
    block reads (and the pins they make) run one after another."""
    config = bt.BloomSearchEngineConfig(
        row_data_compression="none", probe_backend="device", device="cpu",
        max_query_concurrency=1, row_cache_bytes=8 << 20, row_cache_async_pins=False, **kw)
    engine = bt.BloomSearchEngine(config, store, store)
    engine.start()
    return engine


def four_files(engine) -> list[bytes]:
    for i in range(4):
        engine.ingest_rows([{"n": i, "tag": "common"}], timeout=RACE_TIMEOUT)
        engine.flush(timeout=RACE_TIMEOUT)
    return [mf.pointer for mf in engine.meta_store.get_maybe_files_for_query(None)]


def drain_rows(result_q) -> list:
    rows = []
    while (item := result_q.get(timeout=RACE_TIMEOUT)) is not None:
        rows.append(item)
    return rows


def assert_dead_on_the_device(engine, pointers) -> None:
    """None of ``pointers`` has a superbank segment or a pinned block, and
    the superbank's and the stream's live counts are the live files' own."""
    assert not resident_pointers(engine) & set(pointers)
    backend, cache = engine._device_backend, engine._row_cache
    with backend._lock:
        live_cols = sum(n for segs in backend._by_file.values() for mk, key in segs
                        for n in [backend._superbanks[mk].segments[key][1]])
        assert live_cols == sum(sb.used - sb.dead for sb in backend._superbanks.values())
    with cache._lock:
        live_chunks = sum(cache._bucket.segments[key][1] for key in cache._blocks)
        assert live_chunks == cache._bucket.used - cache._bucket.dead


def test_query_survives_concurrent_merge(tmp_path, monkeypatch):
    """``tests/test_merge_query_race.py::TestMergeDuringQuery`` on the
    port's serving engine: the merge's tombstones defer behind the query in
    flight, which still gets exactly the rows it planned; when it drains,
    the replaced files' superbank columns and stream chunks are dead."""
    store = HeldOpenStore(str(tmp_path / "data"))
    engine = race_engine(store)
    tombstones = Tombstones(engine, monkeypatch)
    try:
        inputs = four_files(engine)
        assert resident_pointers(engine) == set(inputs)  # warmed on flush

        store.hold.clear()
        result_q: queue.Queue = queue.Queue()
        error_q: queue.Queue = queue.Queue()
        engine.query(bt.new_query().token("common").build(), result_q, error_q)
        assert store.held.wait(RACE_TIMEOUT)  # the query is mid-flight
        stats = engine.merge()  # tombstones must defer, not unlink
        assert stats.files_processed == 4
        assert engine._deferred_tombstones, "merge did not defer: query already drained"
        assert tombstones.deferred == 4 and tombstones.applied == 0
        assert engine.stats()["deferred_tombstones"] == 4
        assert any(name.endswith(".tombstoned") for name in os.listdir(store.root_dir))

        store.hold.set()
        rows = drain_rows(result_q)
        assert error_q.empty(), f"worker errored: {error_q.get_nowait()}"
        assert sorted(r["n"] for r in rows) == [0, 1, 2, 3]

        with engine._queries_drained:
            assert engine._queries_drained.wait_for(
                lambda: not engine._active_query_ids, RACE_TIMEOUT)
        assert tombstones.applied == 4 and not tombstones.left_live
        assert_dead_on_the_device(engine, inputs)
        assert len(store.get_maybe_files_for_query(None)) == 1
        dat_files = [f for f in os.listdir(store.root_dir) if f.endswith(".dat")]
        assert len(dat_files) == 1, f"old files not tombstoned: {dat_files}"

        rows = engine.query_sync(bt.new_query().token("common").build(), timeout=RACE_TIMEOUT)
        assert len(rows) == 4
        assert_dead_on_the_device(engine, inputs)
    finally:
        engine.stop(timeout=RACE_TIMEOUT)


def test_stop_waits_for_inflight_query_before_tombstoning(tmp_path, monkeypatch):
    """``TestStopDuringQuery.test_stop_waits_for_inflight_query_before_
    tombstoning`` on the port's serving engine."""
    import threading

    store = HeldOpenStore(str(tmp_path / "data"))
    engine = race_engine(store)
    tombstones = Tombstones(engine, monkeypatch)
    inputs = four_files(engine)

    store.hold.clear()
    result_q: queue.Queue = queue.Queue()
    error_q: queue.Queue = queue.Queue()
    engine.query(bt.new_query().token("common").build(), result_q, error_q)
    assert store.held.wait(RACE_TIMEOUT)  # the query is mid-flight
    engine.merge()  # tombstones defer behind the query
    assert engine._deferred_tombstones and tombstones.deferred == 4

    stopped = threading.Event()
    dead_at_stop: list = []

    def do_stop():
        release = engine._row_cache.release

        def checked_release():
            # The queries drained and the tombstones applied before stop()
            # drops the device state: check it then.
            dead_at_stop.append(not resident_pointers(engine) & set(inputs))
            release()

        engine._row_cache.release = checked_release
        engine.stop(timeout=RACE_TIMEOUT)
        stopped.set()

    stopper = threading.Thread(target=do_stop, daemon=True)
    stopper.start()
    time.sleep(0.1)
    assert not stopped.is_set(), "stop returned while a query was in flight"

    store.hold.set()
    rows = drain_rows(result_q)
    assert error_q.empty(), f"worker errored: {error_q.get_nowait()}"
    assert sorted(r["n"] for r in rows) == [0, 1, 2, 3]

    assert stopped.wait(RACE_TIMEOUT)
    leftovers = [f for f in os.listdir(store.root_dir) if f.endswith(".tombstoned")]
    assert not leftovers, f"deferred tombstones not applied at stop: {leftovers}"
    assert tombstones.applied == 4 and not tombstones.left_live
    assert dead_at_stop == [True]


def test_stop_timeout_with_stuck_query_raises(tmp_path):
    """``TestStopDuringQuery.test_stop_timeout_with_stuck_query_raises`` on
    the port's serving engine."""
    import threading

    store = HeldOpenStore(str(tmp_path / "data"))
    engine = race_engine(store)
    engine.ingest_rows([{"n": 1, "tag": "x"}], timeout=RACE_TIMEOUT)
    engine.flush(timeout=RACE_TIMEOUT)

    release = threading.Event()
    orig_open = store.open_file

    def blocking_open(pointer):
        release.wait(RACE_TIMEOUT)
        return orig_open(pointer)

    store.open_file = blocking_open
    result_q: queue.Queue = queue.Queue()
    engine.query(bt.new_query().token("x").build(), result_q)
    time.sleep(0.1)
    try:
        with pytest.raises(TimeoutError):
            engine.stop(timeout=0.3)
    finally:
        release.set()
    assert [r["n"] for r in drain_rows(result_q)] == [1]
    engine.stop(timeout=RACE_TIMEOUT)


# -- warm-on-flush ----------------------------------------------------------

WARM_LOG = "bank warm-on-flush failed (queries will reload)"


def flush_engine(pkg, directory, **kw):
    store = pkg.FileSystemDataStore(str(directory))
    common = dict(row_data_compression="snappy", probe_backend="device",
                  block_bloom_expected_items=200, partition_func=lambda r: r["part"], **kw)
    if pkg is bs:
        config = bs.BloomSearchEngineConfig(mesh_devices=1, **common)
    else:
        config = bt.BloomSearchEngineConfig(device="cpu", **common)
    engine = pkg.BloomSearchEngine(config, store, store)
    engine.start()
    return engine, store


def flush_rows(f: int) -> list[dict]:
    return [{"n": 100 * f + i, "part": f"p{i % 3}", "msg": f"w{i % 5} flush{f}tok"}
            for i in range(30)]


def test_flush_warms_the_new_file_before_any_query(tmp_path):
    """After ``flush()`` every bank group of the new file is resident
    before any query, in the JAX engine and the port's alike."""
    residency = {}
    for name, pkg in (("jax", bs), ("port", bt)):
        engine, store = flush_engine(pkg, tmp_path / name)
        try:
            out = []
            for f in range(3):
                engine.ingest_rows(flush_rows(f), timeout=TIMEOUT)
                engine.flush(timeout=TIMEOUT)
                backend = engine._device_backend
                for mf in store.get_maybe_files_for_query(None):
                    for gi, g in enumerate(mf.metadata.bank_groups):
                        mk = (g.m_bits, g.k, g.params.layout)
                        assert backend.is_resident(mk, backend.segment_key(mf.pointer, gi))
                with backend._lock:
                    out.append(sorted((sb.capacity, sb.used, sb.dead, len(sb.segments))
                                      for sb in backend._superbanks.values()))
            assert engine.stats()["device"]["probe_launches"] == 0  # no query ran
            residency[name] = out
        finally:
            engine.stop(timeout=TIMEOUT)
    assert residency["port"] == residency["jax"]
    assert residency["port"][-1] == [(128, 9, 0, 3)]  # 3 files x 3 partitions


@pytest.mark.parametrize("name", ["jax", "port"])
def test_failed_warm_on_flush_is_logged_and_queries_stay_exact(tmp_path, monkeypatch,
                                                                caplog, name):
    """A device failure inside the warm-on-flush is logged as the reference
    logs it (and swallowed: the file is durable); the next query loads the
    group itself and returns exact rows."""
    import logging

    pkg = bs if name == "jax" else bt
    bank_mod = __import__(f"{pkg.__name__}.bloom.bank", fromlist=["Superbank"])
    engine, store = flush_engine(pkg, tmp_path / name)
    try:
        def failing_insert(*args, **kwargs):
            raise RuntimeError("injected device failure")

        monkeypatch.setattr(bank_mod.Superbank, "insert", failing_insert)
        with caplog.at_level(logging.ERROR, logger=f"{pkg.__name__}.engine"):
            engine.ingest_rows(flush_rows(0), timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
        logged = [r for r in caplog.records if r.getMessage() == WARM_LOG]
        assert len(logged) == 1 and logged[0].exc_info[0] is RuntimeError
        assert not engine._device_backend._by_file
        monkeypatch.undo()
        rows = engine.query_sync(pkg.new_query().token("flush0tok").build(), timeout=TIMEOUT)
        assert sorted(r["n"] for r in rows) == list(range(30))
        assert engine._device_backend._by_file  # the query loaded the group
    finally:
        engine.stop(timeout=TIMEOUT)


# -- late background work on a tombstoned file (faults found and repaired) ----


def test_tombstone_deferred_behind_a_draining_query_is_applied(tmp_path, monkeypatch):
    """A merge that lands while the last query it would wait for applies
    the tombstones it drained must not defer behind that query: it has read
    its last file, and no later drain of its would apply the tombstone,
    which would leave the file on disk and its columns and chunks live."""
    import threading

    store = HeldOpenStore(str(tmp_path / "data"))
    engine = race_engine(store)
    try:
        first, second = four_files(engine)[:2]
        store.hold.clear()
        result_q: queue.Queue = queue.Queue()
        engine.query(bt.new_query().token("common").build(), result_q)
        assert store.held.wait(RACE_TIMEOUT)
        engine.meta_store.update([], [bt.DeleteOperation(first)])
        engine._tombstone_or_defer(first)  # defers behind the query
        assert [p for p, _ in engine._deferred_tombstones] == [first]

        everywhere = engine._tombstone_everywhere
        landed = threading.Event()

        def merge_lands_meanwhile(pointer):
            if pointer == first:  # the query applies what it drained
                engine.meta_store.update([], [bt.DeleteOperation(second)])
                engine._tombstone_or_defer(second)
                landed.set()
            everywhere(pointer)

        monkeypatch.setattr(engine, "_tombstone_everywhere", merge_lands_meanwhile)
        store.hold.set()
        assert len(drain_rows(result_q)) == 4
        assert landed.wait(RACE_TIMEOUT)
        with engine._queries_drained:
            assert engine._queries_drained.wait_for(
                lambda: not engine._active_query_ids, RACE_TIMEOUT)
        assert engine._deferred_tombstones == []
        assert_dead_on_the_device(engine, [first, second])
        left = {f for f in os.listdir(store.root_dir) if f.endswith(".tombstoned")}
        assert not left, left
    finally:
        engine.stop(timeout=RACE_TIMEOUT)


def test_background_pin_of_a_tombstoned_file_is_not_published(tmp_path, monkeypatch):
    """A background pin (and its sidecar entry) queued by a query that has
    drained, for a file tombstoned before the pin runs, lands nowhere: not
    in the stream and not in the restart sidecar."""
    import threading

    store = bt.FileSystemDataStore(str(tmp_path / "data"))
    config = bt.BloomSearchEngineConfig(
        row_data_compression="snappy", probe_backend="device", device="cpu",
        row_cache_bytes=8 << 20, serving_cache_dir=str(tmp_path / "sidecar"))
    engine = bt.BloomSearchEngine(config, store, store)
    engine.start()
    try:
        for f in range(2):
            engine.ingest_rows(flush_rows(f), timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
        go, queued = threading.Event(), threading.Event()
        pack_store = engine._sidecar_pack_store

        def held_pack_store(*args):
            queued.set()
            go.wait(TIMEOUT)
            return pack_store(*args)

        monkeypatch.setattr(engine, "_sidecar_pack_store", held_pack_store)
        rows = engine.query_sync(bt.new_query().token("flush0tok").build(), timeout=TIMEOUT)
        assert len(rows) == 30 and queued.wait(TIMEOUT)  # its pins wait
        engine.merge()  # no query in flight: the inputs tombstone at once
        go.set()
        engine.drain_background_pins(timeout=TIMEOUT)
        live = {mf.pointer for mf in store.get_maybe_files_for_query(None)}
        assert {key[0] for key in engine._row_cache._blocks} <= live
        prefixes = {engine._serving_cache._prefix(p) for p in live}
        assert {n.split("-")[0] for n in os.listdir(tmp_path / "sidecar")
                if n.endswith(".srv")} <= prefixes
        assert engine.stats()["background_pin_failures"] == 0
    finally:
        engine.stop(timeout=TIMEOUT)


def test_warm_on_flush_of_a_file_merged_meanwhile_does_not_insert(tmp_path, monkeypatch):
    """A flushed file is published before its banks warm: a background
    merge can replace it first. Its warm-on-flush then inserts nothing, so
    no superbank column of a file no tombstone will visit again stays
    live."""
    import threading

    engine, store = flush_engine(bt, tmp_path / "port")
    try:
        engine.ingest_rows(flush_rows(0), timeout=TIMEOUT)
        engine.flush(timeout=TIMEOUT)
        go, entered = threading.Event(), threading.Event()
        on_file_written = engine._on_file_written

        def held(*args):
            entered.set()
            go.wait(TIMEOUT)
            return on_file_written(*args)

        monkeypatch.setattr(engine, "_on_file_written", held)
        flusher = threading.Thread(target=lambda: (
            engine.ingest_rows(flush_rows(1), timeout=TIMEOUT), engine.flush(timeout=TIMEOUT)))
        flusher.start()
        assert entered.wait(TIMEOUT)  # published, not yet warmed
        assert engine.merge().files_processed == 2
        go.set()
        flusher.join(TIMEOUT)
        live = {mf.pointer for mf in store.get_maybe_files_for_query(None)}
        assert set(engine._device_backend._by_file) <= live
        rows = engine.query_sync(bt.new_query().token("flush1tok").build(), timeout=TIMEOUT)
        assert sorted(r["n"] for r in rows) == list(range(100, 130))
    finally:
        engine.stop(timeout=TIMEOUT)

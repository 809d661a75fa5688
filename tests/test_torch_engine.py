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

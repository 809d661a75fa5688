"""The blocked-256 bloom layout on the port, against the JAX package.

First the reference's ``tests/test_blocked_layout.py`` cases on the port's
own modules: positions in one 256-bit block and distinct in it, the native
build and probe against numpy, the FPR curve at the reference's keys and
bounds, the merge gate, and the engine end to end on the host and device
backends with mixed-layout files queryable but never merged together.
Then the two packages side by side: blocked positions bit-identical on the
same hashes, the probe kernel's three modes at blocked positions (the
port's plain version against the Pallas kernel in interpret mode), blocked
stores written by either package read by the other, and a store of
classic and blocked files that returns the same rows from the port on one
device, from the port on a 2-shard CPU mesh and from the JAX engine.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
from bloomsearch_tpu.bloom import hashing as jhashing  # noqa: E402
from bloomsearch_tpu.bloom import pallas_kernels as pk  # noqa: E402
from bloomsearch_tpu.bloom.filter import BloomFilter as JaxBloomFilter  # noqa: E402
from bloomsearch_tpu_torch import native  # noqa: E402
from bloomsearch_tpu_torch.bloom import BloomFilter, BloomParams  # noqa: E402
from bloomsearch_tpu_torch.bloom import probe as tprobe  # noqa: E402
from bloomsearch_tpu_torch.bloom.hashing import (  # noqa: E402
    hash_keys_py,
    positions_for_hashes_blocked,
    positions_for_layout,
)
from bloomsearch_tpu_torch.bloom.params import LAYOUT_BLOCKED256, LAYOUT_CLASSIC  # noqa: E402
from bloomsearch_tpu_torch.file_format import BloomFilters  # noqa: E402
from bloomsearch_tpu_torch.kernels import probe as tk  # noqa: E402
from test_torch_engine import BATCHES, QUERIES, TIMEOUT, config, multiset  # noqa: E402
from test_torch_probe import mask_bits, port_args, words  # noqa: E402


class TestBlockedPositions:
    def test_all_positions_within_one_block(self):
        hashes = hash_keys_py([f"key{i}".encode() for i in range(100)])
        pos = positions_for_hashes_blocked(hashes, k=10, m_bits=256 * 64)
        blocks = pos // 256
        assert (blocks == blocks[:, :1]).all(), "probes must share one 256-bit block"
        assert (pos < 256 * 64).all()

    def test_positions_distinct_within_block(self):
        hashes = hash_keys_py([b"some-key"])
        pos = positions_for_hashes_blocked(hashes, k=10, m_bits=256 * 4)
        assert len(set(pos[0].tolist())) == 10

    @pytest.mark.parametrize("k,m_bits", [(1, 256), (7, 256 * 3), (10, 14_377_728), (16, 256 * 1001)])
    def test_positions_bit_identical_to_the_jax_package(self, k, m_bits):
        keys = [f"term-{i}".encode() for i in range(300)] + ["écho".encode(), b""]
        hashes = hash_keys_py(keys)
        np.testing.assert_array_equal(hashes, jhashing.hash_keys_py(keys))
        mine = positions_for_hashes_blocked(hashes, k, m_bits)
        np.testing.assert_array_equal(mine, jhashing.positions_for_hashes_blocked(hashes, k, m_bits))
        np.testing.assert_array_equal(
            positions_for_layout(hashes, k, m_bits, LAYOUT_BLOCKED256),
            jhashing.positions_for_layout(hashes, k, m_bits, LAYOUT_BLOCKED256))

    def test_refscale_blocked_params_pad_to_whole_blocks(self):
        classic = BloomParams(1_000_000, 0.001)
        blocked = BloomParams(1_000_000, 0.001, LAYOUT_BLOCKED256)
        assert (classic.m_bits, classic.num_words) == (14_377_588, 449_300)
        assert (blocked.m_bits, blocked.num_words, blocked.k) == (14_377_728, 449_304, 10)

    def test_compiled_terms_cache_positions_per_layout(self):
        q = bt.new_query().token("error").field("level").field_token("svc", "pay").build()
        terms = tprobe.compile_bloom_terms(q.bloom)
        m = 256 * 50
        classic = terms.positions_for(m, 10)
        blocked = terms.positions_for(m, 10, LAYOUT_BLOCKED256)
        assert not np.array_equal(classic[0], blocked[0])
        words_of_term = blocked[0]
        # Two probes of one term may share a word: the eight words of a block.
        assert (words_of_term.max(1) - words_of_term.min(1) < 8).all()
        want = jhashing.positions_for_hashes_blocked(terms.hashes, 10, m)
        np.testing.assert_array_equal(blocked[0], (want >> 5).astype(np.int32))
        np.testing.assert_array_equal(blocked[1], (want & 31).astype(np.int32))


class TestBlockedFilter:
    def test_zero_false_negatives(self):
        f = BloomFilter.new_with_estimates(2000, 0.01, layout=LAYOUT_BLOCKED256)
        keys = [f"key-{i}" for i in range(2000)]
        f.add_keys(keys)
        assert f.test_keys(keys).all()
        assert f.m_bits % 256 == 0

    def test_empirical_fpr_matches_measured_curve(self):
        for n, p, ceiling in ((5000, 0.01, 2.5), (5000, 0.001, 8.0)):
            f = BloomFilter.new_with_estimates(n, p, layout=LAYOUT_BLOCKED256)
            f.add_keys([f"present-{i}" for i in range(n)])
            absent = [f"absent-{i}" for i in range(200_000)]
            fpr = f.test_keys(absent).mean()
            assert fpr <= ceiling * p, f"blocked FPR {fpr} vs configured {p} (n={n})"

    def test_classic_fpr_matches_configured_rate(self):
        p = 0.001
        f = BloomFilter.new_with_estimates(5000, p)
        f.add_keys([f"present-{i}" for i in range(5000)])
        absent = [f"absent-{i}" for i in range(200_000)]
        assert f.test_keys(absent).mean() <= 2 * p

    @pytest.mark.skipif(not native.available(), reason="native lib unavailable")
    def test_native_matches_numpy(self):
        keys = [f"key-{i}" for i in range(500)]
        hashes = hash_keys_py([k.encode() for k in keys])
        f_native = BloomFilter.new_with_estimates(500, 0.01, layout=LAYOUT_BLOCKED256)
        f_native.add_hashes(hashes)
        f_py = BloomFilter.new_with_estimates(500, 0.01, layout=LAYOUT_BLOCKED256)
        positions = positions_for_hashes_blocked(hashes, f_py.k, f_py.m_bits).ravel()
        np.bitwise_or.at(f_py.words, (positions >> np.uint64(5)).astype(np.int64),
                         np.uint32(1) << (positions & np.uint64(31)).astype(np.uint32))
        assert f_native == f_py
        probes = hash_keys_py([k.encode() for k in keys + ["absent-1", "absent-2"]])
        np.testing.assert_array_equal(
            f_native.test_hashes(probes),
            np.array([True] * 500 + list(f_py.test_hashes(probes)[-2:])),
        )

    def test_words_bit_identical_to_the_jax_package(self):
        keys = [f"key-{i}" for i in range(3000)] + ["straße", "日本語"]
        mine = BloomFilter.new_with_estimates(3000, 0.001, layout=LAYOUT_BLOCKED256)
        theirs = JaxBloomFilter.new_with_estimates(3000, 0.001, layout=LAYOUT_BLOCKED256)
        mine.add_keys(keys)
        theirs.add_keys(keys)
        np.testing.assert_array_equal(mine.words, theirs.words)
        assert mine.to_bytes() == theirs.to_bytes()

    def test_merge_layout_gated(self):
        a = BloomFilter.new_with_estimates(1000, 0.01, layout=LAYOUT_BLOCKED256)
        b = BloomFilter.new_with_estimates(1000, 0.01)
        with pytest.raises(ValueError):
            a.merge(b)


def blocked_bank(params):
    """A bank of three blocked BloomFilters triples, rows padded as the JAX
    bank pads them, and the query terms' probe rows and shifts."""
    triples = []
    for fields, tokens, fts in [
        (["service"], ["error", "timeout"], ["service::payment"]),
        (["level"], ["info"], ["level::info"]),
        (["service", "level"], ["error"], ["service::auth"]),
    ]:
        t = BloomFilters.from_params(params)
        t.field.add_keys(fields)
        t.token.add_keys(tokens)
        t.field_token.add_keys(fts)
        triples.append(t)
    host = tprobe.stack_filter_bank(triples)
    _, W, B = host.shape
    bank = np.zeros((pk.round_up_rows(3 * W), 128), dtype=np.uint32)
    bank[: 3 * W, :B] = host.reshape(3 * W, B)
    q = bt.new_query().token("error").field("level").field_token("service", "payment").build()
    terms = tprobe.compile_bloom_terms(q.bloom)
    word_idx, bit_idx = terms.positions_for(params.m_bits, params.k, params.layout)
    rows = (terms.ks_idx[:, None].astype(np.int32) * W + word_idx).reshape(-1).astype(np.int32)
    return bank, rows, bit_idx.reshape(-1).astype(np.int32), len(terms), B


class TestProbeAtBlockedPositions:
    """The kernel's three modes at blocked positions, where a term's probes
    repeat rows: the port's plain version against the Pallas kernel."""

    params = BloomParams(1000, 0.001, LAYOUT_BLOCKED256)  # k = 10 probes in 8 words

    def test_pack(self):
        bank, rows, shifts, T, B = blocked_bank(self.params)
        assert len(set(rows[: self.params.k].tolist())) < self.params.k
        want = words(pk.probe_and_pack(jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts),
                                       T, self.params.k, use_pallas=True, interpret=True))
        got = words(tk.probe_and_pack(*port_args(bank, rows, shifts), T, self.params.k))
        np.testing.assert_array_equal(got, want)
        bits = np.unpackbits(got.view(np.uint8), axis=1, bitorder="little")[:, :B]
        np.testing.assert_array_equal(bits, [[1, 0, 1], [0, 1, 1], [1, 0, 0]])

    def test_reduce_and(self):
        bank, rows, shifts, T, _ = blocked_bank(self.params)
        want = words(pk.probe_reduce_and_pack(
            jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, self.params.k,
            jnp.asarray(np.ones(T, dtype=bool)), use_pallas=True, interpret=True))
        got = words(tk.probe_reduce_and_pack(*port_args(bank, rows, shifts), T, self.params.k,
                                             (1 << T) - 1))
        np.testing.assert_array_equal(got, want)

    def test_clauses(self):
        bank, rows, shifts, T, _ = blocked_bank(self.params)
        clause = np.zeros((16, T), dtype=np.float32)
        clause[0, [0, 1]] = 1  # error OR level
        clause[1, 2] = 1  # AND service::payment
        clause[2, 1] = 1  # a second member: level alone
        member = np.zeros((16, 16), dtype=np.float32)
        member[0, [0, 1]] = 1
        member[1, 2] = 1
        want = words(pk.probe_clauses_pack(
            jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, self.params.k,
            jnp.asarray(clause), jnp.asarray(member), use_pallas=True, interpret=True))
        cb, mb = mask_bits(clause, member)
        got = words(tk.probe_clauses_pack(*port_args(bank, rows, shifts), T, self.params.k, cb, mb))
        np.testing.assert_array_equal(got, want)


def start(pkg, directory, **kw):
    store = pkg.FileSystemDataStore(str(directory))
    engine = pkg.BloomSearchEngine(config(pkg, **kw), store, store)
    engine.start()
    return engine, store


class TestBlockedEngine:
    def test_end_to_end_query(self, tmp_path):
        engine, store = start(bt, tmp_path, bloom_layout=LAYOUT_BLOCKED256, probe_backend="host",
                              partition_func=None, min_max_indexes=[])
        try:
            rows = [{"n": i, "w": f"word{i}"} for i in range(500)]
            rows.append({"n": -1, "w": "needle"})
            engine.ingest_rows(rows, timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            metadata = store.get_maybe_files_for_query(None)[0].metadata
            assert metadata.bloom_filters.field.layout == LAYOUT_BLOCKED256
            assert metadata.data_blocks[0].bloom_layout == LAYOUT_BLOCKED256
            assert metadata.bank_groups[0].params.layout == LAYOUT_BLOCKED256
            res = engine.query_sync(bt.new_query().token("needle").build(), timeout=TIMEOUT)
            assert len(res) == 1 and res[0]["n"] == -1
            res = engine.query_sync(bt.new_query().field_token("w", "word42").build(), timeout=TIMEOUT)
            assert len(res) == 1 and res[0]["n"] == 42
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_device_backend_blocked(self, tmp_path):
        engine, _ = start(bt, tmp_path, bloom_layout=LAYOUT_BLOCKED256, partition_func=None,
                          min_max_indexes=[])
        try:
            engine.ingest_rows([{"a": "alpha beta"}, {"b": "gamma delta"}], timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
            res = engine.query_sync(bt.new_query().token("gamma").build(), timeout=TIMEOUT)
            assert len(res) == 1 and "b" in res[0]
            superbanks = engine.stats()["device"]["superbanks"]
            assert list(superbanks) and all(k.endswith(LAYOUT_BLOCKED256) for k in superbanks)
        finally:
            engine.stop(timeout=TIMEOUT)

    def test_mixed_layout_files_both_queryable_but_unmergeable(self, tmp_path):
        classic, store = start(bt, tmp_path, probe_backend="host", partition_func=None,
                               min_max_indexes=[])
        classic.ingest_rows([{"x": "classicrow"}], timeout=TIMEOUT)
        classic.flush(timeout=TIMEOUT)
        classic.stop(timeout=TIMEOUT)
        blocked, _ = start(bt, tmp_path, bloom_layout=LAYOUT_BLOCKED256, partition_func=None,
                           min_max_indexes=[])
        try:
            blocked.ingest_rows([{"x": "blockedrow"}], timeout=TIMEOUT)
            blocked.flush(timeout=TIMEOUT)
            for token in ("classicrow", "blockedrow"):
                assert len(blocked.query_sync(bt.new_query().token(token).build(),
                                              timeout=TIMEOUT)) == 1
            # Both superbanks resident, one a layout.
            layouts = {k.rsplit(",", 1)[1] for k in blocked.stats()["device"]["superbanks"]}
            assert layouts == {LAYOUT_CLASSIC, LAYOUT_BLOCKED256}
            assert blocked.merge().files_processed == 0
            assert len(store.get_maybe_files_for_query(None)) == 2
        finally:
            blocked.stop(timeout=TIMEOUT)


def write_batches(pkg, directory, batches) -> None:
    """One file a (batch, layout) pair."""
    for batch, layout in batches:
        engine, _ = start(pkg, directory, bloom_layout=layout)
        try:
            engine.ingest_rows(batch, timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
        finally:
            engine.stop(timeout=TIMEOUT)


def rows_of_every_shape(pkg, directory, **kw) -> dict:
    engine, _ = start(pkg, directory, **kw)
    try:
        return {name: multiset(engine.query_sync(make(pkg), timeout=TIMEOUT))
                for name, make in QUERIES.items()}
    finally:
        engine.stop(timeout=TIMEOUT)


BLOCKED = [(batch, LAYOUT_BLOCKED256) for batch in BATCHES]
MIXED = list(zip(BATCHES, (LAYOUT_CLASSIC, LAYOUT_BLOCKED256, LAYOUT_BLOCKED256)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_blocked_store_reads_the_same_in_both_packages(tmp_path, writer):
    write_batches(bt if writer == "port" else bs, tmp_path, BLOCKED)
    port = rows_of_every_shape(bt, tmp_path)
    assert port == rows_of_every_shape(bs, tmp_path)
    assert port == rows_of_every_shape(bt, tmp_path, probe_backend="host")
    assert any(port.values())


def test_mixed_layout_store_same_rows_on_one_device_a_mesh_and_jax(tmp_path):
    write_batches(bt, tmp_path / "a", MIXED[:2])
    write_batches(bs, tmp_path / "a", MIXED[2:])  # a blocked file the JAX package wrote
    one = rows_of_every_shape(bt, tmp_path / "a")
    assert one == rows_of_every_shape(bt, tmp_path / "a", mesh_devices=2)
    assert one == rows_of_every_shape(bs, tmp_path / "a")
    assert one == rows_of_every_shape(bt, tmp_path / "a", probe_backend="host")

"""The port's restart sidecar (servingcache.py): roundtrip, validation,
invalidation, the engine restart fast path, and sidecars written by either
package loaded by the other (the format is shared)."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu.servingcache as sc_ref  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
from bloomsearch_tpu.rowcache import pack_block as pack_block_ref  # noqa: E402
from bloomsearch_tpu_torch.compression import compression_available  # noqa: E402
from bloomsearch_tpu_torch.file_format import DataBlockMetadata  # noqa: E402
from bloomsearch_tpu_torch.rowcache import pack_block  # noqa: E402
from bloomsearch_tpu_torch.servingcache import PACK_VERSION, ServingStateCache  # noqa: E402

TIMEOUT = 60


def _rows_blob(n=200, seed=0):
    rng = np.random.default_rng(seed)
    parts, offsets, lengths = [], [], []
    pos = 0
    for i in range(n):
        row = b'{"msg":"Payload %d %s"}' % (
            i, bytes(rng.integers(97, 123, size=int(rng.integers(5, 40)))),
        )
        offsets.append(pos)
        lengths.append(len(row))
        parts.append(row)
        pos += len(row)
    return (
        b"".join(parts),
        np.asarray(offsets, dtype=np.int64),
        np.asarray(lengths, dtype=np.int64),
    )


def _blk(data, offsets, *, offset=0, compression="none", hash_=12345):
    return DataBlockMetadata(
        offset=offset, size=len(data), rows=offsets.shape[0], compression=compression,
        uncompressed_size=len(data), row_data_hash=hash_,
    )


def sidecars(directory) -> list[str]:
    return [n for n in os.listdir(str(directory)) if n.endswith(".srv")]


class TestRoundtrip:
    def test_store_load_bit_parity(self, tmp_path):
        sc = ServingStateCache(str(tmp_path))
        data, offsets, lengths = _rows_blob(300)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        blk = _blk(data, offsets, compression="snappy")
        comp_index = np.arange(7, dtype=np.int64) * 131
        assert sc.store(b"ptr-a", blk, chunks, flags, n_chunks, offsets, lengths, comp_index)
        hit = sc.load(b"ptr-a", blk)
        assert hit is not None and hit.n_chunks == n_chunks
        np.testing.assert_array_equal(np.asarray(hit.chunks), chunks)
        np.testing.assert_array_equal(hit.always_candidate, flags)
        np.testing.assert_array_equal(hit.row_offsets, offsets.astype(np.int32))
        np.testing.assert_array_equal(hit.row_lengths, lengths.astype(np.int32))
        np.testing.assert_array_equal(hit.comp_index, comp_index)
        assert sc.stats() == {"hits": 1, "misses": 0, "stores": 1}

    def test_store_skips_existing(self, tmp_path):
        sc = ServingStateCache(str(tmp_path))
        data, offsets, lengths = _rows_blob(50)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        blk = _blk(data, offsets)
        assert sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)
        assert not sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)

    def test_no_comp_index(self, tmp_path):
        sc = ServingStateCache(str(tmp_path))
        data, offsets, lengths = _rows_blob(50)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        blk = _blk(data, offsets)
        sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)
        hit = sc.load(b"p", blk)
        assert hit is not None and hit.comp_index is None

    def test_non_ascii_flags_roundtrip(self, tmp_path):
        rows = [b'{"m":"plain ascii"}', '{"m":"K unicode"}'.encode()]
        offsets = np.asarray([0, len(rows[0])], dtype=np.int64)
        lengths = np.asarray([len(rows[0]), len(rows[1])], dtype=np.int64)
        data = b"".join(rows)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        assert flags.tolist() == [False, True]
        sc = ServingStateCache(str(tmp_path))
        blk = _blk(data, offsets)
        sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)
        np.testing.assert_array_equal(sc.load(b"p", blk).always_candidate, flags)

    def test_files_load_in_the_other_package(self, tmp_path):
        data, offsets, lengths = _rows_blob(120, seed=3)
        blk = _blk(data, offsets, compression="snappy", hash_=777)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        ref_chunks, ref_flags, ref_n = pack_block_ref(data, offsets, lengths)
        np.testing.assert_array_equal(chunks, ref_chunks)
        np.testing.assert_array_equal(flags, ref_flags)
        assert n_chunks == ref_n
        ci = np.arange(3, dtype=np.int64)
        assert ServingStateCache(str(tmp_path / "p")).store(
            b"x", blk, chunks, flags, n_chunks, offsets, lengths, ci)
        assert sc_ref.ServingStateCache(str(tmp_path / "j")).store(
            b"x", blk, chunks, flags, n_chunks, offsets, lengths, ci)
        (p_name,), (j_name,) = sidecars(tmp_path / "p"), sidecars(tmp_path / "j")
        assert p_name == j_name
        assert (tmp_path / "p" / p_name).read_bytes() == (tmp_path / "j" / j_name).read_bytes()
        for loader, directory in (
            (sc_ref.ServingStateCache, tmp_path / "p"),
            (ServingStateCache, tmp_path / "j"),
        ):
            hit = loader(str(directory)).load(b"x", blk)
            assert hit is not None
            np.testing.assert_array_equal(np.asarray(hit.chunks), chunks)
            np.testing.assert_array_equal(hit.comp_index, ci)


class TestValidation:
    def _stored(self, tmp_path):
        sc = ServingStateCache(str(tmp_path))
        data, offsets, lengths = _rows_blob(80)
        chunks, flags, n_chunks = pack_block(data, offsets, lengths)
        blk = _blk(data, offsets)
        sc.store(b"p", blk, chunks, flags, n_chunks, offsets, lengths, None)
        return sc, blk, data, offsets

    def test_hash_mismatch_misses(self, tmp_path):
        sc, blk, data, offsets = self._stored(tmp_path)
        assert sc.load(b"p", _blk(data, offsets, hash_=blk.row_data_hash + 1)) is None

    def test_truncation_misses(self, tmp_path):
        sc, blk, _, _ = self._stored(tmp_path)
        (name,) = sidecars(tmp_path)
        path = tmp_path / name
        path.write_bytes(path.read_bytes()[:-20])
        assert sc.load(b"p", blk) is None

    def test_version_skew_misses(self, tmp_path, monkeypatch):
        sc, blk, _, _ = self._stored(tmp_path)
        monkeypatch.setattr("bloomsearch_tpu_torch.servingcache.PACK_VERSION", PACK_VERSION + 1)
        assert sc.load(b"p", blk) is None

    def test_garbage_file_misses(self, tmp_path):
        sc, blk, _, _ = self._stored(tmp_path)
        (name,) = sidecars(tmp_path)
        (tmp_path / name).write_bytes(b"not a sidecar at all")
        assert sc.load(b"p", blk) is None

    def test_invalidate_file(self, tmp_path):
        sc, blk, _, _ = self._stored(tmp_path)
        assert sc.load(b"p", blk) is not None
        sc.invalidate_file(b"p")
        assert sc.load(b"p", blk) is None
        assert not sidecars(tmp_path)


def _config(pkg, cache_dir, **kw):
    common = dict(
        row_data_compression="snappy", probe_backend="device", row_cache_bytes=256 << 20,
        serving_cache_dir=str(cache_dir), row_cache_async_pins=False,
    )
    common.update(kw)
    if pkg is bs:
        return bs.BloomSearchEngineConfig(mesh_devices=1, **common)
    return bt.BloomSearchEngineConfig(device="cpu", **common)


def _needle_rows(pkg, engine):
    res = engine.query_sync(pkg.new_query().token("needle").build(), timeout=TIMEOUT)
    return sorted(r["n"] for r in res)


def _ingest(pkg, engine, n=3000):
    rows = [{"n": i, "msg": f"log line {i} zzz"} for i in range(n)]
    rows.append({"n": -1, "msg": "special needle row"})
    engine.ingest_rows(rows, timeout=TIMEOUT)
    engine.flush(timeout=TIMEOUT)


@pytest.fixture
def snappy():
    if not compression_available("snappy"):
        pytest.skip("snappy unavailable")


class TestEngineRestart:
    def test_restart_hits_sidecar_and_matches(self, tmp_path, snappy):
        store = bt.FileSystemDataStore(str(tmp_path / "data"))
        cache_dir = tmp_path / "sidecars"
        engine = bt.BloomSearchEngine(_config(bt, cache_dir), store, store)
        engine.start()
        try:
            _ingest(bt, engine)
            engine.warmup(block=True, timeout=120)
            assert _needle_rows(bt, engine) == [-1]
            stats1 = engine.stats()["serving_cache"]
            assert stats1["stores"] >= 1 and stats1["hits"] == 0
        finally:
            engine.stop(timeout=30)
        engine2 = bt.BloomSearchEngine(_config(bt, cache_dir), store, store)
        engine2.start()
        try:
            engine2.warmup(block=True, timeout=120)
            stats2 = engine2.stats()["serving_cache"]
            assert stats2["hits"] >= 1 and stats2["stores"] == 0 and stats2["misses"] == 0
            assert _needle_rows(bt, engine2) == [-1]
            res = engine2.query_sync(bt.new_query().token("zzz").build(), timeout=TIMEOUT)
            assert len(res) == 3000
        finally:
            engine2.stop(timeout=30)

    def test_merge_tombstone_invalidates_sidecars(self, tmp_path):
        store = bt.FileSystemDataStore(str(tmp_path / "data"))
        cache_dir = tmp_path / "sidecars"
        engine = bt.BloomSearchEngine(_config(bt, cache_dir), store, store)
        engine.start()
        try:
            for i in range(3):
                engine.ingest_rows(
                    [{"n": i * 10 + j, "msg": f"tok{i}"} for j in range(50)], timeout=30
                )
                engine.flush(timeout=30)
            engine.warmup(block=True, timeout=120)
            n_before = len(sidecars(cache_dir))
            assert n_before >= 3
            engine.merge()
            assert len(sidecars(cache_dir)) < n_before
            res = engine.query_sync(bt.new_query().token("tok1").build(), timeout=TIMEOUT)
            assert len(res) == 50
        finally:
            engine.stop(timeout=30)


class TestCrossPackageSidecars:
    def test_jax_engine_sidecars_load_in_the_port(self, tmp_path, snappy):
        """The JAX engine writes sidecars on its query path (synchronous
        pins); the port's warmup then pins every block from them."""
        store_dir, cache_dir = tmp_path / "data", tmp_path / "sidecars"
        store = bt.FileSystemDataStore(str(store_dir))
        writer = bt.BloomSearchEngine(_config(bt, cache_dir, row_cache_bytes=0), store, store)
        writer.start()
        try:
            _ingest(bt, writer)
        finally:
            writer.stop(timeout=30)
        ref_store = bs.FileSystemDataStore(str(store_dir))
        ref = bs.BloomSearchEngine(_config(bs, cache_dir), ref_store, ref_store)
        ref.start()
        try:
            want = _needle_rows(bs, ref)
            assert ref.stats()["serving_cache"]["stores"] >= 1
        finally:
            ref.stop(timeout=30)
        n_blocks = sum(
            len(mf.metadata.data_blocks) for mf in store.get_maybe_files_for_query(None)
        )
        assert len(sidecars(cache_dir)) == n_blocks
        port = bt.BloomSearchEngine(_config(bt, cache_dir), store, store)
        port.start()
        try:
            port.warmup(block=True, timeout=120)
            stats = port.stats()
            assert stats["serving_cache"] == {"hits": n_blocks, "misses": 0, "stores": 0}
            assert stats["row_cache"]["pinned_blocks"] == n_blocks
            assert _needle_rows(bt, port) == want == [-1]
        finally:
            port.stop(timeout=30)

    def test_port_engine_sidecars_load_in_the_jax_package(self, tmp_path, snappy):
        store_dir, cache_dir = tmp_path / "data", tmp_path / "sidecars"
        store = bt.FileSystemDataStore(str(store_dir))
        port = bt.BloomSearchEngine(_config(bt, cache_dir), store, store)
        port.start()
        try:
            _ingest(bt, port)
            assert _needle_rows(bt, port) == [-1]
            assert port.stats()["serving_cache"]["stores"] >= 1
        finally:
            port.stop(timeout=30)
        ref_cache = sc_ref.ServingStateCache(str(cache_dir))
        ref_store = bs.FileSystemDataStore(str(store_dir))
        blocks = [
            (mf.pointer, blk)
            for mf in ref_store.get_maybe_files_for_query(None)
            for blk in mf.metadata.data_blocks
        ]
        assert blocks and len(sidecars(cache_dir)) == len(blocks)
        from bloomsearch_tpu.compression import decompress_block
        from bloomsearch_tpu.file_format import read_block_rows_compressed
        from bloomsearch_tpu.scan import split_rows_arrays

        for pointer, blk in blocks:
            hit = ref_cache.load(pointer, blk)
            assert hit is not None
            with ref_store.open_file(pointer) as fh:
                compressed = read_block_rows_compressed(fh, blk, verify=True)
            data = decompress_block(compressed, blk.compression, blk.uncompressed_size)
            _, offsets, lengths = split_rows_arrays(data)
            chunks, flags, n_chunks = pack_block_ref(data, offsets, lengths)
            assert hit.n_chunks == n_chunks
            np.testing.assert_array_equal(np.asarray(hit.chunks), chunks)
            np.testing.assert_array_equal(hit.always_candidate, flags)
        assert ref_cache.stats() == {"hits": len(blocks), "misses": 0, "stores": 0}

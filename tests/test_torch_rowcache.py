"""The port's DeviceRowCache against the JAX package's, on the same pins.

Most cases drive a ``Pair``: the JAX cache (``mesh_devices=1``, its XLA scan
path on the CPU) and the port's (``device="cpu"``, the scan kernel's plain
version) receive the same pins, evictions and scans, and after every step
the two must hold the same stream matrix, segment placements, ``used`` /
``dead`` / ``cap`` and ``stats()`` counters, and return the same
``scan_many`` matrices. Tolerance: none. Cases that depend on thread timing
run the port alone.
"""

import json
import random
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu.rowcache as rc_ref  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
import bloomsearch_tpu_torch.rowcache as rc  # noqa: E402
from bloomsearch_tpu_torch import native  # noqa: E402
from bloomsearch_tpu_torch.file_format import encode_row  # noqa: E402
from bloomsearch_tpu_torch.rowcache import (  # noqa: E402
    CHUNK_BYTES,
    STREAM_STRIDE,
    DeviceRowCache,
    RowCacheReleasedError,
    _pack_stream_numpy,
    _unpack_bit_range,
    _yield_point,
    rowcache_from_reference,
)
from bloomsearch_tpu_torch.scan import split_rows_arrays  # noqa: E402


def make_stream(rows):
    return b"".join(
        encode_row(json.dumps(r, separators=(",", ":")).encode()) for r in rows
    )


def block_of(rows):
    data = make_stream(rows)
    _, offsets, lengths = split_rows_arrays(data)
    return data, offsets, lengths


def chunk_oracle(data: bytes, offsets, lengths, needle: bytes) -> np.ndarray:
    """The exact expected device result: chunk hits on the lowered stream,
    expanded to rows overlapping [c*STRIDE, c*STRIDE + STRIDE + len - 1)."""
    low = bytes(c + 32 if ord("A") <= c <= ord("Z") else c for c in data)
    n = len(low)
    out = np.zeros(len(offsets), dtype=bool)
    n_chunks = -(-n // STREAM_STRIDE) if n else 0
    ends = offsets + lengths
    for c in range(n_chunks):
        lo_b, hi_b = c * STREAM_STRIDE, min((c + 1) * STREAM_STRIDE, n)
        pos = low.find(needle, lo_b)
        if pos < 0 or pos >= hi_b:
            continue
        span_end = lo_b + STREAM_STRIDE + len(needle) - 1
        out |= (offsets < span_end) & (ends > lo_b)
    return out


def port_matrix(cache) -> np.ndarray:
    m = cache._bucket.matrix
    return None if m is None else m.cpu().numpy()


class Pair:
    """The same operations on the JAX cache and the port's, checked equal."""

    def __init__(self, capacity, needle_cache=True, **kw):
        self.ref = rc_ref.DeviceRowCache(capacity, mesh_devices=1, **kw)
        self.port = DeviceRowCache(capacity, device="cpu", **kw)
        self.ref.needle_cache_enabled = self.port.needle_cache_enabled = needle_cache

    def check(self):
        a, b = self.ref._bucket, self.port._bucket
        assert (b.cap, b.used, b.dead) == (a.cap, a.used, a.dead)
        assert b.segments == a.segments
        assert self.port._reserved_cap == self.ref._reserved_cap
        assert list(self.port._blocks) == list(self.ref._blocks)
        assert self.port.stats() == self.ref.stats()
        ref_m = None if a.matrix is None else np.asarray(a.matrix)
        port_m = port_matrix(self.port)
        if ref_m is None:
            assert port_m is None
        else:
            np.testing.assert_array_equal(port_m, ref_m)

    def pin(self, key, data, offsets, lengths, **kw):
        pair = (
            self.ref.pin(key, data, offsets, lengths, **kw),
            self.port.pin(key, data, offsets, lengths, **kw),
        )
        self.check()
        return pair

    def reserve(self, total_chunks):
        got = self.port.reserve(total_chunks)
        assert got == self.ref.reserve(total_chunks)
        self.check()
        return got

    def invalidate_file(self, pointer):
        self.ref.invalidate_file(pointer)
        self.port.invalidate_file(pointer)
        self.check()

    def get(self, key):
        a, b = self.ref.get(key), self.port.get(key)
        assert (a is None) == (b is None)
        return None if a is None else (a, b)

    def scan_many(self, pairs, needles):
        want = self.ref.scan_many([p[0] for p in pairs], needles)
        got = self.port.scan_many([p[1] for p in pairs], needles)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=repr(key))
        self.check()
        return got

    def scan(self, pair, needles):
        return self.scan_many([pair], needles)[pair[1].key]


class TestDeviceRowCache:
    def test_scan_superset_of_host_and_matches_oracle(self):
        rng = random.Random(3)
        words = ["alpha", "BRAVO", "charlie9", "x y z", "needle-one"]
        rows = [
            {"m": " ".join(rng.choice(words) for _ in range(rng.randrange(1, 4)))}
            for _ in range(200)
        ]
        data, offsets, lengths = block_of(rows)
        needles = [b"bravo", b"needle-one", b"absent-needle"]
        cache = Pair(64 << 20)
        pinned = cache.pin((b"f", 0), data, offsets, lengths)
        device_scan = cache.scan(pinned, needles)
        for qi, needle in enumerate(needles):
            truth = np.array(
                [needle.decode() in json.dumps(r, separators=(",", ":")).lower() for r in rows]
            )
            assert (device_scan[qi] | ~truth).all(), needle
            np.testing.assert_array_equal(
                device_scan[qi], chunk_oracle(data, offsets, lengths, needle),
                err_msg=repr(needle),
            )
        assert not device_scan[2].any()
        if native.available():
            buf = np.frombuffer(data, dtype=np.uint8)
            host_scan = native.scan_candidates(buf, needles, offsets, lengths)
            assert (device_scan | ~host_scan).all(), "device missed a host hit"

    def test_match_at_row_tail(self):
        data, offsets, lengths = block_of([{"a": "x" * 90 + " endneedle"}, {"b": "short"}])
        cache = Pair(64 << 20)
        pinned = cache.pin((b"f", 0), data, offsets, lengths)
        assert cache.scan(pinned, [b"endneedle"])[0, 0]

    def test_oversized_needle_conservative(self):
        data, offsets, lengths = block_of([{"a": "hello"}])
        cache = Pair(64 << 20)
        pinned = cache.pin((b"f", 0), data, offsets, lengths)
        assert cache.scan(pinned, [b"x" * 64])[0, 0]  # > MAX_NEEDLE: candidate

    def test_long_rows_scan_exactly(self):
        data, offsets, lengths = block_of(
            [{"big": "x" * 5000 + " deepneedle " + "y" * 400}, {"small": "z"}]
        )
        cache = Pair(64 << 20)
        pinned = cache.pin((b"f", 0), data, offsets, lengths)
        scan = cache.scan(pinned, [b"zzz-not-present", b"deepneedle"])
        assert not scan[0].any()
        assert scan[1, 0]

    def test_lru_eviction(self):
        data, offsets, lengths = block_of([{"k": "v" * 100} for _ in range(50)])
        one = Pair(0)  # capacity smaller than any block: keeps the last
        one.pin((b"a", 0), data, offsets, lengths)
        one.pin((b"b", 0), data, offsets, lengths)
        assert one.get((b"a", 0)) is None
        assert one.get((b"b", 0)) is not None

    def test_invalidate_file(self):
        data, offsets, lengths = block_of([{"k": "v"}])
        cache = Pair(64 << 20)
        for key in ((b"f", 0), (b"f", 10), (b"g", 0)):
            cache.pin(key, data, offsets, lengths)
        cache.invalidate_file(b"f")
        assert cache.get((b"f", 0)) is None
        assert cache.get((b"f", 10)) is None
        assert cache.get((b"g", 0)) is not None

    def test_matrix_lives_on_the_configured_device(self):
        data, offsets, lengths = block_of([{"k": "device"}])
        cache = DeviceRowCache(1 << 20, device="cpu")
        cache.pin((b"f", 0), data, offsets, lengths)
        m = cache._bucket.matrix
        assert m.device.type == "cpu" and m.dtype == torch.int32
        assert m.shape == (cache._bucket.cap, CHUNK_BYTES // 4)

    def test_cuda_without_a_card_raises_and_mesh_is_not_ported(self):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                DeviceRowCache(1 << 20)
        with pytest.raises(NotImplementedError):
            DeviceRowCache(1 << 20, mesh_devices=2, device="cpu")


class TestNativePackParity:
    def test_native_pack_stream_matches_numpy_spec(self, monkeypatch):
        """bs_pack_stream must produce the exact chunk matrix and flags of
        _pack_stream_numpy (the spec) — and of the JAX package's spec —
        including \\U escapes, non-ASCII bytes, \\/ and literal backslashes,
        empty rows and rows crossing chunk boundaries."""
        if not native.available() or native.pack_stream(
            b"", np.empty(0, np.int64), np.empty(0, np.int64), STREAM_STRIDE, CHUNK_BYTES,
        ) is None:
            pytest.skip("native pack_stream unavailable")
        rng = random.Random(7)
        specials = ["\\u0041", "\\U0041", "\\/", "\\\\", "café", "A" * 7, "Z" * 9, ""]
        rows = []
        for _ in range(300):
            parts = ["".join(rng.choice("abcXYZ  09_-") for _ in range(rng.randrange(0, 40)))]
            if rng.random() < 0.5:
                parts.append(rng.choice(specials))
            if rng.random() < 0.02:
                parts.append("x" * 4200)
            rows.append({"k": "".join(parts)})
        data, offsets, lengths = block_of(rows)
        chunks_n, flags_n = native.pack_stream(data, offsets, lengths, STREAM_STRIDE, CHUNK_BYTES)
        chunks_p, flags_p = _pack_stream_numpy(data, offsets, lengths)
        chunks_r, flags_r = rc_ref._pack_stream_numpy(data, offsets, lengths)
        np.testing.assert_array_equal(chunks_n, chunks_p)
        np.testing.assert_array_equal(flags_n.astype(bool), flags_p)
        np.testing.assert_array_equal(chunks_p, chunks_r)
        np.testing.assert_array_equal(flags_p, flags_r)
        # And through pin(): native and numpy packing land identical
        # matrices, equal to the JAX package's.
        pair = Pair(256 << 20)
        pin_native = pair.pin((b"n", 0), data, offsets, lengths)[1]
        monkeypatch.setattr(rc._native, "pack_stream", lambda *a, **k: None)
        cache_numpy = DeviceRowCache(256 << 20, device="cpu")
        pin_numpy = cache_numpy.pin((b"n", 0), data, offsets, lengths)
        np.testing.assert_array_equal(pin_native.always_candidate, pin_numpy.always_candidate)
        np.testing.assert_array_equal(port_matrix(pair.port), port_matrix(cache_numpy))


class TestBackgroundForegroundContention:
    def test_foreground_pin_wait_breaks_background_yield(self):
        """A background holder of _upload_lock pausing at a yield point must
        hurry once a foreground pin blocks on the lock."""
        cache = DeviceRowCache(64 << 20, device="cpu")

        def bg_holder():
            with cache._mutation_lock(foreground=False):
                _yield_point(lambda: True, time.monotonic() + 5.0, cache._has_upload_waiters)

        t = threading.Thread(target=bg_holder)
        t0 = time.monotonic()
        t.start()
        time.sleep(0.1)
        data, offsets, lengths = block_of([{"m": "hello"}])
        cache.pin((b"fg", 0), data, offsets, lengths)  # foreground
        t.join()
        elapsed = time.monotonic() - t0
        assert elapsed < 3.0, f"priority inversion: fg pin stalled {elapsed:.1f}s"

    def test_unreserved_stream_never_grows_past_budget(self):
        """Growth clamps at the budget ceiling and the capacity freezes
        there (reclaim in place thereafter), in both packages alike."""
        budget_chunks = 4096
        cache = Pair(budget_chunks * CHUNK_BYTES)
        data, offsets, lengths = block_of([{"m": f"row{i} " + "x" * 400} for i in range(300)])
        caps = []
        for b in range(20):
            cache.pin((f"blk{b}".encode(), 0), data, offsets, lengths)
            caps.append(cache.port._bucket.cap)
        assert max(caps) * CHUNK_BYTES <= cache.port.capacity_bytes
        last = cache.get((b"blk19", 0))
        assert last is not None
        assert cache.scan(last, [b"row299"])[0].any()


class TestStreamBucket:
    def test_blocks_share_the_stream(self):
        cache = Pair(64 << 20)
        pinned = []
        for b in range(4):
            data, offs, lens = block_of([{"m": f"blk{b} row{i} common"} for i in range(20)])
            pinned.append(cache.pin((b"f", b), data, offs, lens))
        bucket = cache.port._bucket
        assert len(bucket.segments) == 4
        assert bucket.used == sum(p[1].num_chunks for p in pinned)
        cache.scan_many(pinned, [b"common", b"row7 ", b"blk2 "])

    def test_scan_exact_after_eviction_and_compaction(self):
        cache = Pair(64 << 20)
        blocks = {}
        for b in range(6):
            data, offs, lens = block_of([{"m": f"blk{b} tok{b}_{i} " + "pad" * 40} for i in range(30)])
            blocks[b] = cache.pin((f"f{b}".encode(), 0), data, offs, lens)
        total_chunks = sum(b[1].num_chunks for b in blocks.values())
        for b in (0, 1, 2, 3):
            cache.invalidate_file(f"f{b}".encode())
        bucket = cache.port._bucket
        assert len(bucket.segments) == 2
        assert bucket.used - bucket.dead == blocks[4][1].num_chunks + blocks[5][1].num_chunks
        assert bucket.used < total_chunks  # a compaction ran
        for b in (4, 5):
            scan = cache.scan(blocks[b], [f"tok{b}_13 ".encode(), b"absent"])
            assert scan[0][13], b
            assert not scan[1].any(), b

    def test_concurrent_scans_share_launches(self):
        cache = DeviceRowCache(64 << 20, device="cpu")
        pinned = {}
        for b in range(8):
            data, offs, lens = block_of([{"m": f"blk{b} tok{b}_{i}"} for i in range(15)])
            pinned[b] = cache.pin((f"f{b}".encode(), 0), data, offs, lens)
        orig = cache._launch_bucket_scan

        def slow(*a, **k):
            time.sleep(0.05)
            return orig(*a, **k)

        cache._launch_bucket_scan = slow
        results, errors = {}, []

        def one(b):
            try:
                results[b] = cache.scan(pinned[b], [f"tok{b}_7".encode(), b"absent"])
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        launches0 = cache.launches
        threads = [threading.Thread(target=one, args=(b,)) for b in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert cache.launches - launches0 < 8, "no scan batching happened"
        for b in range(8):
            assert results[b][0][7], b
            assert not results[b][1].any(), b

    def test_scan_does_not_block_behind_slow_pin(self, monkeypatch):
        """A cold pin's device upload must not stall concurrent warm scans."""
        cache = DeviceRowCache(256 << 20, device="cpu")
        cache.needle_cache_enabled = False
        data, offs, lens = block_of([{"m": f"warm tok_{i}"} for i in range(30)])
        warm_block = cache.pin((b"warm", 0), data, offs, lens)
        upload_started = threading.Event()
        release_upload = threading.Event()
        orig = rc._update_rows

        def slow_update(*a, **k):
            upload_started.set()
            assert release_upload.wait(timeout=10), "test deadlock"
            return orig(*a, **k)

        monkeypatch.setattr(rc, "_update_rows", slow_update)
        data2, offs2, lens2 = block_of([{"m": f"cold tok2_{i}"} for i in range(30)])
        pin_done = threading.Event()

        def cold_pin():
            cache.pin((b"cold", 0), data2, offs2, lens2)
            pin_done.set()

        t = threading.Thread(target=cold_pin, daemon=True)
        t.start()
        assert upload_started.wait(timeout=10)
        scan = cache.scan(warm_block, [b"tok_7\"", b"absent"])
        assert scan[0][7] and not scan[1].any()
        assert not pin_done.is_set(), "pin finished early; test proved nothing"
        release_upload.set()
        t.join(timeout=10)
        assert pin_done.is_set()
        assert cache.scan(cache.get((b"cold", 0)), [b"tok2_9\""])[0][9]

    def test_stale_block_after_eviction_is_conservative(self):
        cache = Pair(64 << 20)
        data, offs, lens = block_of([{"m": f"r{i}"} for i in range(5)])
        block = cache.pin((b"f", 0), data, offs, lens)
        cache.invalidate_file(b"f")
        assert cache.scan(block, [b"absent"]).all(), "stale block must be all-candidate"


class TestSparseSegmentScan:
    def test_sparse_request_on_big_stream_is_exact(self):
        """Few blocks of a big stream take the segment mode; results match
        the dense scan, the oracle and the JAX package bit for bit."""
        cache = Pair(1 << 30, needle_cache=False)
        blocks, datas = {}, {}
        NB, RPB = 40, 600
        for b in range(NB):
            data, offs, lens = block_of([{"m": f"blk{b} tok{b}_{i} " + "x" * 90} for i in range(RPB)])
            blocks[b] = cache.pin((f"f{b}".encode(), 0), data, offs, lens)
            datas[b] = (data, offs, lens)
        seg_chunks = max(512, 1 << (blocks[0][1].num_chunks - 1).bit_length())
        assert 2 * seg_chunks * 4 <= cache.port._bucket.cap, "grow the stream"
        for b in (0, 17, NB - 1):  # the last block's segment start clamps
            needles = [f"tok{b}_7 ".encode(), b"absent", f"blk{b} ".encode()]
            scan = cache.scan(blocks[b], needles)
            data, offs, lens = datas[b]
            for qi, nd in enumerate(needles):
                np.testing.assert_array_equal(
                    scan[qi], chunk_oracle(data, offs, lens, nd), err_msg=repr((b, nd))
                )
            assert scan[0][7] and not scan[1].any() and scan[2].all(), b
        out = cache.scan_many([blocks[3], blocks[29]], [b"tok3_11 ", b"tok29_0 "])
        assert out[blocks[3][1].key][0][11]
        assert not out[blocks[3][1].key][1].any()
        assert out[blocks[29][1].key][1][0]
        dense = cache.scan_many(list(blocks.values()), [b"tok17_7 "])
        sparse = cache.scan(blocks[17], [b"tok17_7 "])
        np.testing.assert_array_equal(dense[blocks[17][1].key][0], sparse[0])


class TestNeedleBitmapCache:
    def test_repeat_needle_skips_launch_until_matrix_changes(self):
        cache = Pair(64 << 20)
        data, offs, lens = block_of([{"m": f"tok{i} filler"} for i in range(40)])
        b0 = cache.pin((b"f0", 0), data, offs, lens)
        first = cache.scan(b0, [b"tok7 "])
        launches = cache.port.launches
        second = cache.scan(b0, [b"tok7 "])
        assert cache.port.launches == launches, "cached needle re-launched"
        np.testing.assert_array_equal(first, second)
        assert second[0][7]
        data2, offs2, lens2 = block_of([{"m": f"other{i}"} for i in range(10)])
        cache.pin((b"f1", 0), data2, offs2, lens2)
        third = cache.scan(b0, [b"tok7 "])
        assert cache.port.launches == launches + 1, "stale cache served after pin"
        np.testing.assert_array_equal(first, third)
        entry = cache.port._bucket.needle_cache[b"tok7 "]
        np.testing.assert_array_equal(entry[1], cache.ref._bucket.needle_cache[b"tok7 "][1])

    def test_disabled_cache_always_launches(self):
        cache = Pair(64 << 20, needle_cache=False)
        data, offs, lens = block_of([{"m": f"tok{i}"} for i in range(10)])
        b0 = cache.pin((b"f0", 0), data, offs, lens)
        cache.scan(b0, [b"tok3"])
        launches = cache.port.launches
        cache.scan(b0, [b"tok3"])
        assert cache.port.launches == launches + 1


class TestNeedleCacheByteCap:
    def test_cache_capped_by_total_bytes(self, monkeypatch):
        cache = DeviceRowCache(64 << 20, device="cpu")
        data, offs, lens = block_of([{"m": f"tok{i} word"} for i in range(500)])
        b0 = cache.pin((b"f0", 0), data, offs, lens)
        per_entry = -(-cache._bucket.cap // 32) * 4
        monkeypatch.setattr(rc, "_NEEDLE_CACHE_MAX_BYTES", per_entry * 3)
        for i in range(10):
            cache.scan(b0, [b"tok%d " % i])
        assert 1 <= len(cache._bucket.needle_cache) <= 3
        launches = cache.launches
        out = cache.scan(b0, [b"tok9 "])
        assert cache.launches == launches and out[0][9]


class TestReserve:
    def test_reserve_fixes_shape_and_rounds_down_to_budget(self):
        cache = Pair(300 << 10)
        got = cache.reserve(10_000_000)
        assert got * 512 <= 300 << 10 and got % 512 == 0
        assert cache.port._reserved_cap == got == cache.port._bucket.cap
        assert cache.port.stream_free_chunks() == got == cache.ref.stream_free_chunks()

    def test_reserve_small_dataset_covers_it(self):
        cache = Pair(1 << 30)
        got = cache.reserve(100)
        assert got >= 100 + 512 or got == 512 * 2
        data, offs, lens = block_of([{"m": f"r{i} data"} for i in range(50)])
        cache.pin((b"a", 0), data, offs, lens)
        cache.pin((b"b", 0), data, offs, lens)
        assert cache.port._bucket.cap == got

    def test_churn_keeps_shape_at_reserved_cap(self):
        cache = Pair(600 << 10)
        got = cache.reserve(10_000_000)
        data, offs, lens = block_of([{"m": "x" * 120 + f" blk r{i}"} for i in range(500)])
        for b in range(24):
            cache.pin((b"f%d" % b, 0), data, offs, lens)
        assert cache.port._bucket.cap == got
        assert cache.port.evictions > 0 and cache.port.compactions > 0
        last = cache.get((b"f23", 0))
        assert last is not None
        assert cache.scan(last, [b"blk r7"])[0].any()

    def test_slack_eviction_amortizes_compaction(self):
        """At-capacity pins evict with cap/8 slack, so compaction runs once
        per ~slack of churn, not once per pin."""
        cache = DeviceRowCache(8 << 20, device="cpu")
        cache.reserve(10_000_000)
        data, offs, lens = block_of([{"m": "x" * 120 + f" slk r{i}"} for i in range(500)])
        for b in range(200):
            cache.pin((b"s%d" % b, 0), data, offs, lens)
        assert 0 < cache.compactions <= 200 // 4
        last = cache.get((b"s199", 0))
        assert last is not None
        assert cache.scan(last, [b"slk r7"])[0].any()


class TestRelease:
    def test_release_frees_device_bytes_and_closes(self):
        cache = DeviceRowCache(8 << 20, device="cpu")
        data, offs, lens = block_of([{"m": f"rel row {i}"} for i in range(50)])
        block = cache.pin((b"rel", 0), data, offs, lens)
        assert cache.stats()["device_bytes"] > 0
        cache.release()
        st = cache.stats()
        assert st["device_bytes"] == 0 and st["pinned_blocks"] == 0
        assert cache._bucket.matrix is None
        with pytest.raises(RowCacheReleasedError, match="released"):
            cache.pin((b"rel2", 0), data, offs, lens)
        with pytest.raises(RowCacheReleasedError, match="released"):
            cache.reserve(1000)
        # A released cache resolves scans to "vanished": all-candidate.
        assert cache.scan(block, [b"absent"]).all()
        cache.release()  # idempotent

    def test_engine_stop_releases_device_caches(self, tmp_path):
        store = bt.FileSystemDataStore(str(tmp_path))
        cfg = bt.BloomSearchEngineConfig(row_cache_bytes=8 << 20, device="cpu")
        eng = bt.BloomSearchEngine(cfg, store, store)
        eng.start()
        eng.ingest_rows([{"m": f"stoprel {i}"} for i in range(500)])
        eng.flush()
        assert len(eng.query_sync(bt.new_query().token("stoprel").build())) == 500
        rc_, backend = eng._row_cache, eng._device_backend
        assert rc_ is not None and backend is not None
        eng.stop()
        assert rc_.stats()["device_bytes"] == 0
        assert backend.total_bytes() == 0


class TestChurnAdmission:
    def test_bg_pins_rate_limited_at_capacity(self, tmp_path):
        store = bt.FileSystemDataStore(str(tmp_path))
        cfg = bt.BloomSearchEngineConfig(
            row_cache_bytes=4 << 20, probe_backend="device", device="cpu"
        )
        eng = bt.BloomSearchEngine(cfg, store, store)
        eng.start()
        try:
            cache = eng._row_cache
            # 3,584 chunks: the live stream plus its host shadows stay under
            # the 4 MB budget while the reservation fills.
            assert cache.reserve(3000) == 3584
            assert eng._bg_churn_admit(1000)
            data, offs, lens = block_of(
                [{"m": "churn filler " + "y" * 100 + f" r{i}"} for i in range(300)]
            )
            for b in range(100):
                if (cache.stream_free_chunks() or 0) <= 1024:
                    break
                cache.pin((b"churn%d" % b, 0), data, offs, lens)
            assert cache.stream_free_chunks() <= 1024
            assert not eng._bg_churn_admit(1 << 20)
            assert eng.stats()["background_pins_churn_skipped"] == 1
            eng._pin_churn.t -= 60.0
            assert eng._bg_churn_admit(1 << 20)
            assert eng._pin_churn.tokens < 0
            assert not eng._bg_churn_admit(300_000)
            eng._pin_churn.t -= 420.0
            assert eng._bg_churn_admit(300_000)
        finally:
            eng.stop()


class TestUnpackBitRange:
    def test_matches_full_unpack_at_random_offsets(self):
        rng = np.random.default_rng(11)
        raw = rng.integers(0, 256, size=4096, dtype=np.uint8)
        full = np.unpackbits(raw, bitorder="little").astype(bool)
        for _ in range(200):
            start = int(rng.integers(0, raw.size * 8 - 1))
            n = int(rng.integers(0, min(2048, raw.size * 8 - start)))
            got = _unpack_bit_range(raw, start, n)
            np.testing.assert_array_equal(got, full[start : start + n])
            np.testing.assert_array_equal(got, rc_ref._unpack_bit_range(raw, start, n))
        assert _unpack_bit_range(raw, 17, 0).shape == (0,)


class TestFromReference:
    def test_one_state_scans_alike_in_both_packages(self):
        """rowcache_from_reference copies a JAX cache's resident state
        (after a reservation, evictions and a compaction): both packages
        then scan it alike and keep agreeing through a further pin."""
        ref = rc_ref.DeviceRowCache(4 << 20, mesh_devices=1)
        assert ref.reserve(1000) == 1536  # ~11 of the 134-chunk blocks
        data, offs, lens = block_of([{"m": "x" * 120 + f" ref r{i}"} for i in range(500)])
        for b in range(12):
            ref.pin((b"r%d" % b, 0), data, offs, lens)
        ref.invalidate_file(b"r10")
        assert ref.evictions > 0 and ref.compactions > 0 and ref._bucket.dead > 0
        pair = Pair(4 << 20)
        pair.ref = ref
        pair.port = rowcache_from_reference(ref, "cpu")
        assert pair.port._bucket.matrix.dtype == torch.int32
        np.testing.assert_array_equal(port_matrix(pair.port), np.asarray(ref._bucket.matrix))
        # Counters start at zero in the copy: compare from here on.
        for name in ("launches", "scan_requests", "pins", "evictions", "compactions"):
            setattr(pair.port, name, getattr(ref, name))
        pair.check()
        blocks = [(ref._blocks[k], pair.port._blocks[k]) for k in list(ref._blocks)]
        pair.scan_many(blocks, [b"ref r7", b"absent", b"ref r49"])
        pair.scan(blocks[-1], [b"ref r3"])
        pair.pin((b"new", 0), data, offs, lens)
        pair.scan(pair.get((b"new", 0)), [b"ref r7"])

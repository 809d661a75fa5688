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


def spy_plans(monkeypatch, plans: list) -> None:
    """Record every scan plan call's launches in ``plans`` (each launch as
    (first word, [(base pointer, first row, rows), ...])) and count each
    launch in ``kernels.scan`` as the wrapper does on the card: the CPU's
    plain version counts nothing."""
    from bloomsearch_tpu_torch.kernels import scan as ks
    from bloomsearch_tpu_torch.parallel import mesh as pm

    orig = pm.byte_scan_plan_into

    def plan_into(out, plan, needles, lens, *, n_real, count_as="segments"):
        plans.append([(w, [(b.data_ptr(), s, c) for b, s, c in ranges]) for w, ranges in plan])
        for _, ranges in plan:
            ks._count(count_as, sum(c for _, _, c in ranges), n_real, ks.launched_ranges(ranges))
        return orig(out, plan, needles, lens, n_real=n_real, count_as=count_as)

    monkeypatch.setattr(pm, "byte_scan_plan_into", plan_into)


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
        """No card: "cuda" raises. The mesh is ported now: mesh_devices=2 on
        the CPU shards the stream's chunk axis over two CPU shards."""
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                DeviceRowCache(1 << 20)
        data, offsets, lengths = block_of([{"k": "device"}])
        cache = DeviceRowCache(1 << 20, mesh_devices=2, device="cpu")
        cache.pin((b"f", 0), data, offsets, lengths)
        shards = cache._bucket.matrix
        assert cache._bucket.cap == 1024
        assert [s.shape for s in shards] == [(512, CHUNK_BYTES // 4)] * 2


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
        orig = rc.sharded_update_rows

        def slow_update(*a, **k):
            upload_started.set()
            assert release_upload.wait(timeout=10), "test deadlock"
            return orig(*a, **k)

        monkeypatch.setattr(rc, "sharded_update_rows", slow_update)
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

    def test_sparse_launch_reads_only_the_requested_ranges(self, monkeypatch):
        """A sparse launch takes each requested range as it is (rounded up
        to 32 chunks and clamped into the stream, ``segment_layout``) and
        only the real needles, as one launch of the sparse scan's plan on
        the one stream tensor (``sharded_scan_segments`` with no mesh); the
        choice of sparse or dense per request is the JAX row cache's (a spy
        on its ``_scan`` and ``_scan_segments``), and the candidate matrices
        equal its own (``Pair``). On the CPU the wrappers count nothing, so
        the spy counts each launch of the plan as the wrapper does on the
        card: the "segments" shape keys are the single-device launch's, and
        a dense request is one "stream" launch of one range over the whole
        stream (``sharded_scan_all_rows`` with no mesh), a dense-mode
        record."""
        from bloomsearch_tpu_torch.kernels import scan as ks
        from bloomsearch_tpu_torch.parallel import mesh as pm

        cache = Pair(1 << 30, needle_cache=False)
        blocks = {}
        for b in range(40):
            # Blocks of unequal sizes, so the ranges differ in length.
            data, offs, lens = block_of(
                [{"m": f"blk{b} tok{b}_{i} " + "x" * 90} for i in range(300 + 40 * (b % 7))])
            blocks[b] = cache.pin((f"f{b}".encode(), 0), data, offs, lens)
        modes = {"ref": [], "port": []}
        for name in ("_scan", "_scan_segments"):
            orig = getattr(cache.ref, name)
            setattr(cache.ref, name,
                    lambda *a, _o=orig, _n=name, **k: modes["ref"].append(_n) or _o(*a, **k))
        orig_dense, orig_sparse = rc.sharded_scan_all_rows, rc.sharded_scan_segments
        plans = []

        def sparse(mesh, rows32, *a, **k):
            assert mesh is None and isinstance(rows32, torch.Tensor)  # one device, one shard
            modes["port"].append("_scan_segments")
            return orig_sparse(mesh, rows32, *a, **k)

        def dense(mesh, rows32, *a, **k):
            assert mesh is None and isinstance(rows32, torch.Tensor)
            modes["port"].append("_scan")
            return orig_dense(mesh, rows32, *a, **k)

        monkeypatch.setattr(rc, "sharded_scan_segments", sparse)
        monkeypatch.setattr(rc, "sharded_scan_all_rows", dense)
        spy_plans(monkeypatch, plans)
        needles = [b"tok3_11 ", b"blk", b"absent", b"x"]
        seen = []
        for picked in ((3,), (3, 29), (0, 17, 39), (1, 2, 5, 6), (1, 2, 5, 6, 8),
                       tuple(range(40))):
            ks.reset_launch_counts()
            modes["ref"].clear()
            modes["port"].clear()
            plans.clear()
            cache.scan_many([blocks[b] for b in picked], needles)
            assert modes["port"] == modes["ref"], picked
            seen += modes["port"]
            if modes["port"] == ["_scan_segments"]:
                segs = sorted(cache.port._bucket.segments[blocks[b][1].key] for b in picked)
                counts = tuple(-(-n // 32) * 32 for _, n in segs)
                matrix = cache.port._bucket.matrix
                read, rounded = ks.segment_layout([s for s, _ in segs], [n for _, n in segs],
                                                  matrix.shape[0])
                assert plans == [[(0, [(matrix.data_ptr(), r, n)
                                       for r, n in zip(read, rounded)])]]
                assert ks.launch_shapes() == {
                    ("segments", sum(counts), len(needles), len(segs), counts): 1
                }, picked
            else:
                G = cache.port._bucket.matrix.shape[0]
                assert plans == [[(0, [(cache.port._bucket.matrix.data_ptr(), 0, G)])]]
                assert ks.launch_shapes() == {("stream", G, len(needles), 0, ()): 1}, picked
        # One to four blocks scan sparse; five and all forty dense.
        assert seen == ["_scan_segments"] * 4 + ["_scan"] * 2
        ks.reset_launch_counts()

    def test_a_mesh_chooses_sparse_where_one_device_does(self, monkeypatch):
        """A 4-shard CPU mesh holding the JAX single-device cache's state
        (``rowcache_from_reference``): request by request the port scans
        sparse exactly where the JAX cache does (a spy on its ``_scan`` and
        ``_scan_segments``), each sparse call reads just the requested
        ranges' pieces (``segment_pieces``), ranges across a shard boundary
        included, in ceil(pieces / 4) launches, and the candidate matrices
        equal the JAX cache's."""
        from bloomsearch_tpu_torch.kernels import scan as ks
        from bloomsearch_tpu_torch.parallel import mesh as pm

        ref = rc_ref.DeviceRowCache(1 << 30, mesh_devices=1)
        ref.needle_cache_enabled = False
        for b in range(40):
            data, offs, lens = block_of(
                [{"m": f"blk{b} tok{b}_{i} " + "x" * 90} for i in range(300 + 40 * (b % 7))])
            ref.pin((f"f{b}".encode(), 0), data, offs, lens)
        port = rowcache_from_reference(ref, "cpu", mesh=pm.default_mesh(4, "cpu"))
        port.needle_cache_enabled = False
        cap = port._bucket.cap
        assert cap == ref._bucket.cap and len(port._bucket.matrix) == 4
        shard_rows = cap // 4
        keys = list(ref._blocks)
        segs = [ref._bucket.segments[k] for k in keys]
        straddling = [b for b, (s, n) in enumerate(segs)
                      if s // shard_rows != (s + n - 1) // shard_rows]
        assert straddling, "no block crosses a shard boundary: change the blocks"
        modes = {"ref": [], "port": []}
        for name in ("_scan", "_scan_segments"):
            orig = getattr(ref, name)
            setattr(ref, name,
                    lambda *a, _o=orig, _n=name, **k: modes["ref"].append(_n) or _o(*a, **k))
        for name, mode in (("sharded_scan_segments", "_scan_segments"),
                           ("sharded_scan_all_rows", "_scan")):
            orig = getattr(rc, name)

            def spy(mesh, *a, _o=orig, _m=mode, **k):
                assert mesh is port.mesh  # no single-device call on a mesh
                modes["port"].append(_m)
                return _o(mesh, *a, **k)

            monkeypatch.setattr(rc, name, spy)
        launched = []
        orig_plan = pm.byte_scan_plan_into
        monkeypatch.setattr(pm, "byte_scan_plan_into", lambda out, plan, *a, **k: (
            launched.extend([(b.data_ptr(), int(s), int(c)) for b, s, c in ranges]
                            for _, ranges in plan)
            or orig_plan(out, plan, *a, **k)))
        needles = [b"tok3_11 ", b"blk", b"absent", b"x"]
        seen, sparse_straddling = [], 0
        first = straddling[0]
        for picked in ((first,), (3, first), (0, 17, 39), (1, 2, 5, 6), (1, 2, 5, 6, 8),
                       tuple(range(40))):
            modes["ref"].clear()
            modes["port"].clear()
            launched.clear()
            want = ref.scan_many([ref._blocks[keys[b]] for b in picked], needles)
            got = port.scan_many([port._blocks[keys[b]] for b in picked], needles)
            assert list(got) == list(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=repr((picked, key)))
            assert modes["port"] == modes["ref"], picked
            seen += modes["port"]
            if modes["port"] == ["_scan_segments"]:
                ranges = sorted(segs[b] for b in picked)
                pieces, _ = pm.segment_pieces([s for s, _ in ranges], [n for _, n in ranges],
                                              shard_rows, 4)
                reads = [r for launch in launched for r in launch]
                assert reads == [(port._bucket.matrix[i].data_ptr(), r, n)
                                 for i, r, n in pieces], picked
                assert len(launched) == -(-len(pieces) // ks.MAX_SEGMENTS)
                sparse_straddling += any(b in straddling for b in picked)
            else:
                assert launched == [[(m.data_ptr(), 0, shard_rows) for m in port._bucket.matrix]]
        # One to four blocks scan sparse; five and all forty dense.
        assert seen == ["_scan_segments"] * 4 + ["_scan"] * 2
        assert sparse_straddling >= 2


# Eleven distinct needles of several lengths: unions of 9-11 take a launch
# of 8 and one of the rest.
UNION_NEEDLES = [b"blk%d " % b for b in range(6)] + [b"tok3_7 ", b"absent", b"xxxx",
                                                     b"tok5_", b"zz"]


def small_state(shards: int, needle_cache: bool):
    """Six small blocks pinned in a JAX single-device cache whose stream is
    reserved large enough that a one-block request scans sparse, and the
    port's copy of it (``rowcache_from_reference``): on one CPU device, or
    on a 4-shard CPU mesh. -> (ref, port, keys)."""
    from bloomsearch_tpu_torch.parallel import mesh as pm

    ref = rc_ref.DeviceRowCache(1 << 30, mesh_devices=1)
    assert ref.reserve(2048) == 2560
    for b in range(6):
        data, offs, lens = block_of([{"m": f"blk{b} tok{b}_{i} " + "x" * 40} for i in range(40)])
        ref.pin((f"f{b}".encode(), 0), data, offs, lens)
    port = rowcache_from_reference(
        ref, "cpu", mesh=pm.default_mesh(shards, "cpu") if shards > 1 else None)
    ref.needle_cache_enabled = port.needle_cache_enabled = needle_cache
    return ref, port, list(ref._blocks)


def scan_both(ref, port, keys, needles) -> None:
    """The same request to both caches: equal candidate matrices."""
    want = ref.scan_many([ref._blocks[k] for k in keys], needles)
    got = port.scan_many([port._blocks[k] for k in keys], needles)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=repr((needles, key)))


class TestRealNeedles:
    @pytest.mark.parametrize("shards", [1, 4])
    def test_needle_cache_keeps_its_own_copy_of_each_row(self, monkeypatch, shards):
        """A dense scan's rows enter the needle cache as copies: each entry
        owns its bytes and shares no memory with any launch output, so the
        cache's byte budget (monkeypatched to three rows) bounds what it
        holds; candidate matrices equal the JAX cache's, from the cache
        too."""
        ref, port, keys = small_state(shards, needle_cache=True)
        per_entry = port._bucket.cap // 32 * 4
        monkeypatch.setattr(rc, "_NEEDLE_CACHE_MAX_BYTES", per_entry * 3)
        outs = []
        orig = rc.sharded_scan_all_rows
        monkeypatch.setattr(rc, "sharded_scan_all_rows",
                            lambda *a, **k: outs.append(orig(*a, **k)) or outs[-1])
        for needles in (UNION_NEEDLES[:3], UNION_NEEDLES[3:8], UNION_NEEDLES[8:],
                        UNION_NEEDLES[9:]):
            scan_both(ref, port, keys, needles)
            cache = port._bucket.needle_cache
            assert cache and sum(e[1].nbytes for e in cache.values()) <= per_entry * 3
            for needle, (_, row) in cache.items():
                assert row.flags.owndata and row.base is None, needle
                assert not any(np.shares_memory(row, o.numpy()) for o in outs), needle
        assert len(outs) == 3  # the last request was served from the cache

    @pytest.mark.parametrize("shards", [1, 4])
    def test_dense_launches_take_only_their_real_needles(self, monkeypatch, shards):
        """Unions of 1 to 11 needles, over every block (dense) and over one
        (sparse): each request scans in the JAX cache's mode, in launches
        of the JAX package's groups (8 needles sorted by length, then the
        rest, as its Pallas path launches them), each launch's
        n_real is its part's real needle count (8, then the rest; a spy
        counts the plan's launches as the card wrapper does) with no
        padding row, and the candidate matrices equal the JAX cache's."""
        from bloomsearch_tpu_torch.kernels import scan as ks

        ref, port, keys = small_state(shards, needle_cache=False)
        modes = {"ref": [], "port": []}
        for name in ("_scan", "_scan_segments"):
            orig = getattr(ref, name)
            setattr(ref, name,
                    lambda *a, _o=orig, _n=name, **k: modes["ref"].append(_n) or _o(*a, **k))
        for name, mode in (("sharded_scan_all_rows", "_scan"),
                           ("sharded_scan_segments", "_scan_segments")):
            orig = getattr(rc, name)

            def spy(*a, _o=orig, _m=mode, n_real, **k):
                lens = a[-1]  # (mesh, rows32, [seg_starts,] needles, lens)
                assert len(lens) == n_real and np.asarray(lens).all()  # no padding row
                modes["port"].append(_m)
                return _o(*a, n_real=n_real, **k)

            monkeypatch.setattr(rc, name, spy)
        spy_plans(monkeypatch, [])
        G, rows = port._bucket.cap, port._bucket.cap // shards
        for k in range(1, len(UNION_NEEDLES) + 1):
            parts = [min(ks.MAX_SCAN_NEEDLES, k - i) for i in range(0, k, ks.MAX_SCAN_NEEDLES)]
            for picked, mode in ((keys, "_scan"), (keys[2:3], "_scan_segments")):
                modes["ref"].clear()
                modes["port"].clear()
                ks.reset_launch_counts()
                scan_both(ref, port, picked, UNION_NEEDLES[:k])
                # The JAX cache's XLA path on the CPU takes up to 64
                # needles a launch, its Pallas path 8, as the port does.
                assert modes["port"] == [mode] * len(parts) and modes["ref"] == [mode], (k, mode)
                n_reals = sorted(key[2] for key, n in ks.launch_shapes().items() for _ in range(n))
                assert n_reals == sorted(parts), (k, mode)
                if mode == "_scan":  # a dense record, or one launch over the card's 4 shards
                    want = (0, ()) if shards == 1 else (shards, (rows,) * shards)
                    assert {key[3:] for key in ks.launch_shapes()} == {want}
                    assert ks.launch_counts() == {"stream": len(parts), "segments": 0}
        ks.reset_launch_counts()

    def test_one_card_dense_scan_is_one_plan_launch_over_the_stream(self, monkeypatch):
        """On one device a dense request and the warmup's dense launch
        (``precompile_scan_programs``) are each one launch of the plan
        entry: one range over the whole stream from word 0, a dense-mode
        record (``n_ranges`` 0), counted as a "stream" launch of the kernel
        (a spy counts as the card wrapper does) and never as a mesh call,
        which a 4-shard mesh's dense call is (``_count`` made to count on
        the CPU too)."""
        from bloomsearch_tpu_torch.kernels import scan as ks
        from bloomsearch_tpu_torch.parallel import mesh as pm

        ref, port, keys = small_state(1, needle_cache=False)
        plans = []
        spy_plans(monkeypatch, plans)
        monkeypatch.setattr(pm, "_count", lambda name, shards: pm._launches.__setitem__(
            name, pm._launches[name] + 1))
        pm.reset_launch_counts()
        ks.reset_launch_counts()
        matrix = port._bucket.matrix
        G = matrix.shape[0]
        scan_both(ref, port, keys, UNION_NEEDLES[:3])
        assert plans == [[(0, [(matrix.data_ptr(), 0, G)])]]
        assert ks.launch_shapes() == {("stream", G, 3, 0, ()): 1}
        records = ks.plan_records([(0, [(matrix, 0, G)])], {matrix.device: 0})
        assert (records[0].n_ranges, records[0].base[0], records[0].rows_total) == (
            0, matrix.data_ptr(), G)
        plans.clear()
        assert port.precompile_scan_programs([port._blocks[k] for k in keys]) == 2
        assert plans[0] == [(0, [(matrix.data_ptr(), 0, G)])]
        assert pm.launch_counts()["sharded_scan_all_rows"] == 0
        mesh = pm.default_mesh(4, "cpu")
        stream = pm.sharded_update_rows(mesh, pm.sharded_zeros_rows(mesh, G),
                                        matrix.numpy(), 0)
        padded, lens = np.zeros((1, 32), np.int32), np.array([3], np.int32)
        padded[0, :3] = list(b"blk")
        np.testing.assert_array_equal(
            pm.sharded_scan_all_rows(mesh, stream, padded, lens, n_real=1).numpy(),
            pm.sharded_scan_all_rows(None, matrix, padded, lens, n_real=1).numpy())
        assert pm.launch_counts()["sharded_scan_all_rows"] == 1
        pm.reset_launch_counts()
        ks.reset_launch_counts()


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

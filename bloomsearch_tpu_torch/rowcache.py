"""Device row cache: device-pinned row data with on-device candidate scanning.

Serving mode for hot data. The host candidate scan (scan.py) avoids
JSON-parsing non-matching rows but still burns host CPU re-reading and
re-scanning block bytes on every query. Here a block's decompressed row
buffer is pinned on the device **once** -- lowercased and chunked into
overlapped 512-byte stream chunks packed 4-bytes-per-int32 and appended to
ONE shared stream matrix ``int32[cap_chunks, 128]`` on ``device`` -- and each
query's needle scan runs as ONE launch of the stream byte-scan kernel
(``kernels/scan.py``, ``csrc/scan.cu``) over the resident stream, or over
just the requested blocks' segments when they are a small fraction of it:

- **Stream chunks, not width-bucketed row matrices**: each chunk carries
  STREAM_STRIDE=480 payload bytes plus the next 32 bytes duplicated, so
  every <=32-byte window starting in the payload region is contained in
  exactly one chunk. Rows are not padded to a width class, so the stream is
  ~1.07x the raw bytes.
- The kernel emits per-CHUNK hit bits; a hit in chunk c means a match
  starting somewhere in its payload, so the candidate rows are every row
  overlapping bytes [c*480, c*480+480+len-1) -- the same span-overlap
  marking rule as the host scanner (bs_scan_candidates / scan.py), made
  conservative at chunk granularity. Exact verification downstream keeps
  zero false positives; chunk granularity only ever ADDS candidates.
- all of a query's needles scan together (up to MAX_SCAN_NEEDLES per
  launch), and
- concurrent block scans coalesce through a windowless leader-drains-queue
  combiner (the same design as the probe-launch batcher in bloom/bank.py):
  the leader launches once with the UNION of pending queries' needles and
  every waiter slices out its blocks' chunk spans.

Conservative-by-construction like scan.py: rows whose bytes can't prove
needle absence (non-ASCII, \\uXXXX / \\/ escapes) are always-candidates,
needles longer than MAX_NEEDLE fall back to always-candidate, and the exact
verification stage still runs on every candidate. Cross-row and
length-prefix bytes in the stream can only create false positives (rejected
by verification), never hide a true match.

This is the JAX package's ``rowcache.py`` on PyTorch. The host logic
(packing, the combiner, the needle-bitmap cache, the sparse/dense choice,
eviction, reservation, compaction) is unchanged; capacities stay multiples
of the 512 × mesh-size chunk unit and pins upload in the same pow2 pieces,
so capacities, segment coordinates and ``stats()`` equal the JAX package's
for the same pins and mesh size, and there is no per-shape compile.

The matrix lives on one device, or with a mesh (``mesh_devices``,
parallel/mesh.py) it shards its chunk axis: a tuple of ``int32[cap / n,
128]`` shards, shard i holding logical chunks ``[i*cap/n, (i+1)*cap/n)``
on mesh device i. Pins, growth and compaction keep it sharded (a pin's
rows may straddle shards). A mesh chooses sparse or dense by the
single-device rule: a dense scan covers every shard
(``sharded_scan_all_rows``), a sparse one reads just the requested ranges
on the cards that hold them (``sharded_scan_segments``), where the
reference scans every shard in full. On one device both are the same
calls on the one stream tensor (one launch, into page-locked host memory,
issued and waited for in one foreign call).

Snapshot consistency without immutable arrays (the rule of bloom/bank.py):
a scan captures ``matrix`` (the whole tuple of shards on a mesh) and the
segment placements under the lock and may launch after the lock is
released. Growth, reservation and compaction therefore always allocate NEW
tensors; a pin writes in place only into slack rows at or past ``used``,
which no published segment covers, and publishes the new segment (with a
version bump that clears the needle cache) only after its upload. Uploads,
compaction gathers, scan launches and their device-to-host copies all run
on each device's current stream (no code here switches streams), so a
tensor freed by compaction or release() is never handed out again before a
launch that reads it ends.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from . import native as _native
from .kernels import scan as _scan_kernel
from .kernels.scan import MAX_SCAN_NEEDLES
from .parallel.mesh import (
    logical_size,
    mesh_for,
    sharded_pad_rows,
    sharded_scan_all_rows,
    sharded_scan_segments,
    sharded_take_rows,
    sharded_update_rows,
    sharded_zeros_rows,
)
from .utils import remember

# Stream chunk geometry: 512-byte physical rows (128 packed int32 words, one
# scan-kernel warp's load); the last MAX_NEEDLE bytes of each chunk
# duplicate the next chunk's head so windows never straddle a chunk.
CHUNK_BYTES = 512
MAX_NEEDLE = 32  # longer needles fall back to always-candidate
STREAM_STRIDE = CHUNK_BYTES - MAX_NEEDLE  # payload bytes per chunk (480)
# Per-needle bitmap cache entries (packed ~cap_chunks/8 bytes each). The
# byte cap dominates at large streams: a 10 GB stream's ~21M-chunk bitmaps
# are ~2.6 MB each, so 128 entries would silently hold ~340 MB of host RAM.
_NEEDLE_CACHE_MAX = 128
_NEEDLE_CACHE_MAX_BYTES = 32 << 20
# Sparse segment scans above this many (pow2-bucketed) segments fall back
# to the dense scan (the kernel's segment mode takes at most 4).
_SPARSE_MAX_SEGS = 4
# Stream growth increment once doubling would exceed this many bytes (the
# grow-copy holds old+new matrices concurrently in device memory).
_GROWTH_STEP_BYTES = 512 << 20
# Total seconds a background pin may spend paused at its yield points
# waiting for in-flight queries to drain. Bounded so a pin holding
# _upload_lock can never stall invalidate_file (merge tombstones) or other
# pins indefinitely under a saturating query stream.
_PIN_YIELD_MAX_S = 5.0


def _yield_point(yield_to, deadline: float, hurry=None) -> None:
    """Pause while ``yield_to()`` is truthy (queries in flight), up to
    ``deadline``. Background pins call this before each expensive device
    step so query probe/scan launches never queue behind multi-MB stream
    uploads or compaction gathers on the single device stream.

    ``hurry()`` truthy ends the pause immediately: a FOREGROUND caller
    (query-path sync pin, tombstone, shutdown) is blocked on _upload_lock
    — which this background holder owns — so sleeping "for the query"
    would be a priority inversion: the query can't finish precisely
    because we're waiting for it to finish."""
    if yield_to is None:
        return
    while time.monotonic() < deadline:
        if hurry is not None and hurry():
            return
        try:
            if not yield_to():
                return
        except Exception:
            return
        time.sleep(0.005)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _unpack_bit_range(raw_u8: np.ndarray, start: int, n: int) -> np.ndarray:
    """bool[n] slice [start, start+n) of a little-endian packed bitmap.

    Unpacks ONLY the covering bytes: a needle query touches a few blocks'
    chunk spans, while the packed bitmap covers full residency (~18M bits
    at xlscale) — unpacking it whole cost milliseconds of host CPU per
    needle per launch on the warm-query critical path, worst for cached
    needles re-unpacked every query."""
    if n <= 0:
        return np.zeros(0, dtype=bool)
    b0 = start >> 3
    b1 = (start + n + 7) >> 3
    bits = np.unpackbits(raw_u8[b0:b1], bitorder="little")
    lo = start - (b0 << 3)
    return bits[lo : lo + n].astype(bool)


def _pack_stream_numpy(
    data: bytes, row_offsets: np.ndarray, row_lengths: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The semantic spec for native bs_pack_stream (bit-parity asserted in
    tests): lowered overlapped chunks + conservative always-candidate flags."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    lowered = np.where((buf >= 65) & (buf <= 90), buf + 32, buf).astype(np.uint8)
    n_chunks = -(-n // STREAM_STRIDE) if n else 0
    chunks = np.zeros((max(n_chunks, 1), CHUNK_BYTES), dtype=np.uint8)
    if n_chunks:
        padded = np.zeros(n_chunks * STREAM_STRIDE + MAX_NEEDLE, dtype=np.uint8)
        padded[:n] = lowered
        chunks[:n_chunks] = np.lib.stride_tricks.as_strided(
            padded, shape=(n_chunks, CHUNK_BYTES), strides=(STREAM_STRIDE, 1)
        )
    num_rows = row_offsets.shape[0]
    flags = np.zeros(num_rows, dtype=bool)
    if num_rows:
        off = row_offsets.astype(np.int64)
        ln = row_lengths.astype(np.int64)
        # Defensive: rows pointing outside the buffer conservatively include.
        bad = (off < 0) | (ln < 0) | (off + ln > n)
        if n:
            # Rows whose stored bytes cannot PROVE a needle's absence: raw
            # non-ASCII bytes (Unicode lowercase may be pure ASCII, e.g.
            # U+212A -> 'k') and \uXXXX / \/ escapes (may hide printable-
            # ASCII needle bytes; the pair's second byte is compared lowered
            # so "\\U" flags exactly like "\\u"). A per-byte pair test
            # over-approximates the escape-aware walk (a literal "\\u" also
            # flags) — conservative is correct here.
            nonascii = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(buf >= 0x80, out=nonascii[1:])
            nxt = np.empty_like(lowered)
            nxt[:-1] = lowered[1:]
            nxt[-1] = 0
            pair = (buf == ord("\\")) & ((nxt == ord("u")) | (nxt == ord("/")))
            pairs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(pair, out=pairs[1:])
            start = np.clip(off, 0, n)
            end = np.clip(off + ln, start, n)
            flags |= (nonascii[end] - nonascii[start]) > 0
            # Pairs must sit WITHIN the row: positions [off, off+len-2].
            pe = np.maximum(end - 1, start)
            flags |= (pairs[pe] - pairs[start]) > 0
        flags |= bad
    return chunks, flags


def pack_block(
    data, row_offsets: np.ndarray, row_lengths: np.ndarray
) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack one block's row buffer into serving-stream form.

    -> (chunks uint8[max(n_chunks,1), CHUNK_BYTES], always_candidate
    bool[num_rows], n_chunks). Pure function of the block bytes — what the
    restart sidecar (servingcache.py) persists; pin() calls it when the
    caller didn't supply ``prepacked``.
    """
    nat = (
        _native.pack_stream(
            data, row_offsets, row_lengths, STREAM_STRIDE, CHUNK_BYTES
        )
        if _native.available()
        else None
    )
    if nat is not None:
        # Native single pass: chunk + lowercase + conservative flags at
        # GB/s; _pack_stream_numpy is the spec (parity tested).
        chunks, flags = nat
        always_candidate = flags.astype(bool)
    else:
        chunks, always_candidate = _pack_stream_numpy(
            data, row_offsets, row_lengths
        )
    n_chunks = -(-len(data) // STREAM_STRIDE) if data is not None and len(data) else 0
    return chunks, always_candidate, n_chunks


class RowCacheReleasedError(RuntimeError):
    """Raised by pin() and reserve() after release() (engine shutdown):
    warmup and background pins that race the shutdown stop quietly on it;
    every other device error propagates."""


class _PinnedBlock:
    __slots__ = (
        "key", "num_chunks", "num_rows", "always_candidate",
        "nbytes", "host_nbytes", "data", "fetcher",
        "row_offsets", "row_lengths", "_row_ends",
    )

    def __init__(self, key, num_chunks, num_rows, always_candidate,
                 data, row_offsets, row_lengths, fetcher=None):
        # The block's chunk placement lives ONLY in the stream bucket's
        # segments map (snapshot under the cache lock) — never on the block
        # object, where an unsynchronized copy would go stale under
        # compaction.
        self.key = key
        self.num_chunks = num_chunks
        self.num_rows = num_rows
        self.always_candidate = always_candidate  # bool[num_rows]
        # Candidate extraction source — exactly one of the two:
        #  - data: host shadow of the decompressed block bytes;
        #  - fetcher(idx, offsets, lengths) -> (buffer, local_off, local_len):
        #    on-demand ranged re-read of candidate rows from the store
        #    (shadow-free serving drops the ~1.2x-of-raw host copy).
        self.data = data
        self.fetcher = fetcher
        self.row_offsets = row_offsets
        self.row_lengths = row_lengths
        self._row_ends = None  # lazy: row_offsets + row_lengths
        self.host_nbytes = (
            (len(data) if data is not None else 0)
            + row_offsets.nbytes
            + row_lengths.nbytes
            + (always_candidate.nbytes if hasattr(always_candidate, "nbytes") else 0)
        )
        self.nbytes = num_chunks * CHUNK_BYTES + self.host_nbytes

    def fetch_rows(self, idx) -> tuple:
        """-> (buffer, offsets, lengths) for the given row indices; offsets
        are local to the returned buffer."""
        return self.fetcher(idx, self.row_offsets, self.row_lengths)

    def row_ends(self) -> np.ndarray:
        if self._row_ends is None:
            self._row_ends = (
                self.row_offsets.astype(np.int64)
                + self.row_lengths.astype(np.int64)
            )
        return self._row_ends


def _expand_chunk_hits(
    block: _PinnedBlock, needle_len: int, chunk_bits: np.ndarray
) -> np.ndarray:
    """Chunk hit bits -> conservative bool[num_rows] candidates.

    A hit in chunk c is a match starting in its payload, so the matched
    span lies within bytes [c*STRIDE, c*STRIDE + STRIDE + len - 1); every
    row overlapping that range is a candidate (span-overlap marking, the
    host scanner's mark_rows rule at chunk granularity)."""
    out_rows = block.num_rows
    hc = np.flatnonzero(chunk_bits[: block.num_chunks])
    if hc.size == 0 or out_rows == 0:
        return np.zeros(out_rows, dtype=bool)
    starts = hc.astype(np.int64) * STREAM_STRIDE
    ends = starts + STREAM_STRIDE + needle_len - 1
    lo = np.searchsorted(block.row_ends(), starts, side="right")
    hi = np.searchsorted(block.row_offsets, ends, side="left")
    marks = np.zeros(out_rows + 1, dtype=np.int32)
    np.add.at(marks, lo, 1)
    np.add.at(marks, hi, -1)
    return np.cumsum(marks[:-1]) > 0


class _StreamBucket:
    """The shared stream matrix; blocks occupy contiguous chunk ranges."""

    __slots__ = (
        "matrix", "cap", "used", "dead", "segments",
        "pending", "launch_lock", "version", "needle_cache",
    )

    def __init__(self):
        # Packed chunk bytes, [cap, 128] int32; cap, used, dead, and
        # segment coordinates are all in CHUNKS.
        self.matrix = None
        self.cap = 0
        self.used = 0
        self.dead = 0
        self.segments: dict[tuple, tuple[int, int]] = {}  # key -> (start, n)
        # Cross-query scan combiner state (guarded by the cache lock /
        # launch_lock — see DeviceRowCache.scan).
        self.pending: list["_PendingScan"] = []
        self.launch_lock = threading.Lock()
        # Needle-bitmap cache: scan-all computes hits for EVERY resident
        # chunk, so a needle's packed bitmap stays valid until the matrix
        # changes. version bumps on every matrix reassignment; entries are
        # {needle: (version, packed uint32[cap/32])}, LRU-capped.
        self.version = 0
        self.needle_cache: dict[bytes, tuple[int, np.ndarray]] = {}


class _PendingScan:
    __slots__ = ("keys", "needles", "done", "hits", "segments", "error")

    def __init__(self, keys: list[tuple], needles: tuple[bytes, ...]):
        self.keys = keys
        self.needles = needles
        self.done = threading.Event()
        # key -> {needle: bool[num_chunks]} (None value: block vanished).
        self.hits: Optional[dict[tuple, Optional[dict]]] = None
        # Per-key (start, n) chunk coordinates in the SAME matrix snapshot
        # the hits came from — compaction may move chunks concurrently, so
        # slice coordinates must travel with the launch, not the blocks.
        self.segments: Optional[list[Optional[tuple[int, int]]]] = None
        self.error: Optional[BaseException] = None


class DeviceRowCache:
    """LRU cache of pinned blocks keyed by (file pointer, block offset).

    ``device="cuda"`` with no visible card raises: it never falls back to
    the CPU. Pass ``device="cpu"`` for the scan kernel's plain version.
    ``mesh_devices`` follows the probe backend's rule (bloom/bank.py): None
    is every visible device of ``device``'s type when there is more than
    one, n > 1 shards the stream over n devices, more cards than are
    visible raises."""

    def __init__(
        self,
        capacity_bytes: int,
        mesh_devices: Optional[int] = None,
        host_shadow: bool = False,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device row cache on 'cuda' but no CUDA device is visible; "
                "pass device='cpu' to scan with the plain PyTorch version"
            )
        self.mesh = mesh_for(mesh_devices, self.device)
        self.capacity_bytes = capacity_bytes
        # Shadowed pins keep the block's decompressed bytes host-side
        # (~0.94x their device chunk bytes), so the reservation must split
        # the byte budget between the stream and the shadows; shadow-free
        # pins retain only offset/length arrays (a few % of raw).
        self.host_shadow = bool(host_shadow)
        # Capacity unit in chunks: the JAX package's 512 x mesh size, kept so
        # capacities and segment coordinates match it (the kernel itself
        # needs only a multiple of 32 on each shard).
        self._chunk_unit = 512 * (self.mesh.size if self.mesh is not None else 1)
        self._lock = threading.Lock()
        # Serializes every MUTATION of the stream matrix (pin uploads,
        # growth copies, compaction) so the slow device work runs OUTSIDE
        # self._lock and concurrent scans never stall behind an upload.
        # Ordering: _upload_lock is always acquired BEFORE _lock, never
        # while holding it. Scans/readers take only _lock; segment state
        # mutates only under BOTH (briefly under _lock), so matrix +
        # segments snapshots taken under _lock alone stay consistent.
        self._upload_lock = threading.Lock()
        # Count of FOREGROUND threads (query-path sync pins, tombstones,
        # shutdown) currently blocked on _upload_lock: a background
        # holder's yield points consult it via _has_upload_waiters and
        # hurry instead of sleeping (see _yield_point's inversion note).
        self._upload_waiters = 0
        self._waiters_lock = threading.Lock()
        self._blocks: dict[tuple[bytes, int], _PinnedBlock] = {}
        self._bucket = _StreamBucket()
        # Capacity floor set by reserve(): compaction never shrinks cap
        # below it and pins reclaim in place instead of growing past it, so
        # pin/evict churn never reallocates the whole stream.
        self._reserved_cap = 0
        # Version-keyed needle-bitmap cache (scan-all bitmaps outlive the
        # query that computed them); benchmarks disable this to measure the
        # uncached scan path.
        self.needle_cache_enabled = True
        self.launches = 0  # observability
        self.scan_requests = 0
        self.pins = 0        # blocks pinned (incl. re-pins after eviction)
        self.evictions = 0   # blocks evicted for capacity (not invalidation)
        self.compactions = 0 # stream compaction passes
        self._closed = False
        # The last tombstoned files (utils.remember): a pin of one that
        # raced its tombstone is never published (``invalidate_file``).
        self._tombstoned: dict[bytes, None] = {}

    # -- residency ------------------------------------------------------

    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes_locked()

    def stream_free_chunks(self) -> Optional[int]:
        """Chunks still pinnable without evicting, or None when no
        reservation fixes the capacity (warmup's pin pass stops here so a
        beyond-budget dataset doesn't churn the whole stream through
        evictions)."""
        if not self._reserved_cap:
            return None
        with self._lock:
            b = self._bucket
            return max(self._reserved_cap - (b.used - b.dead), 0)

    def stats(self) -> dict:
        """Public observability snapshot (the contract engine.stats() uses)."""
        with self._lock:
            device = self._bucket.cap * CHUNK_BYTES
            host = sum(blk.host_nbytes for blk in self._blocks.values())
            pinned = len(self._blocks)
        return {
            "bytes": device + host,
            "device_bytes": device,
            "host_bytes": host,
            "pinned_blocks": pinned,
            "scan_launches": self.launches,
            "scan_requests": self.scan_requests,
            "pins": self.pins,
            "evictions": self.evictions,
            "compactions": self.compactions,
            "mesh_devices": self.mesh.size if self.mesh is not None else 1,
        }

    def _total_bytes_locked(self) -> int:
        bucket_bytes = self._bucket.cap * CHUNK_BYTES
        host_bytes = sum(blk.host_nbytes for blk in self._blocks.values())
        return bucket_bytes + host_bytes

    def get(self, key: tuple[bytes, int]) -> Optional[_PinnedBlock]:
        with self._lock:
            block = self._blocks.pop(key, None)
            if block is not None:
                self._blocks[key] = block  # LRU bump
            return block

    def _has_upload_waiters(self) -> bool:
        # Racy read by design: a stale False costs one 5 ms yield-sleep.
        return self._upload_waiters > 0

    @contextlib.contextmanager
    def _mutation_lock(self, foreground: bool = True):
        """_upload_lock acquisition that, for FOREGROUND callers, advertises
        the wait: a background pin holding the lock polls
        _has_upload_waiters at its yield points and hurries instead of
        sleeping on the very query its waiter is part of (priority
        inversion — the query can't drain while its pin blocks here)."""
        if foreground:
            with self._waiters_lock:
                self._upload_waiters += 1
        try:
            self._upload_lock.acquire()
        finally:
            if foreground:
                with self._waiters_lock:
                    self._upload_waiters -= 1
        try:
            yield
        finally:
            self._upload_lock.release()

    def release(self) -> None:
        """Drop the stream's device memory (engine shutdown).

        The matrix returns to PyTorch's allocator once no in-flight scan
        snapshot holds it. Waits for in-flight mutations (_upload_lock);
        later pin()/reserve() raise RowCacheReleasedError, which warmup and
        background pins treat as the shutdown it is.
        """
        # launch_lock AFTER _mutation_lock, BEFORE _lock — the same order a
        # scan leader uses (launch_lock -> _lock), and no leader takes
        # _mutation_lock. Holding it here means no scan launch is mid-flight
        # when the matrix is dropped: later leaders see matrix None and
        # resolve via the vanished contract.
        with self._mutation_lock(), self._bucket.launch_lock:
            with self._lock:
                self._closed = True
                bucket = self._bucket
                bucket.matrix = None
                bucket.cap = 0
                bucket.used = 0
                bucket.dead = 0
                bucket.segments = {}
                bucket.needle_cache.clear()
                bucket.version += 1
                self._blocks.clear()
                self._reserved_cap = 0

    def invalidate_file(self, pointer: bytes) -> None:
        """Drop a tombstoned file's pinned blocks. The file is gone for
        good, so a pin of it that raced this call (a background pin queued
        by a query that has drained) is not published afterwards, where no
        later tombstone would remove it."""
        with self._mutation_lock():
            with self._lock:
                remember(self._tombstoned, pointer)
                for key in [k for k in self._blocks if k[0] == pointer]:
                    self._remove_locked(key)
            self._maybe_compact()

    def _remove_locked(self, key) -> None:
        block = self._blocks.pop(key, None)
        if block is None:
            return
        seg = self._bucket.segments.pop(key, None)
        if seg is not None:
            # The block's whole chunk footprint becomes reclaimable.
            self._bucket.dead += seg[1]

    def reserve(self, total_chunks: int) -> int:
        """Pre-size the stream matrix before pinning.

        Warmup calls this with the dataset's total chunk count (derivable
        from block metadata): later pin/evict churn then never reallocates
        the matrix (compaction floors at the reservation; pins reclaim in
        place instead of growing past it). Capped at ~90% of the byte
        budget (shadow-free: host side is just offset/length arrays) or
        ~45% with the host shadow on — each pinned chunk then also costs
        ~0.94x its device bytes host-side, and a 90% device claim would
        leave pin()'s byte-budget eviction only ~10% of the budget for LIVE
        content. Returns the reserved cap in chunks.
        """
        unit = self._chunk_unit
        # Budget cap rounds DOWN to the unit (rounding up could overshoot
        # the device byte budget); the dataset size rounds up.
        frac = 0.45 if self.host_shadow else 0.9
        budget_chunks = max(
            ((int(self.capacity_bytes * frac)) // CHUNK_BYTES // unit) * unit, unit
        )
        cap = min(_round_up(max(total_chunks, 1) + 512, unit), budget_chunks)
        with self._mutation_lock():
            if self._closed:
                raise RowCacheReleasedError("row cache released")
            bucket = self._bucket
            if cap <= bucket.cap:
                self._reserved_cap = max(self._reserved_cap, bucket.cap)
                return bucket.cap
            if bucket.matrix is None:
                matrix = sharded_zeros_rows(self.mesh, cap, device=self.device)
            else:
                matrix = sharded_pad_rows(self.mesh, bucket.matrix, cap)
            with self._lock:
                bucket.matrix = matrix
                bucket.cap = cap
                bucket.version += 1
                bucket.needle_cache.clear()
            self._reserved_cap = cap
        return cap

    def _maybe_compact(self, force: bool = False) -> None:
        """Compact dead chunk ranges out of the stream. Caller holds
        _upload_lock; the device gather runs WITHOUT self._lock (scans keep
        flowing against the old matrix snapshot) into a new tensor, and the
        new layout publishes atomically under self._lock at the end.
        Segment state only mutates under _upload_lock, so the snapshot
        taken here cannot go stale before publish."""
        bucket = self._bucket
        with self._lock:
            if bucket.dead == 0 or (not force and bucket.dead * 2 < bucket.used):
                return
            order = sorted(bucket.segments.items(), key=lambda kv: kv[1][0])
            matrix = bucket.matrix
        cursor = 0
        new_segments = {}
        spans = []
        for key, (start, n) in order:
            spans.append((start, n))
            new_segments[key] = (cursor, n)
            cursor += n
        unit = self._chunk_unit
        # Never shrink below a reservation.
        new_cap = max(
            unit, _round_up(max(cursor, 1), unit), self._reserved_cap
        )
        if cursor:
            idx = np.concatenate(
                [np.arange(s, s + n, dtype=np.int64) for s, n in spans]
            )
            new_matrix = sharded_take_rows(self.mesh, matrix, idx, new_cap)
        else:
            new_matrix = sharded_zeros_rows(self.mesh, new_cap, device=self.device)
        with self._lock:
            bucket.matrix = new_matrix
            bucket.cap = new_cap
            bucket.used = cursor
            bucket.dead = 0
            bucket.segments = new_segments
            bucket.version += 1
            bucket.needle_cache.clear()
            self.compactions += 1

    def pin(
        self,
        key: tuple[bytes, int],
        data: bytes,
        row_offsets: np.ndarray,
        row_lengths: np.ndarray,
        fetcher=None,
        yield_to=None,
        prepacked: Optional[tuple[np.ndarray, np.ndarray, int]] = None,
    ) -> _PinnedBlock:
        """Chunk + lowercase a block's row buffer and append it to the
        stream matrix.

        With ``fetcher`` the block pins SHADOW-FREE: ``data`` feeds the
        device pack but is not retained host-side; candidate rows re-read
        through ``fetcher(idx, offsets, lengths)`` at extraction time
        (engine._fetch_pinned_rows — ranged store reads + chunk-granular
        snappy decode). Cuts serving host memory from ~1.2x raw to just the
        offset/length/flag arrays.

        The host pack and the device upload run under _upload_lock only —
        a cold pin's multi-MB h2d transfer must not stall concurrent warm
        scans, which take just self._lock. The new segment publishes
        atomically under self._lock once the upload lands.

        ``yield_to`` (background/warmup pins only — NEVER a query-path
        sync pin, which would deadlock on itself): a callable polled at
        each device-work boundary; while truthy the pin pauses (bounded by
        _PIN_YIELD_MAX_S total) so in-flight queries' launches aren't
        queued behind this pin's uploads/compactions on the device.

        ``prepacked`` = (chunks, always_candidate, n_chunks) from
        pack_block() or a restart sidecar (servingcache.py): the pack pass
        is skipped and ``data`` may be None (fetcher then required — there
        are no bytes to shadow)."""
        num_rows = row_offsets.shape[0]
        with self._lock:
            existing = self._blocks.get(key)
            if existing is not None:
                return existing

        if prepacked is not None:
            chunks, always_candidate, n_chunks = prepacked
            if data is None and fetcher is None:
                raise ValueError("prepacked pin without data requires a fetcher")
        else:
            chunks, always_candidate, n_chunks = pack_block(
                data, row_offsets, row_lengths
            )

        # Pack 4 bytes per int32 word, little-endian (what the scan kernel
        # reads). A pure reinterpret on little-endian hosts.
        if sys.byteorder == "little":
            packed = chunks.view(np.int32)
        else:
            m32 = chunks.reshape(chunks.shape[0], -1, 4).astype(np.uint32)
            packed = (
                m32[..., 0] | (m32[..., 1] << 8) | (m32[..., 2] << 16) | (m32[..., 3] << 24)
            ).view(np.int32)

        deadline = time.monotonic() + _PIN_YIELD_MAX_S
        hurry = self._has_upload_waiters
        _yield_point(yield_to, deadline, hurry)
        # A query-path sync pin (yield_to None) is a foreground waiter: it
        # advertises itself so a background holder's yield points hurry.
        with self._mutation_lock(foreground=yield_to is None):
            # Restart the yield allowance now that the lock is HELD: waiting
            # behind another pin's piecewise upload (or the pre-lock yield
            # above) must not consume it.
            deadline = time.monotonic() + _PIN_YIELD_MAX_S
            with self._lock:
                if self._closed:
                    raise RowCacheReleasedError("row cache released")
                existing = self._blocks.get(key)
                if existing is not None:
                    return existing

            # Matrix/used/cap mutate only under _upload_lock (held), so the
            # device work below runs against a stable base without _lock.
            bucket = self._bucket
            unit = self._chunk_unit
            matrix = bucket.matrix
            cap = bucket.cap
            used = bucket.used
            # Upload decomposes into pow2 pieces (below), whose zero-padded
            # tail may extend into not-yet-used space — size capacity for it.
            n_upload = _round_up(n_chunks, 512)
            if used + n_upload > cap:
                with self._lock:
                    at_budget = (
                        self._total_bytes_locked() >= self.capacity_bytes
                    )
            else:
                at_budget = False
            if used + n_upload > cap and (
                (self._reserved_cap and cap >= self._reserved_cap)
                or at_budget
            ):
                # Stream at reserved capacity — or, without a reserve(), at
                # the byte budget: reclaim in place instead of growing
                # (eviction keeps LIVE chunks under budget but compaction
                # only fires at dead*2 >= used, so growth-past-budget would
                # let the PHYSICAL matrix reach ~2x capacity_bytes and OOM
                # a card sized to the budget). Evict LRU blocks until the
                # LIVE chunks fit, then force-compact — the matrix keeps
                # its capacity, only its contents rearrange. This is the
                # steady state of beyond-budget serving.
                # Evict with SLACK (cap/8, at least this pin): compaction is
                # a full-stream device gather, and freeing only n_upload
                # would re-trigger it on every subsequent at-capacity pin.
                #
                # Freeze the capacity here: without this floor an
                # unreserved stream's force-compact would shrink cap to
                # live size and the re-check below would immediately grow
                # it back — two full-matrix copies per at-capacity pin.
                self._reserved_cap = max(self._reserved_cap, cap)
                _yield_point(yield_to, deadline, hurry)
                target = max(n_upload, cap // 8)
                with self._lock:
                    for oldest in list(self._blocks):
                        if (bucket.used - bucket.dead) + target <= cap:
                            break
                        if oldest == key:
                            continue
                        self._remove_locked(oldest)
                        self.evictions += 1
                self._maybe_compact(force=True)
                matrix = bucket.matrix
                cap = bucket.cap
                used = bucket.used
            if used + n_upload > cap:
                # Growth: double while small, then bounded increments — the
                # copy in sharded_pad_rows holds old+new concurrently, and
                # unbounded doubling at multi-GB stream sizes runs out of
                # device memory.
                grow = min(cap, max(_GROWTH_STEP_BYTES // CHUNK_BYTES, 1))
                # Never grow the PHYSICAL matrix past the byte budget
                # unless this single pin genuinely needs more.
                with self._lock:
                    host_bytes = sum(
                        blk.host_nbytes for blk in self._blocks.values()
                    )
                budget_cap = (
                    max(self.capacity_bytes - host_bytes, 0)
                    // CHUNK_BYTES
                    // unit
                ) * unit
                need = _round_up(used + n_upload, unit)
                cap = max(
                    min(
                        max(need, _round_up(cap + grow, unit)),
                        max(budget_cap, need),
                    ),
                    unit,
                )
                if matrix is None:
                    matrix = sharded_zeros_rows(self.mesh, cap, device=self.device)
                else:
                    matrix = sharded_pad_rows(self.mesh, matrix, cap)
            if n_chunks > 0:
                # Piecewise pow2 upload, greedy pieces >= 512 chunks, with
                # a yield point between pieces; the final piece zero-pads
                # into not-yet-used space (never part of any live segment,
                # and overwritten by the next pin's real bytes). Every
                # piece writes rows >= used in place: no published segment
                # covers them (module doc).
                off = 0
                while off < n_chunks:
                    if off:
                        _yield_point(yield_to, deadline, hurry)
                    remaining = n_chunks - off
                    piece = 512
                    while piece * 2 <= remaining:
                        piece *= 2
                    sub = packed[off : off + piece]
                    if sub.shape[0] < piece:
                        sub = np.concatenate(
                            [
                                sub,
                                np.zeros(
                                    (piece - sub.shape[0], CHUNK_BYTES // 4),
                                    dtype=np.int32,
                                ),
                            ]
                        )
                    # In place, into slack rows (module doc).
                    matrix = sharded_update_rows(self.mesh, matrix, sub, used + off)
                    off += piece

            # Retained coordinate arrays downcast to int32 (a block is at
            # most max_row_group_bytes, far under 2^31) — with the shadow
            # gone these arrays ARE the host footprint.
            if data is None or len(data) < (1 << 31):
                row_offsets = np.asarray(row_offsets, dtype=np.int32)
                row_lengths = np.asarray(row_lengths, dtype=np.int32)
            block = _PinnedBlock(
                key, n_chunks, num_rows, always_candidate,
                None if fetcher is not None else data,
                row_offsets, row_lengths, fetcher=fetcher,
            )
            with self._lock:
                if key[0] in self._tombstoned:
                    # Never published: its rows stay slack past ``used``,
                    # and a scan of the returned block finds no segment.
                    return block
                bucket.matrix = matrix
                bucket.cap = cap
                if n_chunks > 0:
                    bucket.version += 1
                    bucket.needle_cache.clear()
                bucket.segments[key] = (used, n_chunks)
                bucket.used = used + n_chunks
                self._blocks[key] = block
                # LRU eviction under the byte budget. _remove_locked only
                # turns device chunks DEAD (compaction reclaims them after),
                # so budget against the post-compaction footprint — counting
                # dead chunks would evict the whole warm cache down to one
                # block whenever the device term alone exceeded the budget
                # (e.g. right after a growth step overshoots).
                while (
                    self._total_bytes_locked() - self._bucket.dead * CHUNK_BYTES
                    > self.capacity_bytes
                    and len(self._blocks) > 1
                ):
                    oldest = next(iter(self._blocks))
                    if oldest == key:
                        break
                    self._remove_locked(oldest)
                    self.evictions += 1
            self.pins += 1
            with self._lock:
                will_compact = bucket.dead > 0 and bucket.dead * 2 >= bucket.used
            if will_compact:
                _yield_point(yield_to, deadline, hurry)
            self._maybe_compact()
        return block

    # -- scanning ---------------------------------------------------------

    def load_scan_kernel(self) -> None:
        """Build (``nvcc``, at first use) and load the scan kernel library
        when the stream lives on a CUDA device; build errors raise. A scan
        launched meanwhile waits for the same load. On a mesh, one 32-chunk
        dense launch on each shard device loads the kernel on every card."""
        if self.device.type != "cuda":
            return
        _scan_kernel.library()
        if self.mesh is not None:
            needle = np.zeros((1, MAX_NEEDLE), dtype=np.int32)
            lens = np.zeros(1, dtype=np.int32)
            for dev in self.mesh.distinct_devices():
                _scan_kernel.byte_scan_stream(
                    sharded_zeros_rows(None, 32, device=dev), needle, lens, n_real=1,
                ).cpu()

    def precompile_scan_programs(self, blocks: list, yield_to=None) -> int:
        """Launch the scan kernel once over the whole matrix and once over
        a segment, through the calls a query makes, and fetch both results
        -> launches. On a mesh: one dense sharded call (every shard) and one
        sparse one.

        A one-time check that the kernel launches on this stream (there is
        no per-shape compile; ``load_scan_kernel`` loads the library).
        ``blocks`` sizes the segment launch like a live one (the largest
        block's range, one needle row), and it runs when a block that size
        can scan sparse; ``yield_to`` is polled before each launch (the
        engine's queries-in-flight gate).
        Build, launch and device errors raise.
        """
        bucket = self._bucket
        with self._lock:
            matrix = bucket.matrix
        if matrix is None:
            return 0
        phys_cap = logical_size(matrix, 0)
        max_chunks = max((b.num_chunks for b in blocks), default=1)
        seg_chunks = max(_round_up_pow2(max(max_chunks, 1)), 512)
        padded = np.zeros((1, MAX_NEEDLE), dtype=np.int32)
        lens = np.zeros(1, dtype=np.int32)
        if yield_to is not None:
            yield_to()
        sharded_scan_all_rows(self.mesh, matrix, padded, lens, n_real=1)
        launched = 1
        if seg_chunks * 4 <= phys_cap:
            if yield_to is not None:
                yield_to()
            sharded_scan_segments(
                self.mesh, matrix, [0], padded, lens, n_real=1,
                seg_chunks=[max(max_chunks, 1)],
            )
            launched += 1
        return launched

    def scan(self, block: _PinnedBlock, needles: list[bytes]) -> np.ndarray:
        """-> bool[len(needles), num_rows] candidate matrix (device scan).

        Concurrent scans coalesce: one leader launches the stream ONCE with
        the union of pending needle sets and every waiter slices its own
        blocks' chunk spans."""
        return self.scan_many([block], needles)[block.key]

    def scan_many(
        self, blocks: list[_PinnedBlock], needles: list[bytes]
    ) -> dict[tuple, np.ndarray]:
        """Scan MANY pinned blocks in (at most) one launch.

        The query planner knows every surviving block upfront, so a warm
        serving-mode query costs ~one scan launch total instead of one per
        block. -> {block.key: bool[len(needles), num_rows]}: the scan's
        bitmaps (``scan_bitmaps``) ORed with each block's always-candidate
        rows.
        """
        out = self.scan_bitmaps(blocks, needles)
        for block in blocks:
            if block.always_candidate.any():
                out[block.key][:, block.always_candidate[: block.num_rows]] = True
        return out

    def scan_bitmaps(
        self, blocks: list[_PinnedBlock], needles: list[bytes]
    ) -> dict[tuple, np.ndarray]:
        """``scan_many`` before the always-candidate rows: the kernel's
        chunk hits expanded to rows, all rows for a needle it cannot scan
        (empty or longer than MAX_NEEDLE) and for a block evicted or moved
        under the scan."""
        out: dict[tuple, np.ndarray] = {}
        usable = tuple(n for n in needles if n and len(n) <= MAX_NEEDLE)
        hits = (
            self._bucket_hits([b.key for b in blocks], usable)
            if usable and blocks
            else {}
        )
        for block in blocks:
            mat = np.zeros((len(needles), block.num_rows), dtype=bool)
            block_hits = hits.get(block.key) if usable else {}
            stale = usable and (
                block_hits is None
                or any(h.shape[0] < block.num_chunks for h in block_hits.values())
            )
            if stale:
                # Evicted/moved under us: conservative (exact verify
                # still rejects false positives).
                mat[:] = True
            else:
                for qi, needle in enumerate(needles):
                    if not needle or len(needle) > MAX_NEEDLE:
                        mat[qi] = True  # degenerate/oversized
                    elif block_hits:
                        mat[qi] = _expand_chunk_hits(
                            block, len(needle), block_hits[needle]
                        )
            out[block.key] = mat
        return out

    def _bucket_hits(
        self, keys: list[tuple], needles: tuple[bytes, ...]
    ) -> dict[tuple, Optional[dict]]:
        """Scan blocks via the combiner ->
        {key: {needle: bool[num_chunks]} | None (block vanished)}."""
        req = _PendingScan(keys, needles)
        bucket = self._bucket
        with self._lock:
            if bucket.matrix is None:
                return {k: None for k in keys}
            bucket.pending.append(req)
        with bucket.launch_lock:
            if not req.done.is_set():
                with self._lock:
                    batch = bucket.pending
                    bucket.pending = []
                    # Consistent snapshot: the matrix AND every waiter's
                    # segment coordinates under one lock acquisition
                    # (compaction may move chunks at any time).
                    matrix = bucket.matrix
                    version = bucket.version
                    for r in batch:
                        r.segments = [bucket.segments.get(k) for k in r.keys]
                if matrix is None:
                    # release() raced between this request's matrix check
                    # and leadership: resolve everyone with the vanished
                    # contract (None hits -> conservative all-candidates)
                    # instead of crashing the queries on a deleted matrix.
                    for r in batch:
                        r.hits = {k: None for k in r.keys}
                        r.done.set()
                else:
                    try:
                        self._launch_bucket_scan(bucket, matrix, version, batch)
                    except BaseException as exc:
                        for r in batch:
                            r.error = exc
                            r.done.set()
                        raise
        if req.error is not None:
            raise req.error
        return req.hits

    def _launch_bucket_scan(
        self, bucket: _StreamBucket, matrix, version: int,
        batch: list[_PendingScan],
    ) -> None:
        """ONE launch for every pending request: scan the stream matrix
        (all of it, or just the requested chunk segments when they're a
        small fraction of residency) against the union of the requested
        needles; each waiter slices its blocks' chunk spans out of the
        result bitmap."""
        self.scan_requests += len(batch)
        union: list[bytes] = []
        seen = set()
        for r in batch:
            for n in r.needles:
                if n not in seen:
                    seen.add(n)
                    union.append(n)

        # Needle-bitmap cache: a scan-all bitmap covers every resident
        # chunk, so it stays valid as long as the matrix does
        # (version-checked). Repeated needles — dashboards, retried
        # queries — skip the device round-trip entirely.
        cached: dict[bytes, np.ndarray] = {}
        if self.needle_cache_enabled:
            with self._lock:
                for nd in union:
                    ent = bucket.needle_cache.pop(nd, None)
                    if ent is None:
                        continue
                    # Re-insert on hit: eviction pops the front, so a hit
                    # must refresh recency (LRU, not FIFO — a hot dashboard
                    # needle must survive a sweep of one-shot needles).
                    bucket.needle_cache[nd] = ent
                    if ent[0] == version:
                        cached[nd] = ent[1]
        missing = [nd for nd in union if nd not in cached]

        # Adaptive scan shape for needles not served from cache:
        #  - DENSE (requests cover a meaningful fraction of residency): scan
        #    EVERY resident chunk; the full-residency bitmap also feeds the
        #    needle cache.
        #  - SPARSE (few blocks of a big stream — needle queries at
        #    reference scale ask for 3 of 240): the kernel's segment mode
        #    scans just the requested chunk segments in place (on a mesh,
        #    on the cards that hold them; on one device, the same call on
        #    one shard); both the scanned bytes and the returned bitmap
        #    shrink by the sparsity factor.
        phys_cap = logical_size(matrix, 0)
        # Unique requested chunk ranges (chunk_start, n_chunks).
        ranges = sorted(
            {
                seg
                for r in batch
                for seg in r.segments
                if seg is not None and seg[1] > 0
            }
        )
        # The sparse-or-dense rule is the JAX package's, on its launch
        # shapes (pow2 segments of at least 512 chunks, a pow2 count of at
        # most 4), so both packages launch the same modes: single needle
        # queries (1-4 blocks) stay sparse, and bursts of coalesced
        # concurrent requests fall through to the dense scan. A mesh takes
        # the same rule on the same logical capacity.
        seg_chunks = _round_up_pow2(max((n for _, n in ranges), default=1))
        seg_chunks = max(seg_chunks, 512)
        n_segs = _round_up_pow2(len(ranges)) if ranges else 0
        sparse = (
            0 < n_segs <= _SPARSE_MAX_SEGS
            and seg_chunks <= phys_cap
            and n_segs * seg_chunks * 4 <= phys_cap
        )

        fresh: dict[bytes, np.ndarray] = {}
        if missing:
            # Sort by length before chunking (the JAX package's launch
            # grouping, kept so each launch scans the reference's group).
            # Every launch takes just its real needles: the kernel's time
            # grows with the needle count, and it has no per-shape compile
            # to save by padding to the reference's pow2 buckets.
            missing.sort(key=len)
            for base in range(0, len(missing), MAX_SCAN_NEEDLES):
                part = missing[base : base + MAX_SCAN_NEEDLES]
                n_real = len(part)
                padded = np.zeros((n_real, MAX_NEEDLE), dtype=np.int32)
                lens = np.zeros(n_real, dtype=np.int32)
                for row, needle in enumerate(part):
                    padded[row, : len(needle)] = np.frombuffer(needle, dtype=np.uint8)
                    lens[row] = len(needle)
                self.launches += 1  # one per DEVICE launch, not per pass
                if sparse:
                    # Just the requested ranges, each rounded up to the
                    # kernel's 32-chunk tile (cut at shard boundaries on a
                    # mesh); range (ps, pn) starts at logical chunk
                    # range_base[(ps, pn)] of the page-locked result.
                    out, bases = sharded_scan_segments(
                        self.mesh, matrix, [ps for ps, _ in ranges], padded, lens,
                        n_real=n_real, seg_chunks=[pn for _, pn in ranges],
                    )
                    range_base = dict(zip(ranges, bases))
                else:
                    out = sharded_scan_all_rows(
                        self.mesh, matrix, padded, lens, n_real=n_real
                    )
                # Both calls return their words on the host (page-locked
                # on cards): no copy.
                packed = out.numpy().view(np.uint32)
                for row, needle in enumerate(part):
                    fresh[needle] = packed[row]
            # Only full-residency bitmaps are cacheable.
            if self.needle_cache_enabled and not sparse:
                with self._lock:
                    if bucket.version == version:
                        for needle, row in fresh.items():
                            # A copy of the row: the row is a view whose
                            # base is the launch's whole output (up to 8
                            # rows, page-locked on cards), which the byte
                            # budget below does not count.
                            bucket.needle_cache[needle] = (version, row.copy())
                        per_entry = max(
                            (ent[1].nbytes for ent in bucket.needle_cache.values()),
                            default=0,
                        )
                        max_entries = min(
                            _NEEDLE_CACHE_MAX,
                            _NEEDLE_CACHE_MAX_BYTES // per_entry if per_entry else _NEEDLE_CACHE_MAX,
                        )
                        while len(bucket.needle_cache) > max(max_entries, 1):
                            bucket.needle_cache.pop(next(iter(bucket.needle_cache)))

        # needle -> (full-residency coordinates?, PACKED bytes). Waiters
        # unpack only their blocks' bit ranges (_unpack_bit_range) — never
        # the full bitmap.
        bits: dict[bytes, tuple[bool, np.ndarray]] = {}
        for nd in union:
            full = nd in cached
            raw = cached[nd] if full else fresh[nd]
            bits[nd] = (
                full or not sparse,
                np.ascontiguousarray(raw).view(np.uint8),
            )
        for r in batch:
            hits: dict[tuple, Optional[dict]] = {}
            for key, seg in zip(r.keys, r.segments):
                if seg is None:
                    hits[key] = None
                    continue
                start, n = seg
                per_needle = {}
                for needle in r.needles:
                    full_coords, raw_u8 = bits[needle]
                    first = start if full_coords or n == 0 else range_base[(start, n)]
                    per_needle[needle] = _unpack_bit_range(raw_u8, first, n)
                hits[key] = per_needle
            r.hits = hits
            r.done.set()


def rowcache_from_reference(ref, device, mesh=None) -> DeviceRowCache:
    """The JAX package's DeviceRowCache state -> this package's
    DeviceRowCache on ``device``.

    Copies the stream matrix (as numpy), the segment placements, ``cap``,
    ``used``, ``dead``, the reserved cap and every pinned block (its
    coordinate arrays, flags and shadow bytes or fetcher), so both packages
    scan the same resident state. Counters start at zero. The port's
    stream shards over ``mesh``; with none, a reference on an n-device mesh
    gives an n-shard mesh on ``device`` (its chunk unit is a multiple of
    the reference's, so ``cap`` splits)."""
    n = ref.mesh.shape["blocks"] if getattr(ref, "mesh", None) is not None else 1
    cache = DeviceRowCache(
        ref.capacity_bytes, host_shadow=ref.host_shadow, device=device,
        mesh_devices=n if mesh is None else 1,
    )
    if mesh is not None and mesh.size > 1:
        cache.mesh = mesh
        cache._chunk_unit = 512 * mesh.size
    src, dst = ref._bucket, cache._bucket
    if src.matrix is not None:
        matrix = np.array(src.matrix, dtype=np.int32)  # a private copy
        dst.matrix = sharded_update_rows(
            cache.mesh,
            sharded_zeros_rows(cache.mesh, matrix.shape[0], device=cache.device),
            matrix, 0,
        )
    dst.cap, dst.used, dst.dead = src.cap, src.used, src.dead
    dst.segments = dict(src.segments)
    for key, blk in ref._blocks.items():
        cache._blocks[key] = _PinnedBlock(
            key, blk.num_chunks, blk.num_rows, np.array(blk.always_candidate),
            blk.data, np.array(blk.row_offsets), np.array(blk.row_lengths),
            fetcher=blk.fetcher,
        )
    cache._reserved_cap = ref._reserved_cap
    cache.needle_cache_enabled = ref.needle_cache_enabled
    return cache

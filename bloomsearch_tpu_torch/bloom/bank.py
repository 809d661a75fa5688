"""Device-resident filter superbanks and the device probe backend (PyTorch).

Every resident file's block filters live packed in a per-(m, k, layout)
device **superbank** ``int32[3 * num_words, capacity]`` (the host's uint32
words, viewed as int32). A query probes *all* resident blocks of a param
group in one kernel launch (kernels/probe.py) and slices per-file results
out of the packed survivor bitmap host-side. Files are immutable, so a bank
column never changes: inserts append, tombstones mark columns dead, and
compaction rebuilds when the dead fraction grows.

Capacity is padded to a multiple of 128 and grows by doubling, which keeps
capacities, placements and the ``stats()`` block counts identical to the
JAX package's (its bytes also count 8-row padding that this layout drops);
zero-filled columns can never produce a bloom match, so padding and dead
columns are inherently masked.

Snapshot consistency: a probe captures ``bank2d`` and the segment
placements under the lock and may launch after the lock is released.
Growth and compaction therefore always allocate a NEW tensor, never rewrite
one a snapshot may hold; an insert writes in place only into slack columns
past ``used``, which no placement points at, and its copy is ordered on the
device's current stream before any later launch.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.probe import (
    probe_and_pack,
    probe_clauses_pack,
    probe_reduce_and_pack,
)

LANE = 128


class BackendReleasedError(RuntimeError):
    """Raised when a (background) bank load races engine shutdown past
    DeviceProbeBackend.release(): inserting after release would allocate
    device memory owned by a dead engine's backend — the leak release()
    exists to prevent. Query paths never see this (the engine drains
    queries before releasing); warm/warmup paths catch it and stop
    quietly."""


class BankChurnError(RuntimeError):
    """Raised by probe_groups when a query's segments kept being evicted
    between residency and snapshot (concurrent queries competing for an
    undersized cache). The only probe failure the engine degrades to host
    probing; kernel build and launch errors and device OOM propagate."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_terms(n: int) -> int:
    """Bucket the term count to a power of two (the launch shape ladder)."""
    p = 1
    while p < n:
        p *= 2
    return p


# Combined-launch caps: the probe combiner drains at most this many members
# / total terms / total CNF clauses per launch; undrained requests lead the
# next launch. A SINGLE request above a cap is split / host-evaluated (see
# _probe_superbank_batched).
_PROBE_BATCH_MAX_MEMBERS = 16
_PROBE_BATCH_MAX_TERMS = 16
# Clause cap is its own constant (even while equal to the term cap).
_PROBE_BATCH_MAX_CLAUSES = 16


class Superbank:
    """One device-resident bank for a (m_bits, k, layout) bloom param group.

    ``bank2d`` is ``int32[3 * num_words, capacity]`` on ``device``: row =
    keyspace*num_words + word, capacity a multiple of 128.
    """

    def __init__(self, m_bits: int, k: int, layout: str, device):
        self.m_bits = m_bits
        self.k = k
        self.layout = layout
        self.num_words = (m_bits + 31) // 32
        self.num_rows = 3 * self.num_words
        self.device = torch.device(device)
        self.capacity = 0
        self.used = 0
        self.dead = 0
        self.bank2d: Optional[torch.Tensor] = None
        # key -> (start, num_cols); insertion order preserved for compaction.
        self.segments: dict[bytes, tuple[int, int]] = {}

    @property
    def nbytes(self) -> int:
        return self.num_rows * self.capacity * 4

    def _zeros(self, cols: int) -> torch.Tensor:
        return torch.zeros((self.num_rows, cols), dtype=torch.int32, device=self.device)

    def _grow(self, min_capacity: int) -> None:
        new_cap = max(_round_up(min_capacity, LANE), max(LANE, self.capacity * 2))
        new_bank = self._zeros(new_cap)
        if self.bank2d is not None:
            new_bank[:, : self.capacity] = self.bank2d
        self.bank2d = new_bank
        self.capacity = new_cap

    def stage(self, host_bank: np.ndarray) -> torch.Tensor:
        """Upload a group's flat [3*num_words, B] columns (outside the
        backend lock); ``insert(..., staged=...)`` publishes them."""
        _, w, num_cols = host_bank.shape
        assert w == self.num_words, (w, self.num_words)
        flat = np.ascontiguousarray(
            host_bank.reshape(3 * self.num_words, num_cols), dtype=np.uint32
        )
        if not flat.flags.writeable:  # torch tensors cannot wrap read-only memory
            flat = flat.copy()
        return torch.from_numpy(flat.view(np.int32)).to(self.device)

    def insert(
        self, key: bytes, host_bank: np.ndarray, staged: Optional[torch.Tensor] = None
    ) -> tuple[int, int]:
        """Append a file-group's bank uint32[3, num_words, B] -> (start, B)."""
        assert key not in self.segments
        _, w, num_cols = host_bank.shape
        assert w == self.num_words, (w, self.num_words)
        if staged is None or staged.shape[1] != num_cols:
            staged = self.stage(host_bank)
        if self.used + num_cols > self.capacity:
            self._grow(self.used + num_cols)
        # In place, into slack columns no placement points at (module doc).
        self.bank2d[:, self.used : self.used + num_cols] = staged
        segment = (self.used, num_cols)
        self.segments[key] = segment
        self.used += num_cols
        return segment

    def remove(self, key: bytes) -> None:
        segment = self.segments.pop(key, None)
        if segment is not None:
            self.dead += segment[1]

    def maybe_compact(self, force: bool = False) -> None:
        """Rebuild without dead columns once they dominate (``force``: any
        dead column compacts — the backend uses it when live segments fit
        the byte budget but the dead slack holds real device memory past
        it). The rebuilt bank is a new tensor (module doc)."""
        if self.dead == 0 or (not force and self.dead * 2 < self.used):
            return
        cols = []
        new_segments: dict[bytes, tuple[int, int]] = {}
        cursor = 0
        for key, (start, n) in self.segments.items():
            cols.extend(range(start, start + n))
            new_segments[key] = (cursor, n)
            cursor += n
        new_cap = max(LANE, _round_up(max(cursor, 1), LANE))
        new_bank = self._zeros(new_cap)
        if cols:
            idx = torch.as_tensor(np.asarray(cols, dtype=np.int64), device=self.device)
            new_bank[:, :cursor] = self.bank2d.index_select(1, idx)
        self.bank2d = new_bank
        self.capacity = new_cap
        self.segments = new_segments
        self.used = cursor
        self.dead = 0


def superbank_from_reference(
    bank2d: np.ndarray,
    segments: dict[bytes, tuple[int, int]],
    m_bits: int,
    k: int,
    layout: str,
    device,
) -> Superbank:
    """The JAX package's Superbank state -> this package's Superbank.

    ``bank2d`` is the reference's uint32[rows8, capacity] (rows padded to a
    multiple of 8); the padding rows are dropped and every column keeps its
    placement, so both packages probe the same resident state."""
    sb = Superbank(m_bits, k, layout, device)
    # A private copy: inserts write the superbank in place.
    bank2d = np.array(bank2d[: sb.num_rows], dtype=np.uint32)
    if bank2d.shape[0] != sb.num_rows or bank2d.shape[1] % LANE:
        raise ValueError(f"bank2d {bank2d.shape} does not fit m_bits={m_bits}")
    sb.bank2d = torch.from_numpy(bank2d.view(np.int32)).to(sb.device)
    sb.capacity = bank2d.shape[1]
    sb.segments = dict(segments)
    sb.used = max((s + n for s, n in segments.values()), default=0)
    sb.dead = sb.used - sum(n for _, n in segments.values())
    return sb


class DeviceProbeBackend:
    """Caches filter banks on one device and serves batched probes.

    ``probe_groups`` is the query-path entry point: given every candidate
    (file, bank-group) of a query, it ensures residency, runs ONE probe per
    superbank (the CUDA kernel on a card, its plain version on the CPU), and
    returns each file-group's term-match slice.

    ``device="cuda"`` with no visible card raises: it never falls back to
    the CPU. Pass ``device="cpu"`` explicitly for the plain versions.
    """

    def __init__(
        self,
        cache_bytes: int = 2 << 30,
        device="cuda",
        mesh_devices: int | None = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device probe backend on 'cuda' but no CUDA device is visible; "
                "pass device='cpu' to probe with the plain PyTorch versions"
            )
        if mesh_devices is not None and mesh_devices > 1:
            raise NotImplementedError(
                "mesh_devices > 1: block-axis sharding over several GPUs comes "
                "with the port's mesh slice"
            )
        self.platform = self.device.type
        self.cache_bytes = cache_bytes
        self._lock = threading.RLock()
        self._superbanks: dict[tuple, Superbank] = {}
        self._released = False  # set by release(); blocks late re-uploads
        # Cross-query launch batching (see _probe_superbank_batched).
        self._batch_lock = threading.Lock()
        self._batch_pending: dict[int, _BankBatchEntry] = {}
        self.launches = 0  # observability: actual device launches
        self.batched_requests = 0  # total probe requests served
        # LRU order of inserted (superbank key, segment key) for eviction.
        self._lru: dict[tuple, None] = {}
        # file pointer -> [(superbank key, segment key)] for invalidation.
        self._by_file: dict[bytes, list[tuple[tuple[int, int], bytes]]] = {}

    # -- residency ------------------------------------------------------

    @staticmethod
    def segment_key(file_pointer: bytes, group_idx: int) -> bytes:
        return hashlib.blake2b(
            file_pointer + b"#" + str(group_idx).encode(), digest_size=16
        ).digest()

    def total_bytes(self) -> int:
        with self._lock:
            return sum(sb.nbytes for sb in self._superbanks.values())

    def stats(self) -> dict:
        """Public observability snapshot (the contract engine.stats() uses)."""
        with self._lock:
            superbanks = {
                f"m={mk[0]},k={mk[1]},{mk[2]}": {
                    "blocks": sb.used - sb.dead,
                    "dead": sb.dead,
                    "capacity": sb.capacity,
                    "bytes": sb.nbytes,
                }
                for mk, sb in self._superbanks.items()
            }
            total = sum(sb.nbytes for sb in self._superbanks.values())
        return {
            "platform": self.platform,
            "mesh_devices": 1,
            "superbank_bytes": total,
            "superbanks": superbanks,
            "probe_launches": self.launches,
            "probe_requests": self.batched_requests,
        }

    def is_resident(self, mk: tuple, seg_key: bytes) -> bool:
        with self._lock:
            sb = self._superbanks.get(mk)
            return sb is not None and seg_key in sb.segments

    def release(self) -> None:
        """Drop every superbank (engine shutdown). The device memory returns
        to PyTorch's allocator once no in-flight probe snapshot holds it;
        probes after release fail — start-after-stop is already forbidden
        at the engine layer."""
        with self._lock:
            self._released = True
            banks = list(self._superbanks.values())
            self._superbanks.clear()
            self._lru.clear()
            self._by_file.clear()
        for sb in banks:
            sb.bank2d = None
            sb.segments = {}
            sb.capacity = sb.used = sb.dead = 0

    def invalidate(self, file_pointer: bytes) -> None:
        """Drop any cached banks of a tombstoned/replaced file."""
        with self._lock:
            for mk, seg_key in self._by_file.pop(file_pointer, []):
                sb = self._superbanks.get(mk)
                if sb is not None:
                    sb.remove(seg_key)
                    sb.maybe_compact()
                self._lru.pop((mk, seg_key), None)

    def _ensure_resident(
        self,
        file_pointer: bytes,
        mk: tuple,
        seg_key: bytes,
        loader: Callable[[], np.ndarray],
        yield_to=None,
    ) -> Superbank:
        """``yield_to`` is the engine's queries-in-flight gate for
        background callers. Uploads here are single copies (the JAX
        package's paused 8 MB staging pieces are not ported), so it is not
        polled."""
        with self._lock:
            if self._released:
                raise BackendReleasedError("probe backend released")
            sb = self._superbanks.get(mk)
            if sb is None:
                sb = Superbank(mk[0], mk[1], mk[2], self.device)
                self._superbanks[mk] = sb
            resident = seg_key in sb.segments
        if not resident:
            # Load AND upload OUTSIDE the lock (disk read + host work + h2d);
            # concurrent loaders of the same segment waste a read but stay
            # correct — the re-check under the lock inserts only once.
            host_bank = loader()
            staged = sb.stage(host_bank)
            with self._lock:
                if self._released:
                    raise BackendReleasedError("probe backend released")
                sb = self._superbanks.get(mk)
                if sb is None:
                    sb = Superbank(mk[0], mk[1], mk[2], self.device)
                    self._superbanks[mk] = sb
                if seg_key not in sb.segments:
                    sb.insert(seg_key, host_bank, staged=staged)
                    self._by_file.setdefault(file_pointer, []).append((mk, seg_key))
        with self._lock:
            self._lru.pop((mk, seg_key), None)
            self._lru[(mk, seg_key)] = None
            self._evict_if_needed()
            return sb

    def _reclaimable_bytes(self) -> int:
        """Bytes held by dead (tombstoned/evicted) columns, freeable by
        compaction without losing any warm segment."""
        return sum(
            sb.dead * sb.num_rows * 4 for sb in self._superbanks.values()
        )

    def _evict_if_needed(self) -> None:
        # Budget against the POST-compaction footprint: total_bytes() counts
        # capacity incl. dead columns, and an at-capacity insert would
        # otherwise evict ~half a superbank's LIVE warm segments before a
        # single real byte frees.
        while (
            self.total_bytes() - self._reclaimable_bytes() > self.cache_bytes
            and len(self._lru) > 1
        ):
            (mk, seg_key), _ = next(iter(self._lru.items()))
            self._lru.pop((mk, seg_key))
            sb = self._superbanks.get(mk)
            if sb is not None:
                sb.remove(seg_key)
                sb.maybe_compact()
            for pointer, segs in list(self._by_file.items()):
                remaining = [s for s in segs if s != (mk, seg_key)]
                if len(remaining) != len(segs):
                    if remaining:
                        self._by_file[pointer] = remaining
                    else:
                        self._by_file.pop(pointer)
                    break
        # Live fits but dead columns still hold REAL device memory past the
        # budget: force the reclaim now, largest reclaim first, re-testing
        # the budget between banks (each forced compaction is a full-bank
        # device gather under this lock).
        if self.total_bytes() > self.cache_bytes:
            for sb in sorted(
                self._superbanks.values(),
                key=lambda s: s.dead * s.num_rows,
                reverse=True,
            ):
                if self.total_bytes() <= self.cache_bytes:
                    break
                if sb.dead > 0:
                    sb.maybe_compact(force=True)

    # -- probing --------------------------------------------------------

    def precompile_probe_programs(self, yield_to=None) -> int:
        """Launch each epilogue once per resident superbank -> launches.

        The kernel library builds and loads on the first launch, so this
        moves that one-time cost (and the first launch on each bank) off
        the first query. ``yield_to`` is polled between launches (the
        engine's queries-in-flight gate)."""
        with self._lock:
            snapshots = [sb.bank2d for sb in self._superbanks.values()]
        launched = 0
        for bank2d in snapshots:
            if bank2d is None:
                continue
            probes = torch.zeros((2, 1), dtype=torch.int32, device=self.device)
            for launch in (
                lambda: probe_reduce_and_pack(bank2d, probes[0], probes[1], 1, 1, 1),
                lambda: probe_clauses_pack(bank2d, probes[0], probes[1], 1, 1, [1], [1]),
                lambda: probe_and_pack(bank2d, probes[0], probes[1], 1, 1),
            ):
                if yield_to is not None:
                    yield_to()
                launch()
                launched += 1
        return launched

    def probe_groups(
        self,
        requests: list[tuple[bytes, int, tuple[int, int], Callable[[], np.ndarray]]],
        terms,
        reduce_and: bool = False,
        clause_mask: Optional[np.ndarray] = None,
    ) -> dict[tuple[bytes, int], np.ndarray]:
        """Batched probe across files.

        ``requests``: (file_pointer, group_idx, (m_bits, k, layout), loader)
        where ``loader()`` reads the host bank uint32[3, W, B] if not yet
        resident. Returns {(file_pointer, group_idx): bool[T, B] match slice}.

        With ``reduce_and`` (flat-AND queries — the dominant shape), the
        AND over terms fuses into the probe program on-device and the
        returned slices are bool[1, B] survivor vectors: a T× smaller
        device→host transfer and no host expression evaluation.

        ``clause_mask`` (bool[C, T] from probe.compile_cnf_clauses) extends
        the same fusion to arbitrary monotone AND/OR trees: the CNF
        evaluates on-device and a bool[1, B] survivor vector returns. Pass
        it for flat-AND too (as the identity) so combined cross-query
        launches can fuse every member; shapes that exceed the CNF budget
        pass None and evaluate host-side over the full bitmap.

        Concurrency: residency may race with invalidation/compaction, so the
        bank tensor and all segment placements snapshot atomically under the
        lock; growth and compaction allocate new tensors and inserts write
        only slack columns (module doc), so probing the captured tensor with
        the captured placements stays consistent even if a concurrent
        tombstone compacts the live superbank meanwhile.
        """
        for _attempt in range(4):
            for file_pointer, group_idx, mk, loader in requests:
                seg_key = self.segment_key(file_pointer, group_idx)
                self._ensure_resident(file_pointer, mk, seg_key, loader)

            placements: dict[tuple[bytes, int], tuple[tuple, int, int]] = {}
            snapshots: dict[tuple, tuple] = {}
            with self._lock:
                ok = True
                for file_pointer, group_idx, mk, loader in requests:
                    seg_key = self.segment_key(file_pointer, group_idx)
                    sb = self._superbanks.get(mk)
                    if sb is None or seg_key not in sb.segments:
                        ok = False  # evicted between ensure and snapshot
                        break
                    start, n = sb.segments[seg_key]
                    placements[(file_pointer, group_idx)] = (mk, start, n)
                    snapshots[mk] = (sb.bank2d, sb.num_words, sb.capacity, sb.k, sb.layout, sb.m_bits)
            if not ok:
                continue

            matches: dict[tuple, np.ndarray] = {}
            for mk, (bank2d, num_words, capacity, k, layout, m_bits) in snapshots.items():
                word_idx, bit_idx = terms.positions_for(m_bits, k, layout)
                flat_rows = (
                    terms.ks_idx[:, None].astype(np.int32) * num_words + word_idx
                ).reshape(-1)
                matches[mk] = self._probe_superbank_batched(
                    bank2d,
                    capacity,
                    k,
                    flat_rows,
                    bit_idx.reshape(-1).astype(np.int32),
                    len(terms),
                    reduce_and,
                    clause_mask,
                )

            return {
                key: matches[mk][:, start : start + n]
                for key, (mk, start, n) in placements.items()
            }
        raise BankChurnError("bank segments kept churning during probe; cache too small?")

    # -- cross-query launch batching -------------------------------------

    def _probe_superbank_batched(
        self,
        bank2d,
        capacity: int,
        k: int,
        flat_rows: np.ndarray,
        shifts: np.ndarray,
        T: int,
        reduce_and: bool,
        clause_mask: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Probe one superbank snapshot, coalescing concurrent queries.

        Windowless batching: while one launch is in flight (its leader holds
        the per-bank launch lock), probes from other queries queue; whoever
        acquires the lock next launches EVERYTHING queued as one combined
        term batch and distributes the slices. Single queries see zero added
        latency; concurrent queries share launches, so the per-launch cost
        (launch, probe upload, bitmap fetch) amortizes across queries.

        Shape-space discipline: NO launch exceeds the caps (Tp<=16, at most
        16 clauses and 16 members), the JAX package's combiner caps. Requests
        with T > the term cap split into <=16-term
        chunks recombined host-side (AND for flat-AND; full-bitmap concat +
        host CNF otherwise); clause masks wider than the clause cap skip
        device fusion and evaluate host-side over the full bitmap. Both
        recombinations preserve this method's fusion contract ([1, B]
        survivors for reduce/clause requests).
        """
        if T > _PROBE_BATCH_MAX_TERMS:
            per = len(flat_rows) // T  # entries per term (= k hashes)
            parts = []
            for t0 in range(0, T, _PROBE_BATCH_MAX_TERMS):
                tn = min(_PROBE_BATCH_MAX_TERMS, T - t0)
                parts.append(
                    self._probe_superbank_batched(
                        bank2d, capacity, k,
                        flat_rows[t0 * per : (t0 + tn) * per],
                        shifts[t0 * per : (t0 + tn) * per],
                        tn, reduce_and, None,
                    )
                )
            if reduce_and:
                out = parts[0]
                for p in parts[1:]:
                    out = np.logical_and(out, p)
                return out
            full = np.concatenate(parts, axis=0)
            if clause_mask is not None:
                from .probe import evaluate_cnf_mask

                return evaluate_cnf_mask(clause_mask, full)[None, :]
            return full
        if (
            clause_mask is not None
            and not reduce_and
            and clause_mask.shape[0] > _PROBE_BATCH_MAX_CLAUSES
        ):
            full = self._probe_superbank_batched(
                bank2d, capacity, k, flat_rows, shifts, T, False, None
            )
            from .probe import evaluate_cnf_mask

            return evaluate_cnf_mask(clause_mask, full)[None, :]

        req = _PendingProbe(flat_rows, shifts, T, reduce_and, clause_mask)
        key = id(bank2d)
        with self._batch_lock:
            entry = self._batch_pending.get(key)
            # id() keys can recycle after GC: holding the bank ref in the
            # entry pins it, so an identity mismatch means a genuinely new
            # array took the address after the old entry drained.
            if entry is None or entry.bank is not bank2d:
                entry = _BankBatchEntry(bank2d)
                self._batch_pending[key] = entry
            entry.requests.append(req)
        # Loop until THIS request resolves: a leader drains at most a capped
        # FIFO prefix per launch (so combined launches never exceed the
        # caps); an undrained waiter
        # simply leads the next launch. Progress: every launch drains >= 1
        # request in FIFO order, and done-flags only flip under launch_lock.
        try:
            while not req.done.is_set():
                with entry.launch_lock:
                    if req.done.is_set():
                        break
                    # The entry stays in the map while this launch runs so
                    # new arrivals queue behind THIS lock (deleting it here
                    # would hand them a fresh, uncontended entry — no
                    # batching).
                    with self._batch_lock:
                        batch = []
                        total_t = total_c = 0
                        while entry.requests:
                            nxt = entry.requests[0]
                            nxt_c = (
                                nxt.clause_mask.shape[0]
                                if nxt.clause_mask is not None
                                else 0
                            )
                            if batch and (
                                len(batch) >= _PROBE_BATCH_MAX_MEMBERS
                                or total_t + nxt.T > _PROBE_BATCH_MAX_TERMS
                                or total_c + nxt_c > _PROBE_BATCH_MAX_CLAUSES
                            ):
                                break
                            batch.append(entry.requests.pop(0))
                            total_t += nxt.T
                            total_c += nxt_c
                    try:
                        self._launch_combined(bank2d, capacity, k, batch)
                    except BaseException as exc:
                        # Fail EVERYTHING pending on this entry, not just
                        # the drained batch: leaving undrained requests
                        # queued would abandon their waiting threads (and
                        # leak the entry's device-array ref if no further
                        # probe ever hits this bank). Each owner re-raises
                        # via its own req.error.
                        with self._batch_lock:
                            leftovers = entry.requests
                            entry.requests = []
                        for r in batch + leftovers:
                            r.error = exc
                            r.done.set()
                        break
        finally:
            # Drop the entry (and its bank ref) once nothing is pending; a
            # request appended concurrently keeps it alive and its own
            # thread will lead the next launch.
            with self._batch_lock:
                if self._batch_pending.get(key) is entry and not entry.requests:
                    del self._batch_pending[key]
        if req.error is not None:
            raise req.error
        return req.result

    def _launch_combined(
        self, bank2d, capacity: int, k: int, batch: list["_PendingProbe"]
    ) -> None:
        self.launches += 1
        self.batched_requests += len(batch)
        total_t = sum(r.T for r in batch)
        Tp = _pad_terms(total_t)
        flat_rows = np.concatenate([r.flat_rows for r in batch])
        shifts = np.concatenate([r.shifts for r in batch])
        if Tp != total_t:
            pad = (Tp - total_t) * k
            flat_rows = np.pad(flat_rows, (0, pad))
            shifts = np.pad(shifts, (0, pad))
        # One host-to-device copy for both probe arrays.
        probes = torch.from_numpy(
            np.stack([flat_rows, shifts]).astype(np.int32)
        ).to(bank2d.device)
        rows_dev, shifts_dev = probes[0], probes[1]

        # Fusion ladder:
        # 1. Solo flat-AND: the cheapest fully fused reduction.
        # 2. Every member carries a CNF clause mask: fuse ALL of them via
        #    the clause epilogue — each member transfers only a [1, C/32]
        #    survivor bitmap, even for OR-shaped trees and even combined.
        # 3. Otherwise: full [T, C/32] bitmap back, host evaluation.
        solo_fused = len(batch) == 1 and batch[0].reduce_and
        all_clauses = not solo_fused and all(
            r.clause_mask is not None for r in batch
        )
        if solo_fused:
            # Padding terms (t >= total_t) are outside the AND.
            packed = probe_reduce_and_pack(
                bank2d, rows_dev, shifts_dev, Tp, k, (1 << total_t) - 1
            )
        elif all_clauses:
            # One output row per member: bit t of a clause is the batch's
            # term t, bit i of a member is the batch's clause i. Padding
            # terms belong to no clause.
            clause_bits: list[int] = []
            member_bits: list[int] = []
            t0 = 0
            for r in batch:
                c0 = len(clause_bits)
                weights = 1 << np.arange(t0, t0 + r.T, dtype=np.int64)
                clause_bits.extend(
                    int(b) for b in (np.asarray(r.clause_mask) != 0).astype(np.int64) @ weights
                )
                member_bits.append(((1 << len(clause_bits)) - 1) ^ ((1 << c0) - 1))
                t0 += r.T
            packed = probe_clauses_pack(
                bank2d, rows_dev, shifts_dev, Tp, k, clause_bits, member_bits
            )
        else:
            packed = probe_and_pack(bank2d, rows_dev, shifts_dev, Tp, k)
        # int32 words on the device; the bytes are the uint32 bitmap.
        packed_host = packed.cpu().numpy().view(np.uint32)
        bits = np.unpackbits(packed_host.view(np.uint8), axis=1, bitorder="little")
        bits = bits[:, :capacity].astype(bool)

        if solo_fused:
            batch[0].result = bits[:1]
            batch[0].done.set()
            return
        if all_clauses:
            for mi, r in enumerate(batch):
                r.result = bits[mi : mi + 1]
                r.done.set()
            return
        cursor = 0
        for r in batch:
            sub = bits[cursor : cursor + r.T]
            cursor += r.T
            if r.reduce_and:
                sub = sub.all(axis=0, keepdims=True)
            elif r.clause_mask is not None:
                # Mixed batch took the full-bitmap path; honor this
                # member's fusion contract host-side so a clause request
                # ALWAYS yields [1, B] survivors.
                from .probe import evaluate_cnf_mask

                sub = evaluate_cnf_mask(r.clause_mask, sub)[None, :]
            r.result = sub
            r.done.set()


class _PendingProbe:
    __slots__ = (
        "flat_rows", "shifts", "T", "reduce_and", "clause_mask",
        "done", "result", "error",
    )

    def __init__(self, flat_rows, shifts, T, reduce_and, clause_mask=None):
        self.flat_rows = flat_rows
        self.shifts = shifts
        self.T = T
        self.reduce_and = reduce_and
        self.clause_mask = clause_mask  # bool[C, T] CNF; None = host eval
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _BankBatchEntry:
    __slots__ = ("bank", "requests", "launch_lock")

    def __init__(self, bank):
        self.bank = bank  # strong ref pins the id() while pending
        self.requests: list[_PendingProbe] = []
        self.launch_lock = threading.Lock()

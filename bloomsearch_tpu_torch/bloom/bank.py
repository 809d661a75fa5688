"""Device-resident filter superbanks and the device probe backend (PyTorch).

Every resident file's block filters live packed in a per-(m, k, layout)
device **superbank** ``int32[3 * num_words, capacity]`` (the host's uint32
words, viewed as int32). A query probes *all* resident blocks of a param
group in one kernel launch (kernels/probe.py) and slices per-file results
out of the packed survivor bitmap host-side. Files are immutable, so a bank
column never changes: inserts append, tombstones mark columns dead, and
compaction rebuilds when the dead fraction grows.

With a mesh (``mesh_devices``, parallel/mesh.py) the block axis shards
over several devices: ``bank2d`` is then a tuple of ``int32[3 * num_words,
capacity / n]`` shards, shard i holding columns ``[i*capacity/n,
(i+1)*capacity/n)`` on mesh device i, and a probe launches the kernel on
every shard and joins the packed bitmaps in shard order. Without one it is
a single tensor on one device.

Capacity is padded to a multiple of 128 × the mesh size and grows by
doubling, which keeps capacities, placements and the ``stats()`` block
counts identical to the JAX package's for the same mesh size (its bytes
also count 8-row padding that this layout drops); zero-filled columns can
never produce a bloom match, so padding and dead columns are inherently
masked.

Snapshot consistency: a probe captures ``bank2d`` (the whole tuple of
shards on a mesh) and the segment placements under the lock and may launch
after the lock is released. Growth and compaction therefore always allocate
NEW tensors (every shard), never rewrite one a snapshot may hold; an insert
writes in place only into slack columns past ``used``, which no placement
points at, and its copies are ordered on each device's current stream
before any later launch there.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.probe import probe_plan
from ..parallel.mesh import (
    LANE,
    default_mesh,
    mesh_for,
    shard_bank,
    sharded_pad_columns,
    sharded_probe,
    sharded_take_columns,
    sharded_update_columns,
    sharded_zeros,
)
from ..utils import remember


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


def _probe(mesh, bank2d, row_idx, shift, T: int, K: int, epilogue: str,
           **extra) -> torch.Tensor:
    """One probe call with an epilogue (``kernels.probe.EPILOGUE_MODES``)
    -> its packed int32 words on the host: the sharded wrapper on a mesh,
    else one launch of the plan entry over the one bank, into a page-locked
    buffer the kernel writes, so no copy follows."""
    if mesh is not None:
        return sharded_probe(mesh, bank2d, row_idx, shift, T, K, epilogue, **extra)
    return probe_plan([(0, [bank2d])], bank2d.shape[1] // 32, row_idx, shift, T, K, epilogue,
                      **extra)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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

    ``bank2d`` is ``int32[3 * num_words, capacity]`` on ``device`` (row =
    keyspace*num_words + word, capacity a multiple of 128), or with a
    ``mesh`` a tuple of its column shards, one per mesh device (capacity a
    multiple of 128 × the mesh size; module doc).
    """

    def __init__(self, m_bits: int, k: int, layout: str, device, mesh=None):
        self.m_bits = m_bits
        self.k = k
        self.layout = layout
        self.num_words = (m_bits + 31) // 32
        self.num_rows = 3 * self.num_words
        self.mesh = mesh
        # Staging device: uploads land on the first shard's device.
        self.device = mesh.devices[0] if mesh is not None else torch.device(device)
        # Shards must split the 128-column units evenly across devices.
        self.col_unit = LANE * (mesh.size if mesh is not None else 1)
        self.capacity = 0
        self.used = 0
        self.dead = 0
        self.bank2d: Optional[torch.Tensor] = None
        # key -> (start, num_cols); insertion order preserved for compaction.
        self.segments: dict[bytes, tuple[int, int]] = {}

    @property
    def nbytes(self) -> int:
        return self.num_rows * self.capacity * 4

    def _grow(self, min_capacity: int) -> None:
        new_cap = max(
            _round_up(min_capacity, self.col_unit), max(self.col_unit, self.capacity * 2)
        )
        if self.bank2d is None:
            self.bank2d = sharded_zeros(self.mesh, self.num_rows, new_cap, self.device)
        else:
            self.bank2d = sharded_pad_columns(self.mesh, self.bank2d, new_cap)
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
        self.bank2d = sharded_update_columns(self.mesh, self.bank2d, staged, self.used)
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
        it). The rebuilt bank is new tensors (module doc)."""
        if self.dead == 0 or (not force and self.dead * 2 < self.used):
            return
        cols = []
        new_segments: dict[bytes, tuple[int, int]] = {}
        cursor = 0
        for key, (start, n) in self.segments.items():
            cols.extend(range(start, start + n))
            new_segments[key] = (cursor, n)
            cursor += n
        new_cap = max(self.col_unit, _round_up(max(cursor, 1), self.col_unit))
        if cols:
            self.bank2d = sharded_take_columns(
                self.mesh, self.bank2d, np.asarray(cols, dtype=np.int64), new_cap
            )
        else:
            self.bank2d = sharded_zeros(self.mesh, self.num_rows, new_cap, self.device)
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
    mesh=None,
) -> Superbank:
    """The JAX package's Superbank state -> this package's Superbank.

    ``bank2d`` is the reference's uint32[rows8, capacity] (rows padded to a
    multiple of 8; a host copy, or the reference's array itself); the
    padding rows are dropped and every column keeps its placement, so both
    packages probe the same resident state. The port's bank shards over
    ``mesh``; with none, a reference array that lives on an n-device mesh
    gives an n-shard mesh on ``device`` (``default_mesh``)."""
    if mesh is None:
        n = len(getattr(getattr(bank2d, "sharding", None), "device_set", ()))
        mesh = default_mesh(n, device) if n > 1 else None
    sb = Superbank(m_bits, k, layout, device, mesh=mesh)
    # A private copy: inserts write the superbank in place.
    bank2d = np.array(np.asarray(bank2d)[: sb.num_rows], dtype=np.uint32)
    if bank2d.shape[0] != sb.num_rows or bank2d.shape[1] % sb.col_unit:
        raise ValueError(f"bank2d {bank2d.shape} does not fit m_bits={m_bits} on this mesh")
    if mesh is None:
        sb.bank2d = torch.from_numpy(bank2d.view(np.int32)).to(sb.device)
    else:
        sb.bank2d = shard_bank(mesh, bank2d)
    sb.capacity = bank2d.shape[1]
    sb.segments = dict(segments)
    sb.used = max((s + n for s, n in segments.values()), default=0)
    sb.dead = sb.used - sum(n for _, n in segments.values())
    return sb


class DeviceProbeBackend:
    """Caches filter banks on device and serves batched probes.

    ``probe_groups`` is the query-path entry point: given every candidate
    (file, bank-group) of a query, it ensures residency, runs ONE probe per
    superbank (the CUDA kernel on a card, its plain version on the CPU; on
    a mesh, one launch on every shard), and returns each file-group's
    term-match slice.

    ``device="cuda"`` with no visible card raises: it never falls back to
    the CPU. Pass ``device="cpu"`` explicitly for the plain versions.

    Multi-device: ``mesh_devices=None`` is auto (every visible device of
    ``device``'s type when there is more than one; the CPU counts as one),
    1 is a single device, and n shards every superbank's block axis over
    n devices (``parallel.mesh.default_mesh``: the first n cards, or n CPU
    shards). More cards than are visible raises; it never shrinks.
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
        self.mesh = mesh_for(mesh_devices, self.device)
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
        # The last TOMBSTONE_MEMORY tombstoned files (an ordered set): a
        # load of one that raced its tombstone never inserts afterwards.
        self._tombstoned: dict[bytes, None] = {}

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
            "mesh_devices": self.mesh.size if self.mesh is not None else 1,
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

    def invalidate(self, file_pointer: bytes, tombstoned: bool = False) -> None:
        """Drop any cached banks of a tombstoned/replaced file.

        ``tombstoned``: the file is gone for good, so a load of it that
        raced this call (a background warm, a warm-on-flush of a file a
        merge already replaced) does not insert its banks afterwards, where
        no later tombstone would remove them."""
        with self._lock:
            if tombstoned:
                remember(self._tombstoned, file_pointer)
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
                sb = Superbank(mk[0], mk[1], mk[2], self.device, self.mesh)
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
                    sb = Superbank(mk[0], mk[1], mk[2], self.device, self.mesh)
                    self._superbanks[mk] = sb
                if file_pointer in self._tombstoned:
                    return sb
                if seg_key not in sb.segments:
                    sb.insert(seg_key, host_bank, staged=staged)
                    self._by_file.setdefault(file_pointer, []).append((mk, seg_key))
        with self._lock:
            if file_pointer in self._tombstoned:
                return sb
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
        the first query. Each launch is the call a query makes
        (``_probe``), so every shard's device loads the kernel. ``yield_to``
        is polled between launches (the engine's queries-in-flight gate)."""
        with self._lock:
            snapshots = [sb.bank2d for sb in self._superbanks.values()]
        launched = 0
        zero = np.zeros(1, dtype=np.int32)  # host probe arrays, as a query's
        epilogues = (("reduce_and", {"and_bits": 1}),
                     ("clauses", {"clause_bits": [1], "member_bits": [1]}), ("pack", {}))
        for bank2d in snapshots:
            if bank2d is None:
                continue
            for epilogue, extra in epilogues:
                if yield_to is not None:
                    yield_to()
                _probe(self.mesh, bank2d, zero, zero, 1, 1, epilogue, **extra)
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
        (launch, bitmap fetch) amortizes across queries. A launch takes the
        batch's real term count; the probe arrays travel in its parameters.

        Shape-space discipline: NO launch exceeds the caps (T<=16, at most
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
        # Host arrays: the kernel takes them in its launch parameters, on
        # every shard's device alike.
        flat_rows = np.concatenate([r.flat_rows for r in batch]).astype(np.int32, copy=False)
        shifts = np.concatenate([r.shifts for r in batch]).astype(np.int32, copy=False)
        mesh = self.mesh

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
            packed = _probe(mesh, bank2d, flat_rows, shifts, total_t, k, "reduce_and",
                            and_bits=(1 << total_t) - 1)
        elif all_clauses:
            # One output row per member: bit t of a clause is the batch's
            # term t, bit i of a member is the batch's clause i.
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
            packed = _probe(mesh, bank2d, flat_rows, shifts, total_t, k, "clauses",
                            clause_bits=clause_bits, member_bits=member_bits)
        else:
            packed = _probe(mesh, bank2d, flat_rows, shifts, total_t, k, "pack")
        # int32 words on the host; the bytes are the uint32 bitmap.
        packed_host = packed.numpy().view(np.uint32)
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

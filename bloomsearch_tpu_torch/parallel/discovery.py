"""Peer discovery + capacity-aware shared-storage scatter/gather.

Completes the reference's distributed design sketch (README.md:397-418):
"query coordinator gets and prefilters file metadata", "scatters row group
processing among peers (with some intelligence about data size and load)",
peers "discovered via gossip", results "streamed back". Implemented here
the object-store way instead of gossip — peers heartbeat tiny records into
the SAME storage the dataset lives in (any :class:`ObjectStoreClient`), so
discovery needs no extra infrastructure and expired peers age out:

- :class:`PeerRegistry`: announce/heartbeat ``peers/<id>`` records
  ``{host, port, capacity, updated_at}``; ``live_peers()`` filters by TTL.
- :class:`CapacityScatterCoordinator`: prefilters the file list via its own
  MetaStore, assigns files to peers **proportionally to advertised
  capacity** (largest files first onto the least-loaded peer — greedy LPT),
  and fans each peer its disjoint subset over the
  :class:`RemoteQueryPeer` protocol's ``file_pointers`` restriction. Every
  file is scanned exactly once, so gathered rows are exact with no
  cross-peer dedup.

For data-partitioned deployments (each peer owns its own store) use the
plain :class:`ScatterGatherCoordinator` (distributed.py) — no assignment
needed.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

from ..query import Query
from .remote import RemoteQueryPeer

logger = logging.getLogger("bloomsearch_tpu_torch.discovery")

# Per-peer cap on BlockStats held back during exactly-once failover
# buffering; stats are a lossy stream by contract, so overflow drops.
_STATS_BUFFER_MAX = 4096


@dataclass(frozen=True)
class PeerInfo:
    peer_id: str
    host: str
    port: int
    capacity: float
    updated_at: float

    def remote(self, connect_timeout: float = 10.0) -> RemoteQueryPeer:
        return RemoteQueryPeer(self.host, self.port, connect_timeout)


class PeerRegistry:
    """Peer records in object storage; liveness = heartbeat recency."""

    def __init__(self, client, prefix: str = "peers/", ttl_seconds: float = 30.0):
        self.client = client
        self.prefix = prefix
        self.ttl_seconds = ttl_seconds

    def announce(
        self, peer_id: str, host: str, port: int, capacity: float = 1.0
    ) -> None:
        record = {
            "host": host,
            "port": port,
            "capacity": capacity,
            "updated_at": time.time(),
        }
        self.client.put(
            f"{self.prefix}{peer_id}", json.dumps(record).encode("utf-8")
        )

    def withdraw(self, peer_id: str) -> None:
        self.client.delete(f"{self.prefix}{peer_id}")

    def live_peers(self) -> list[PeerInfo]:
        cutoff = time.time() - self.ttl_seconds
        peers: list[PeerInfo] = []
        for key in self.client.list(self.prefix):
            try:
                data, _ = self.client.get(key)
                record = json.loads(data)
                if float(record["updated_at"]) < cutoff:
                    continue
                peers.append(
                    PeerInfo(
                        peer_id=key[len(self.prefix):],
                        host=record["host"],
                        port=int(record["port"]),
                        capacity=float(record.get("capacity", 1.0)),
                        updated_at=float(record["updated_at"]),
                    )
                )
            except (KeyError, ValueError, TypeError) as exc:
                logger.warning("skipping malformed peer record %s: %s", key, exc)
        return peers

    def heartbeat(
        self, peer_id: str, host: str, port: int, capacity: float = 1.0,
        interval: Optional[float] = None,
    ) -> "Heartbeat":
        """Announce now and keep re-announcing on a background thread."""
        hb = Heartbeat(
            self, peer_id, host, port, capacity,
            interval if interval is not None else self.ttl_seconds / 3,
        )
        hb.start()
        return hb


class Heartbeat:
    def __init__(self, registry: PeerRegistry, peer_id, host, port, capacity, interval):
        self.registry = registry
        self.peer_id = peer_id
        self.host, self.port, self.capacity = host, port, capacity
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.registry.announce(self.peer_id, self.host, self.port, self.capacity)
        self._thread = threading.Thread(
            target=self._loop, name=f"bloomsearch-heartbeat-{self.peer_id}", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.registry.announce(self.peer_id, self.host, self.port, self.capacity)
            except Exception:
                logger.exception("peer heartbeat failed")

    def stop(self, withdraw: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if withdraw:
            try:
                self.registry.withdraw(self.peer_id)
            except Exception:
                logger.exception("peer withdraw failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


@dataclass(frozen=True)
class MaybeFileStub:
    """(pointer, size) pair for reassignment — assign_files_by_capacity only
    reads these two fields of a MaybeFile."""

    pointer: bytes
    size: int


def assign_files_by_capacity(maybe_files, peers: Sequence[PeerInfo]):
    """Greedy LPT: largest file onto the relatively least-loaded peer.

    Returns {peer_index: set[file_pointer]}. Load is accumulated bytes
    normalized by capacity, so a capacity-2 peer receives ~2x the bytes.
    """
    if not peers:
        raise ValueError("no live peers to assign to")
    loads = [0.0] * len(peers)
    assignment: dict[int, set[bytes]] = {i: set() for i in range(len(peers))}
    for mf in sorted(maybe_files, key=lambda m: m.size, reverse=True):
        best = min(
            range(len(peers)),
            key=lambda i: (loads[i] + max(mf.size, 1)) / max(peers[i].capacity, 1e-9),
        )
        assignment[best].add(mf.pointer)
        loads[best] += max(mf.size, 1)
    return assignment


class CapacityScatterCoordinator:
    """Shared-storage scatter/gather: one dataset, many compute peers.

    The coordinator prefilters the file list through its own MetaStore
    (the reference sketch's step 1-2), splits candidate files across live
    peers by capacity, and gathers the disjoint streams. Semantics match
    the single-engine contract: unordered rows, one ``None`` sentinel,
    per-peer errors forwarded while others continue.
    """

    def __init__(
        self,
        meta_store,
        registry: PeerRegistry,
        max_retries: int = 1,
        failover_buffer_rows: int = 100_000,
        stale_snapshot_retries: int = 1,
    ):
        self.meta_store = meta_store
        self.registry = registry
        # Failed-peer retries: a dead peer's disjoint file subset reassigns
        # to the surviving peers this many times before the error surfaces.
        self.max_retries = max_retries
        # Per-peer cap on rows held back for exactly-once failover; past it
        # the peer's stream flushes through and a later death surfaces as
        # an error instead of a replay (bounded coordinator memory).
        self.failover_buffer_rows = failover_buffer_rows
        # A StaleFileAssignmentError (a merge/expiry published between this
        # coordinator's metadata snapshot and a peer's own listing) fails
        # DETERMINISTICALLY on every peer — reassignment can't absorb it,
        # and a per-subset retry could double-count rows whose merged
        # replacement file overlaps another peer's still-listed input. The
        # only exactly-once recovery is restarting the WHOLE query from a
        # fresh snapshot, discarding every buffered row of the failed
        # attempt; this is how many times to do that before surfacing the
        # error. Rows hold back globally up to failover_buffer_rows during
        # an attempt; past the cap the stream flushes through and a later
        # stale error surfaces instead of retrying (bounded memory, same
        # contract as peer failover).
        self.stale_snapshot_retries = stale_snapshot_retries

    def query(
        self,
        q: Optional[Query],
        result_queue: queue.Queue,
        error_queue: Optional[queue.Queue] = None,
        stats_queue: Optional[queue.Queue] = None,
    ) -> None:
        """Scatter/gather with the single-engine streaming contract:
        unordered rows then one ``None`` sentinel; errors on
        ``error_queue``. Stale-snapshot races (merge/expiry between this
        coordinator's file listing and a peer's) retry transparently from a
        fresh snapshot up to ``stale_snapshot_retries`` times."""
        if self.stale_snapshot_retries <= 0:
            self._query_attempt(q, result_queue, error_queue, stats_queue)
            return
        threading.Thread(
            target=self._query_with_snapshot_retries,
            args=(q, result_queue, error_queue, stats_queue),
            name="scatter-coordinator",
            daemon=True,
        ).start()

    def _query_with_snapshot_retries(
        self,
        q: Optional[Query],
        result_queue: queue.Queue,
        error_queue: Optional[queue.Queue],
        stats_queue: Optional[queue.Queue],
    ) -> None:
        from ..engine import StaleFileAssignmentError

        for attempt in range(self.stale_snapshot_retries + 1):
            rq: queue.Queue = queue.Queue()
            eq: queue.Queue = queue.Queue()
            sq: Optional[queue.Queue] = (
                queue.Queue(maxsize=_STATS_BUFFER_MAX)
                if stats_queue is not None
                else None
            )
            self._query_attempt(q, rq, eq, sq)
            # Hold rows back (bounded) so a stale-snapshot restart stays
            # exactly-once: nothing reaches the caller until the attempt
            # either completes or overflows the cap into stream-through.
            buffered: list = []
            streaming = False
            while True:
                item = rq.get()
                if item is None:
                    break
                if streaming:
                    result_queue.put(item)
                else:
                    buffered.append(item)
                    if len(buffered) > self.failover_buffer_rows:
                        streaming = True
                        for row in buffered:
                            result_queue.put(row)
                        buffered.clear()
            errors: list = []
            while True:
                try:
                    errors.append(eq.get_nowait())
                except queue.Empty:
                    break
            stale = any(
                isinstance(e, StaleFileAssignmentError) for e in errors
            )
            if stale and not streaming and attempt < self.stale_snapshot_retries:
                logger.warning(
                    "stale file assignment (merge/expiry during scatter); "
                    "retrying from a fresh metadata snapshot (%d/%d)",
                    attempt + 1, self.stale_snapshot_retries,
                )
                continue  # discard the attempt wholesale; stats too
            for row in buffered:
                result_queue.put(row)
            if sq is not None and stats_queue is not None:
                while True:
                    try:
                        st = sq.get_nowait()
                    except queue.Empty:
                        break
                    try:
                        stats_queue.put_nowait(st)  # lossy by contract
                    except queue.Full:
                        pass
            if error_queue is not None:
                for e in errors:
                    try:
                        error_queue.put_nowait(e)
                    except queue.Full:
                        pass
            result_queue.put(None)
            return

    def _query_attempt(
        self,
        q: Optional[Query],
        result_queue: queue.Queue,
        error_queue: Optional[queue.Queue] = None,
        stats_queue: Optional[queue.Queue] = None,
    ) -> None:
        prefilter = q.prefilter if q is not None else None
        maybe_files = self.meta_store.get_maybe_files_for_query(prefilter)
        peers = self.registry.live_peers()
        if not maybe_files or not peers:
            if maybe_files and not peers and error_queue is not None:
                try:
                    error_queue.put_nowait(RuntimeError("no live peers"))
                except queue.Full:
                    pass
            result_queue.put(None)
            return
        assignment = assign_files_by_capacity(maybe_files, peers)
        sizes = {mf.pointer: mf.size for mf in maybe_files}

        state = {"remaining": 0}
        lock = threading.Lock()

        def finish() -> None:
            with lock:
                state["remaining"] -= 1
                if state["remaining"] == 0:
                    result_queue.put(None)

        def launch(peer: PeerInfo, pointers: set, attempt: int) -> None:
            with lock:
                state["remaining"] += 1
            threading.Thread(
                target=funnel, args=(peer, pointers, attempt), daemon=True
            ).start()

        def forward_error(exc: BaseException) -> None:
            if error_queue is not None:
                try:
                    error_queue.put_nowait(exc)
                except queue.Full:
                    pass

        def funnel(peer: PeerInfo, pointers: set, attempt: int) -> None:
            # Rows buffer until the peer's stream completes CLEANLY: a
            # mid-stream peer death then discards the partial buffer and the
            # subset re-runs on survivors — exactly-once is preserved because
            # subsets are disjoint and nothing partial ever reached the
            # caller. (With max_retries=0 rows stream straight through.)
            #
            # The buffer is CAPPED (failover_buffer_rows): past the cap the
            # funnel flushes and switches to stream-through — coordinator
            # memory stays bounded and broad queries keep streaming, at the
            # price of failover for that peer (rows already delivered can't
            # be replayed exactly-once, so a later death surfaces as an
            # error like the reference's per-worker error semantics).
            # Stats buffer alongside rows and are DROPPED on a failed
            # buffered attempt — the survivor's re-run re-reports those
            # blocks, and forwarding both would double-count.
            peer_results: queue.Queue = queue.Queue()
            peer_errors: queue.Queue = queue.Queue()
            buffering = self.max_retries > 0
            buffered: list = []
            stats_buffer: list = []
            # Bounded: stats are lossy by contract (peers push with
            # try_put), so capping both the transfer queue and the holdback
            # buffer keeps coordinator memory bounded by block-stats volume
            # too, not just by failover_buffer_rows.
            peer_stats: Optional[queue.Queue] = (
                queue.Queue(maxsize=_STATS_BUFFER_MAX)
                if stats_queue is not None
                else None
            )
            failure: Optional[BaseException] = None

            def drain_stats(forward: bool) -> None:
                if peer_stats is None:
                    return
                while not peer_stats.empty():
                    st = peer_stats.get_nowait()
                    if forward and stats_queue is not None:
                        try:
                            stats_queue.put_nowait(st)  # lossy by contract
                        except queue.Full:
                            pass
                    elif not forward and len(stats_buffer) < _STATS_BUFFER_MAX:
                        stats_buffer.append(st)

            def flush_buffers() -> None:
                for row in buffered:
                    result_queue.put(row)
                buffered.clear()
                if stats_queue is not None:
                    for st in stats_buffer:
                        try:
                            stats_queue.put_nowait(st)
                        except queue.Full:
                            pass
                    stats_buffer.clear()

            try:
                peer.remote().query(
                    q, peer_results,
                    peer_errors if buffering else error_queue,
                    peer_stats if peer_stats is not None else None,
                    file_pointers=pointers,
                )
                while True:
                    item = peer_results.get()
                    drain_stats(forward=not buffering)
                    if item is None:
                        break
                    if buffering:
                        buffered.append(item)
                        if len(buffered) > self.failover_buffer_rows:
                            # Cap hit: this subset is now stream-through.
                            buffering = False
                            flush_buffers()
                    else:
                        result_queue.put(item)
            except Exception as exc:
                failure = exc
            if failure is None and not peer_errors.empty():
                failure = peer_errors.get_nowait()
            if failure is None:
                flush_buffers()
                drain_stats(forward=True)
                finish()
                return
            # Peer failed. Reassign its disjoint subset to survivors — but
            # only if nothing partial reached the caller (still buffering),
            # and never for a stale file assignment: that is the shared
            # metadata changing, not this peer dying — every survivor's own
            # listing lacks the same files, so reassignment deterministically
            # re-raises and burns the retries. It goes terminal here and the
            # coordinator restarts the whole query from a fresh snapshot
            # (_query_with_snapshot_retries).
            from ..engine import StaleFileAssignmentError as _Stale

            if (
                buffering
                and attempt < self.max_retries
                and not isinstance(failure, _Stale)
            ):
                survivors = [
                    p for p in self.registry.live_peers() if p.peer_id != peer.peer_id
                ]
                if survivors:
                    logger.warning(
                        "peer %s failed (%s); reassigning %d file(s) to %d survivor(s)",
                        peer.peer_id, failure, len(pointers), len(survivors),
                    )
                    stubs = [
                        MaybeFileStub(pointer, sizes.get(pointer, 1))
                        for pointer in pointers
                    ]
                    sub = assign_files_by_capacity(stubs, survivors)
                    for i, sub_pointers in sub.items():
                        if sub_pointers:
                            launch(survivors[i], sub_pointers, attempt + 1)
                    finish()
                    return
            # Terminal: no retry left (or partials already streamed).
            # Deliver whatever healthy rows this attempt produced ALONGSIDE
            # the error — the local engine's per-block semantics (good
            # blocks' rows + an error for the bad one). Discarding the
            # buffer here would silently lose data the caller can never
            # recover: e.g. one corrupt block makes a whole file subset
            # return zero rows. Exactly-once holds — these rows were never
            # flushed before, and no retry follows.
            flush_buffers()
            drain_stats(forward=True)
            forward_error(failure)
            finish()

        with lock:
            state["remaining"] += 1  # guard: hold the sentinel until all launch
        for i, pointers in assignment.items():
            if pointers:
                launch(peers[i], pointers, 0)
        finish()  # release the guard

    def query_sync(self, q: Optional[Query], timeout: Optional[float] = None) -> list[dict]:
        result_queue: queue.Queue = queue.Queue()
        error_queue: queue.Queue = queue.Queue()
        self.query(q, result_queue, error_queue)
        rows = []
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            item = result_queue.get(timeout=remaining)
            if item is None:
                break
            rows.append(item)
        try:
            raise error_queue.get_nowait()
        except queue.Empty:
            pass
        return rows

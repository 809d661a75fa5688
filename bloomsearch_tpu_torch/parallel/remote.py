"""Remote scatter/gather transport: QueryServer + RemoteQueryPeer.

The cross-host half of the reference's scatter/gather design
(README.md:397-418 — coordinator prefilters, scatters to peers, peers
stream rows back per query; never implemented there). A
:class:`QueryServer` wraps any local ``QueryPeer`` (a
``BloomSearchEngine``) behind a minimal length-prefixed-JSON TCP protocol;
a :class:`RemoteQueryPeer` speaks that protocol and satisfies the same
``QueryPeer`` protocol, so remote engines drop straight into
:class:`ScatterGatherCoordinator` (distributed.py) with no coordinator
changes.

Wire protocol (one TCP connection per query — concurrent queries are
concurrent connections, so no query-id multiplexing is needed):

- frame = uint32 LE payload length + UTF-8 JSON payload
- client -> server: ``{"query": <query_to_json(q)> | null}``
- server -> client, streamed: ``{"row": {...}}`` per result (unordered),
  then ``{"stats": [...]}}`` (lossy, per-block), ``{"error": "..."}`` per
  worker error, and finally ``{"done": true}``.

Failure semantics match the reference's per-worker model: a peer that dies
mid-stream forwards a ``ConnectionError`` to the coordinator's error queue
and its stream terminates; other peers complete unaffected (tested in
tests/test_remote.py).
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import struct
import threading
from typing import Optional

from ..engine import BlockStats, StaleFileAssignmentError, try_put
from ..query import Query, query_from_json, query_to_json

logger = logging.getLogger("bloomsearch_tpu_torch.remote")

_LEN = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024


def send_frame(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Optional[dict]:
    """One frame, or None on clean EOF. Raises ConnectionError mid-frame."""
    header = _recv_exact(sock, _LEN.size, eof_ok=True)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ConnectionError(f"frame too large: {length}")
    payload = _recv_exact(sock, length, eof_ok=False)
    return json.loads(payload)


def _recv_exact(sock: socket.socket, n: int, eof_ok: bool) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise ConnectionError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _stats_to_json(s: BlockStats) -> dict:
    return {
        "file_pointer": s.file_pointer.hex(),
        "block_offset": s.block_offset,
        "rows_processed": s.rows_processed,
        "bytes_processed": s.bytes_processed,
        "total_rows": s.total_rows,
        "total_bytes": s.total_bytes,
        "duration": s.duration,
        "bloom_filter_skipped": s.bloom_filter_skipped,
    }


def _stats_from_json(o: dict) -> BlockStats:
    return BlockStats(
        file_pointer=bytes.fromhex(o["file_pointer"]),
        block_offset=o["block_offset"],
        rows_processed=o["rows_processed"],
        bytes_processed=o["bytes_processed"],
        total_rows=o["total_rows"],
        total_bytes=o["total_bytes"],
        duration=o["duration"],
        bloom_filter_skipped=o["bloom_filter_skipped"],
    )


class QueryServer:
    """Serve a local engine's query path to remote peers over TCP."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self._listener = socket.create_server((host, port))
        # Closing a socket does not reliably wake a thread blocked in
        # accept() on Linux; poll with a short timeout instead.
        self._listener.settimeout(0.2)
        self.host, self.port = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="bloomsearch-query-server", daemon=True
        )
        self._accept_thread.start()

    def stop(self) -> None:
        """Close the listener and sever active streams (clients observe a
        ConnectionError — the peer-failure path)."""
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            conn.settimeout(None)
            with self._conn_lock:
                self._conns.add(conn)
            # Re-check AFTER registering: stop() may have snapshotted
            # _conns between accept() returning and the add above — a
            # missed connection would run a full query against an engine
            # being torn down ("sever active streams" silently unmet).
            if self._stop.is_set():
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
                return
            threading.Thread(
                target=self._serve_one, args=(conn,), daemon=True
            ).start()

    def _serve_one(self, conn: socket.socket) -> None:
        cancel = threading.Event()
        try:
            request = recv_frame(conn)
            if request is None:
                return
            q = query_from_json(request.get("query"))
            fps = request.get("file_pointers")
            file_pointers = (
                {bytes.fromhex(p) for p in fps} if fps is not None else None
            )
            result_q: queue.Queue = queue.Queue()
            error_q: queue.Queue = queue.Queue()
            stats_q: queue.Queue = queue.Queue(maxsize=100_000)
            self.engine.query(
                q, result_q, error_q, stats_q, cancel_event=cancel,
                file_pointers=file_pointers,
            )
            while True:
                item = result_q.get()
                if item is None:
                    break
                send_frame(conn, {"row": item})
            stats = []
            while True:
                try:
                    stats.append(_stats_to_json(stats_q.get_nowait()))
                except queue.Empty:
                    break
            if stats:
                send_frame(conn, {"stats": stats})
            while True:
                try:
                    err = error_q.get_nowait()
                except queue.Empty:
                    break
                frame = {"error": repr(err)}
                # Typed errors the coordinator reacts to structurally (a
                # stale file assignment triggers a fresh-snapshot retry, not
                # peer failover) carry a kind tag — repr alone reconstructs
                # as an opaque RuntimeError on the client.
                if isinstance(err, StaleFileAssignmentError):
                    frame["error_kind"] = "stale_file_assignment"
                send_frame(conn, frame)
            send_frame(conn, {"done": True})
        except (ConnectionError, OSError) as exc:
            cancel.set()  # client went away mid-stream: stop block workers
            logger.debug("query connection dropped: %s", exc)
        except Exception:
            cancel.set()
            logger.exception("query server connection failed")
            try:
                send_frame(conn, {"error": "internal server error", "done": True})
            except OSError:
                pass
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class RemoteQueryPeer:
    """A ``QueryPeer`` proxy for an engine behind a :class:`QueryServer`.

    Satisfies the same streaming contract as ``BloomSearchEngine.query``:
    unordered rows then a ``None`` sentinel; transport failures surface on
    ``error_queue`` and the stream terminates (other peers in a
    scatter/gather keep going).
    """

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0):
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout

    def query(
        self,
        q: Optional[Query],
        result_queue: queue.Queue,
        error_queue: Optional[queue.Queue] = None,
        stats_queue: Optional[queue.Queue] = None,
        cancel_event: Optional[threading.Event] = None,
        file_pointers: Optional[set] = None,
    ) -> None:
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout
            )
            sock.settimeout(None)
            request: dict = {"query": query_to_json(q)}
            if file_pointers is not None:
                request["file_pointers"] = sorted(p.hex() for p in file_pointers)
            send_frame(sock, request)
        except OSError as exc:
            try_put(error_queue, ConnectionError(f"peer {self.host}:{self.port}: {exc}"))
            result_queue.put(None)
            return

        done = threading.Event()
        if cancel_event is not None:
            # Cancellation must work while the reader is PARKED in a
            # blocking recv (a quiet stream produced no frame to observe
            # the flag between): a side watcher closes the socket, which
            # both unblocks the reader and makes the server's next send
            # fail — tripping its own cancel path so the remote engine
            # stops executing the query.
            def watcher() -> None:
                while not done.is_set():
                    if cancel_event.wait(timeout=0.2):
                        # shutdown BEFORE close: closing an fd does not
                        # reliably wake a thread blocked in recv on it;
                        # shutdown(SHUT_RDWR) does.
                        try:
                            sock.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        try:
                            sock.close()
                        except OSError:
                            pass
                        return

            threading.Thread(target=watcher, daemon=True).start()

        def reader() -> None:
            canceled = lambda: cancel_event is not None and cancel_event.is_set()
            try:
                while True:
                    if canceled():
                        return
                    frame = recv_frame(sock)
                    if frame is None:
                        raise ConnectionError("peer closed stream before done")
                    if "row" in frame:
                        result_queue.put(frame["row"])
                    if "stats" in frame:
                        for s in frame["stats"]:
                            try_put(stats_queue, _stats_from_json(s))
                    if "error" in frame:
                        msg = f"peer {self.host}:{self.port}: {frame['error']}"
                        if frame.get("error_kind") == "stale_file_assignment":
                            err: BaseException = StaleFileAssignmentError(msg)
                        else:
                            err = RuntimeError(msg)
                        try_put(error_queue, err)
                    if frame.get("done"):
                        return
            except (ConnectionError, OSError) as exc:
                if not canceled():  # watcher-closed socket is expected
                    try_put(
                        error_queue,
                        ConnectionError(
                            f"peer {self.host}:{self.port} died mid-stream: {exc}"
                        ),
                    )
            except BaseException as exc:
                # Malformed/version-skewed frames (JSONDecodeError from
                # recv_frame, KeyError in _stats_from_json, ...) must
                # surface as an ERROR: the finally below posts the
                # completion sentinel either way, and a clean-looking early
                # completion would silently truncate this peer's rows — a
                # false negative with no signal.
                try_put(
                    error_queue,
                    RuntimeError(
                        f"peer {self.host}:{self.port} stream error: {exc!r}"
                    ),
                )
            finally:
                done.set()
                try:
                    sock.close()
                except OSError:
                    pass
                result_queue.put(None)

        threading.Thread(target=reader, daemon=True).start()

    def query_sync(self, q: Optional[Query], timeout: Optional[float] = None) -> list[dict]:
        from ..utils import collect_query_sync

        return collect_query_sync(self.query, q, timeout)

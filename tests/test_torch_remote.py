"""The reference's remote scatter/gather tests (``tests/test_remote.py``) on the port.

Each test runs its case on the port (engines on ``device="cpu"`` with
``probe_backend="device"``, so every probe goes through the port's device
backend and its bank combiner) and, where the case returns rows, the same
case on the JAX package over the same rows: the row sets must be equal, and
each must meet the reference test's own assertion.

The last tests hold the port's own risk on this path: a client that
disconnects while its query waits in the bank combiner's batch or in the row
cache's scan combiner. Every socket wait has a timeout of its own.
"""

import json
import queue
import socket
import threading
import time

import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu.parallel as jpar  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
import bloomsearch_tpu_torch.parallel as tpar  # noqa: E402
from bloomsearch_tpu.parallel import remote as jremote  # noqa: E402
from bloomsearch_tpu_torch.parallel import remote as tremote  # noqa: E402

TIMEOUT = 15.0
PKGS = {"jax": (bs, jpar, jremote), "port": (bt, tpar, tremote)}


def engine_config(pkg, **kw):
    if pkg is bt:
        kw.setdefault("device", "cpu")
        kw.setdefault("probe_backend", "device")
    else:
        kw.setdefault("mesh_devices", 1)  # not the conftest's 8 virtual CPU devices
    return pkg.BloomSearchEngineConfig(row_data_compression="none", **kw)


def make_engine(pkg, directory, rows, **kw):
    store = pkg.FileSystemDataStore(str(directory))
    engine = pkg.BloomSearchEngine(engine_config(pkg, **kw), store, store)
    engine.start()
    engine.ingest_rows(rows, timeout=TIMEOUT)
    engine.flush(timeout=TIMEOUT)
    return engine


def rowset(rows) -> list[str]:
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


def on_both(tmp_path, case) -> dict:
    """``case(pkg, par, remote, directory)`` on each package in a directory of
    its own -> {package name: its result}; the results must be equal."""
    out = {name: case(*mods, tmp_path / name) for name, mods in PKGS.items()}
    assert out["port"] == out["jax"]
    return out


def drain(result_q: queue.Queue) -> list:
    rows = []
    while True:
        item = result_q.get(timeout=TIMEOUT)
        if item is None:
            return rows
        rows.append(item)


def listener() -> socket.socket:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(4)
    sock.settimeout(TIMEOUT)
    return sock


# -- TestQuerySerialization -----------------------------------------------------


def full_query(m):
    return (
        m.new_query()
        .match(m.or_(m.field_token("svc", "auth"), m.and_(m.token("error"), m.field("trace.id"))))
        .field_regex("msg", r"time\d+out")
        .match_prefilter(m.prefilter_and(
            m.partition(m.partition_in("00", "01")),
            m.min_max("ts", m.numeric_between(10, 99)),
        ))
        .build()
    )


@pytest.mark.parametrize("shape", ["full", "empty", "partition"])
def test_query_json_round_trip_and_wire_equal_to_reference(shape):
    """A query survives its JSON form in the port, the port's JSON is the
    reference's byte for byte, and each package parses the other's."""
    build = {
        "full": full_query,
        "empty": lambda m: m.new_query().build(),
        "partition": lambda m: m.new_query().token("x").match_prefilter(
            m.partition(m.partition_equals("07"))).build(),
    }[shape]
    port_q, jax_q = build(bt), build(bs)
    port_wire = json.dumps(bt.query.query_to_json(port_q))
    assert port_wire == json.dumps(bs.query.query_to_json(jax_q))
    assert bt.query.query_from_json(json.loads(port_wire)) == port_q
    assert bs.query.query_from_json(json.loads(port_wire)) == jax_q


def test_none_query_round_trips():
    assert bt.query.query_to_json(None) is None
    assert bt.query.query_from_json(None) is None


# -- TestRemotePeer -------------------------------------------------------------


def test_remote_query_matches_local(tmp_path):
    rows = [{"n": i, "svc": "auth", "msg": f"tok{i}"} for i in range(20)]

    def case(pkg, par, _, directory):
        engine = make_engine(pkg, directory, rows)
        try:
            with par.QueryServer(engine) as server:
                peer = par.RemoteQueryPeer(*server.address)
                q = pkg.new_query().token("tok7").build()
                got = peer.query_sync(q, timeout=TIMEOUT)
                assert got == engine.query_sync(q, timeout=TIMEOUT)
                everything = peer.query_sync(None, timeout=TIMEOUT)
                assert sorted(r["n"] for r in everything) == list(range(20))
                return rowset(got), rowset(everything)
        finally:
            engine.stop(timeout=TIMEOUT)

    on_both(tmp_path, case)


def test_stats_forwarded(tmp_path):
    def case(pkg, par, _, directory):
        engine = make_engine(pkg, directory, [{"msg": "hello"}])
        try:
            with par.QueryServer(engine) as server:
                peer = par.RemoteQueryPeer(*server.address)
                result_q, stats_q = queue.Queue(), queue.Queue()
                peer.query(pkg.new_query().token("hello").build(), result_q, None, stats_q)
                rows = drain(result_q)
                stats = [stats_q.get_nowait() for _ in range(stats_q.qsize())]
                assert stats and all(isinstance(s, pkg.BlockStats) for s in stats)
                assert any(s.rows_processed == 1 for s in stats)
                return rowset(rows), sorted(s.rows_processed for s in stats)
        finally:
            engine.stop(timeout=TIMEOUT)

    on_both(tmp_path, case)


def test_connect_failure_reports_error_and_completes():
    peer = tpar.RemoteQueryPeer("127.0.0.1", 1, connect_timeout=0.5)  # nothing there
    result_q, error_q = queue.Queue(), queue.Queue()
    peer.query(bt.new_query().token("x").build(), result_q, error_q)
    assert result_q.get(timeout=TIMEOUT) is None
    assert isinstance(error_q.get_nowait(), ConnectionError)


def test_stale_assignment_error_typed_across_the_wire(tmp_path):
    def case(pkg, par, _, directory):
        engine = make_engine(pkg, directory, [{"msg": "x"}])
        try:
            with par.QueryServer(engine) as server:
                peer = par.RemoteQueryPeer(*server.address)
                result_q, error_q = queue.Queue(), queue.Queue()
                peer.query(pkg.new_query().token("x").build(), result_q, error_q,
                           file_pointers={b"\x00" * 8})  # listed nowhere
                rows = drain(result_q)
                err = error_q.get_nowait()
                assert isinstance(err, pkg.StaleFileAssignmentError), err
                return rowset(rows)
        finally:
            engine.stop(timeout=TIMEOUT)

    assert on_both(tmp_path, case)["port"] == []


def test_invalid_regex_surfaces_as_error(tmp_path):
    engine = make_engine(bt, tmp_path / "a", [{"msg": "x"}])
    try:
        with tpar.QueryServer(engine) as server:
            peer = tpar.RemoteQueryPeer(*server.address)
            q = bt.new_query().field_regex("msg", "[invalid").build()
            with pytest.raises(Exception):
                peer.query_sync(q, timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


# -- TestRemoteScatterGather ------------------------------------------------------


def test_coordinator_over_remote_peers(tmp_path):
    def case(pkg, par, _, directory):
        a = make_engine(pkg, directory / "a",
                        [{"n": i, "site": "a", "tag": "common"} for i in range(5)])
        b = make_engine(pkg, directory / "b",
                        [{"n": i, "site": "b", "tag": "common"} for i in range(5, 9)])
        try:
            with par.QueryServer(a) as sa, par.QueryServer(b) as sb:
                coord = par.ScatterGatherCoordinator(
                    [par.RemoteQueryPeer(*sa.address), par.RemoteQueryPeer(*sb.address)])
                rows = coord.query_sync(pkg.new_query().token("common").build(),
                                        timeout=TIMEOUT)
                assert sorted(r["n"] for r in rows) == list(range(9))
                return rowset(rows)
        finally:
            a.stop(timeout=TIMEOUT)
            b.stop(timeout=TIMEOUT)

    on_both(tmp_path, case)


def test_peer_killed_mid_stream_others_complete(tmp_path):
    """The reference's failure model: the killed peer's failure is reported,
    the healthy peer's rows all arrive."""

    def case(pkg, par, _, directory):
        class SlowOpenStore(pkg.FileSystemDataStore):
            delay = 0.0

            def open_file(self, pointer):
                if self.delay:
                    time.sleep(self.delay)
                return super().open_file(pointer)

        slow_store = SlowOpenStore(str(directory / "slow"))
        slow = pkg.BloomSearchEngine(engine_config(pkg), slow_store, slow_store)
        slow.start()
        for i in range(4):
            slow.ingest_rows([{"n": i, "tag": "common"}], timeout=TIMEOUT)
            slow.flush(timeout=TIMEOUT)
        fast = make_engine(pkg, directory / "fast",
                           [{"n": 100 + i, "tag": "common"} for i in range(3)])
        try:
            server_slow = par.QueryServer(slow)
            server_slow.start()
            with par.QueryServer(fast) as server_fast:
                # Longer than the reference's 0.2 s: the port's banks are
                # resident since their flush, so its four block reads alone
                # (0.2 s each, in parallel) would finish before the kill.
                slow_store.delay = 1.0
                coord = par.ScatterGatherCoordinator([
                    par.RemoteQueryPeer(*server_slow.address),
                    par.RemoteQueryPeer(*server_fast.address),
                ])
                result_q, error_q = queue.Queue(), queue.Queue()
                coord.query(pkg.new_query().token("common").build(), result_q, error_q)
                time.sleep(0.3)  # the slow peer is mid-stream
                server_slow.stop()
                rows = drain(result_q)
                got_fast = sorted(r["n"] for r in rows if r["n"] >= 100)
                assert got_fast == [100, 101, 102]
                err = error_q.get(timeout=TIMEOUT)
                assert isinstance(err, (ConnectionError, RuntimeError)), err
                return got_fast
        finally:
            slow.stop(timeout=TIMEOUT)
            fast.stop(timeout=TIMEOUT)

    on_both(tmp_path, case)


# -- TestConcurrentRemoteQueries -------------------------------------------------


def test_many_queries_one_server(tmp_path):
    rows = [{"n": i, "msg": f"tok{i} all"} for i in range(50)]

    def case(pkg, par, _, directory):
        engine = make_engine(pkg, directory, rows)
        try:
            with par.QueryServer(engine) as server:
                peer = par.RemoteQueryPeer(*server.address)
                results, errors = {}, []

                def one(i):
                    try:
                        results[i] = peer.query_sync(pkg.new_query().token(f"tok{i}").build(),
                                                     timeout=TIMEOUT)
                    except Exception as exc:
                        errors.append(exc)

                threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(TIMEOUT)
                assert not errors and not any(t.is_alive() for t in threads)
                for i in range(12):
                    assert results[i] == [rows[i]], i
                return [rowset(results[i]) for i in range(12)]
        finally:
            engine.stop(timeout=TIMEOUT)

    on_both(tmp_path, case)


# -- TestStreamHardening -----------------------------------------------------------


def test_malformed_frame_surfaces_error_not_truncation():
    """A garbage stats frame mid-stream puts an error on the error queue:
    the completion sentinel alone would read as a clean, truncated result."""
    lsock = listener()

    def server():
        conn, _ = lsock.accept()
        conn.settimeout(TIMEOUT)
        conn.recv(1 << 16)  # the query request
        tremote.send_frame(conn, {"row": {"a": 1}})
        tremote.send_frame(conn, {"stats": [{"bogus": True}]})
        tremote.send_frame(conn, {"done": True})
        conn.close()

    threading.Thread(target=server, daemon=True).start()
    try:
        peer = tpar.RemoteQueryPeer("127.0.0.1", lsock.getsockname()[1])
        result_q, error_q, stats_q = queue.Queue(), queue.Queue(), queue.Queue()
        peer.query(bt.new_query().token("x").build(), result_q, error_q, stats_q)
        assert drain(result_q) == [{"a": 1}]
        assert "stream error" in repr(error_q.get_nowait())
    finally:
        lsock.close()


def test_cancel_unblocks_parked_reader():
    """The cancel event takes effect while the reader is blocked in recv
    on a quiet stream (the watcher closes the socket)."""
    lsock = listener()
    held = []

    def server():
        conn, _ = lsock.accept()
        conn.settimeout(TIMEOUT)
        conn.recv(1 << 16)
        held.append(conn)  # never answers: the reader parks in recv

    threading.Thread(target=server, daemon=True).start()
    try:
        peer = tpar.RemoteQueryPeer("127.0.0.1", lsock.getsockname()[1])
        result_q, error_q = queue.Queue(), queue.Queue()
        cancel = threading.Event()
        peer.query(bt.new_query().token("x").build(), result_q, error_q, cancel_event=cancel)
        time.sleep(0.3)  # the reader is parked in recv
        cancel.set()
        assert result_q.get(timeout=5.0) is None
        assert error_q.empty()
    finally:
        for conn in held:
            conn.close()
        lsock.close()


# -- the port's own risk: a disconnect while the query waits in a combiner ------

CANCEL_ROWS = [{"n": i, "msg": f"tok{i % 4} word{i}"} for i in range(40)]
CANCEL_TOKENS = ("tok0", "tok1", "tok2")  # the leader's, the cancelled one's, a partner's


class Gate:
    """Holds the first call of ``fn`` until ``release``; later calls pass."""

    def __init__(self, fn):
        self.fn = fn
        self.entered = threading.Event()
        self.opened = threading.Event()
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls == 1:
            self.entered.set()
            assert self.opened.wait(TIMEOUT), "gate never released"
        return self.fn(*args, **kwargs)


def wait_for(predicate, what: str, timeout: float = TIMEOUT) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def combiner_gate(engine, monkeypatch, where: str):
    """-> (gate, number of requests waiting behind it) for the bank
    combiner's launch or the row cache's scan launch."""
    if where == "bank":
        backend = engine._device_backend
        gate = Gate(backend._launch_combined)
        monkeypatch.setattr(backend, "_launch_combined", gate)

        def waiting():
            with backend._batch_lock:
                return sum(len(e.requests) for e in backend._batch_pending.values())
    else:
        cache = engine._row_cache
        gate = Gate(cache._launch_bucket_scan)
        monkeypatch.setattr(cache, "_launch_bucket_scan", gate)

        def waiting():
            with cache._lock:
                return len(cache._bucket.pending)
    return gate, waiting


@pytest.mark.parametrize("where", ["bank", "scan"])
def test_disconnect_while_waiting_in_a_combiner(tmp_path, monkeypatch, where):
    """Three remote queries share one combined launch, held at the launch:
    the leader's and two waiting behind it. The client of one waiting query
    disconnects. The other two get exactly the JAX engine's rows; the
    cancelled query leaves the engine's active and draining sets and the
    server's connections."""
    serving = where == "scan"
    kw = dict(row_cache_bytes=16 << 20, row_cache_async_pins=False) if serving else {}
    engine = make_engine(bt, tmp_path / "port", CANCEL_ROWS, **kw)
    reference = make_engine(bs, tmp_path / "jax", CANCEL_ROWS, **kw)
    try:
        want = {t: rowset(reference.query_sync(bs.new_query().token(t).build(), timeout=TIMEOUT))
                for t in CANCEL_TOKENS}
        if serving:
            engine._row_cache.needle_cache_enabled = False
            engine.query_sync(bt.new_query().token("word1").build(), timeout=TIMEOUT)  # pins
            assert engine.stats()["row_cache"]["pinned_blocks"] == 1
        else:
            engine.query_sync(bt.new_query().token("word1").build(), timeout=TIMEOUT)  # warms
        gate, waiting = combiner_gate(engine, monkeypatch, where)
        with tpar.QueryServer(engine) as server:
            results = {t: queue.Queue() for t in CANCEL_TOKENS}
            cancel = threading.Event()

            def ask(token, cancel_event=None):
                tpar.RemoteQueryPeer(*server.address).query(
                    bt.new_query().token(token).build(), results[token], queue.Queue(),
                    cancel_event=cancel_event)

            ask("tok0")
            assert gate.entered.wait(TIMEOUT), "the leader never reached the launch"
            ask("tok1", cancel)
            ask("tok2")
            wait_for(lambda: waiting() >= 2, "two queries waiting behind the launch")
            cancel.set()
            assert results["tok1"].get(timeout=TIMEOUT) is None  # the client side ends
            time.sleep(0.3)  # the watcher has closed the socket
            gate.opened.set()
            got = {t: rowset(drain(results[t])) for t in ("tok0", "tok2")}
            assert got == {t: want[t] for t in ("tok0", "tok2")}
            assert all(len(r) == 10 for r in got.values())
            wait_for(lambda: not engine._active_query_ids and not engine._draining_query_ids,
                     "the engine's query sets to empty")
            wait_for(lambda: not server._conns, "the server's connections to close")
        assert gate.calls >= 1
        # The engine still answers exactly afterwards.
        assert rowset(engine.query_sync(bt.new_query().token("tok1").build(),
                                        timeout=TIMEOUT)) == want["tok1"]
    finally:
        engine.stop(timeout=TIMEOUT)
        reference.stop(timeout=TIMEOUT)

"""Peer discovery and capacity scatter/gather on the port, against the JAX package.

Three parts:

- the reference's ``tests/test_discovery.py`` and ``tests/test_serve.py``
  on the port: each case runs on the port (engines on ``device="cpu"``,
  ``probe_backend="device"``) and, where it returns rows, on the JAX package
  over the same data; the row sets must be equal and meet the reference's
  assertion;
- the card's serving configuration on the CPU: two port peers and two JAX
  peers, each pair over its own copy of one object-store bucket in the
  refscale layout (files of 10 partitions, a block each), serving with the
  row cache on, so the host shadow resolves on (the object store has no
  fast ranged reads), cold as ``serve`` starts them, behind its package's
  ``CapacityScatterCoordinator`` with capacities 2 and 1. Both take cold
  queries, warm queries, a merge by a third engine under the lease that
  lands between the coordinator's snapshot and the peers' plans (so the
  stale-snapshot retry runs), and queries again; after each step the rows,
  each peer's residency and the retries agree;
- a peer that reads a block whose object another engine's merge has just
  deleted: exact rows or a surfaced error, as the JAX package decides.

Every socket wait and child process has a timeout of its own.
"""

import json
import os
import queue
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
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
SERVE_TIMEOUT = 30.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (bs, jpar, jremote), "port": (bt, tpar, tremote)}


def engine_config(pkg, **kw):
    if pkg is bt:
        kw.setdefault("device", "cpu")
        kw.setdefault("probe_backend", "device")
    else:
        kw.setdefault("mesh_devices", 1)  # not the conftest's 8 virtual CPU devices
    kw.setdefault("row_data_compression", "none")
    return pkg.BloomSearchEngineConfig(**kw)


def object_stores(pkg, client):
    return pkg.ObjectStoreMetaStore(client), pkg.ObjectStoreDataStore(client)


def rowset(rows) -> list[str]:
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


def on_both(case) -> dict:
    """``case(pkg, par, remote)`` on each package -> {name: result}; equal."""
    out = {name: case(*mods) for name, mods in PKGS.items()}
    assert out["port"] == out["jax"]
    return out


def drain(result_q: queue.Queue) -> list:
    rows = []
    while True:
        item = result_q.get(timeout=TIMEOUT)
        if item is None:
            return rows
        rows.append(item)


def written_store(pkg, batches, flush_each: bool = True):
    """An in-memory bucket written by ``pkg``'s engine -> (client, meta, data)."""
    client = pkg.InMemoryObjectStore()
    meta, data = object_stores(pkg, client)
    writer = pkg.BloomSearchEngine(engine_config(pkg), meta, data)
    writer.start()
    try:
        for rows in batches:
            writer.ingest_rows(rows, timeout=TIMEOUT)
            if flush_each:
                writer.flush(timeout=TIMEOUT)
    finally:
        writer.stop(timeout=TIMEOUT)
    return client, meta, data


def one_row_files(n: int) -> list[list[dict]]:
    return [[{"n": i, "tag": "common"}] for i in range(n)]


class Peers:
    """Engine peers behind QueryServers, announced in a registry."""

    def __init__(self, pkg, par, client, **config):
        self.pkg, self.par, self.client, self.config = pkg, par, client, config
        self.registry = par.PeerRegistry(client, ttl_seconds=60)
        self.running: list = []

    def add(self, peer_id: str, capacity: float = 1.0):
        engine = self.pkg.BloomSearchEngine(engine_config(self.pkg, **self.config),
                                            *object_stores(self.pkg, self.client))
        engine.start()
        server = self.par.QueryServer(engine)
        server.start()
        self.registry.announce(peer_id, *server.address, capacity=capacity)
        self.running.append((engine, server))
        return engine, server

    def stop(self) -> None:
        for engine, server in self.running:
            server.stop()
            engine.stop(timeout=TIMEOUT)


def fake_peer(serve_conn) -> socket.socket:
    """A listener whose every connection reads the request and then runs
    ``serve_conn(conn)`` (then closes it)."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)

    def loop():
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            try:
                conn.settimeout(TIMEOUT)
                tremote.recv_frame(conn)
                serve_conn(conn)
            except OSError:
                pass
            finally:
                conn.close()

    threading.Thread(target=loop, daemon=True).start()
    return lsock


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- TestPeerRegistry ------------------------------------------------------------


def test_announce_live_withdraw():
    reg = tpar.PeerRegistry(bt.InMemoryObjectStore(), ttl_seconds=30)
    reg.announce("p1", "127.0.0.1", 1234, capacity=2.0)
    reg.announce("p2", "127.0.0.1", 1235)
    peers = {p.peer_id: p for p in reg.live_peers()}
    assert set(peers) == {"p1", "p2"}
    assert peers["p1"].capacity == 2.0 and peers["p1"].port == 1234
    reg.withdraw("p1")
    assert {p.peer_id for p in reg.live_peers()} == {"p2"}


def test_stale_peers_age_out():
    reg = tpar.PeerRegistry(bt.InMemoryObjectStore(), ttl_seconds=0.05)
    reg.announce("p1", "h", 1)
    time.sleep(0.1)
    assert reg.live_peers() == []


def test_heartbeat_keeps_peer_alive_and_withdraws_on_stop():
    reg = tpar.PeerRegistry(bt.InMemoryObjectStore(), ttl_seconds=0.3)
    hb = reg.heartbeat("p1", "h", 1, interval=0.05)
    try:
        time.sleep(0.5)  # past the TTL: only the heartbeats keep it live
        assert {p.peer_id for p in reg.live_peers()} == {"p1"}
    finally:
        hb.stop()
    assert reg.live_peers() == []


def test_malformed_record_skipped():
    client = bt.InMemoryObjectStore()
    client.put("peers/bad", b"not json {")
    reg = tpar.PeerRegistry(client)
    reg.announce("good", "h", 2)
    assert {p.peer_id for p in reg.live_peers()} == {"good"}


def test_registry_records_read_across_packages():
    """A record one package announces on a shared bucket directory is the
    other's live peer."""
    import tempfile

    with tempfile.TemporaryDirectory() as bucket:
        tpar.PeerRegistry(bt.LocalDirObjectStore(bucket)).announce("p", "h", 7, capacity=3.0)
        (peer,) = jpar.PeerRegistry(bs.LocalDirObjectStore(bucket)).live_peers()
        assert (peer.peer_id, peer.host, peer.port, peer.capacity) == ("p", "h", 7, 3.0)


# -- TestCapacityAssignment --------------------------------------------------------


class MF:
    def __init__(self, pointer, size):
        self.pointer, self.size = pointer, size


def assign(files, *capacities):
    out = {}
    for name, par in (("port", tpar), ("jax", jpar)):
        peers = [par.PeerInfo(f"p{i}", "h", i, c, time.time()) for i, c in enumerate(capacities)]
        out[name] = par.assign_files_by_capacity(files, peers)
    assert out["port"] == out["jax"]
    return out["port"]


def test_every_file_assigned_exactly_once():
    files = [MF(f"f{i}".encode(), 100 + i) for i in range(20)]
    assigned = [p for s in assign(files, 1, 1, 1).values() for p in s]
    assert sorted(assigned) == sorted(mf.pointer for mf in files)
    assert len(assigned) == len(set(assigned))


def test_capacity_proportional_bytes():
    files = [MF(f"f{i}".encode(), 1000) for i in range(30)]
    assignment = assign(files, 2, 1)
    assert (len(assignment[0]), len(assignment[1])) == (20, 10)


def test_no_peers_raises():
    with pytest.raises(ValueError):
        tpar.assign_files_by_capacity([MF(b"f", 1)], [])


# -- TestFilePointerRestriction ----------------------------------------------------


def test_engine_query_restricted_to_subset(tmp_path):
    def case(pkg, par, _):
        store = pkg.FileSystemDataStore(str(tmp_path / pkg.__name__))
        engine = pkg.BloomSearchEngine(engine_config(pkg), store, store)
        engine.start()
        try:
            for i in range(3):
                engine.ingest_rows([{"n": i, "tag": "common"}], timeout=TIMEOUT)
                engine.flush(timeout=TIMEOUT)
            files = store.get_maybe_files_for_query(None)
            result_q = queue.Queue()
            engine.query(pkg.new_query().token("common").build(), result_q,
                         file_pointers={files[0].pointer, files[2].pointer})
            rows = drain(result_q)
            assert len(rows) == 2
            # A pointer the engine no longer lists errors; it never returns
            # the surviving subset silently.
            result_q, error_q = queue.Queue(), queue.Queue()
            engine.query(pkg.new_query().token("common").build(), result_q, error_q,
                         file_pointers={files[1].pointer, b"\x00" * len(files[1].pointer)})
            drain(result_q)
            assert isinstance(error_q.get_nowait(), pkg.StaleFileAssignmentError)
            return len(rows)
        finally:
            engine.stop(timeout=TIMEOUT)

    on_both(case)


# -- TestSharedStorageScatterGather -------------------------------------------------


def test_two_compute_peers_one_dataset():
    def case(pkg, par, _):
        client, meta, _ = written_store(pkg, one_row_files(6))
        peers = Peers(pkg, par, client)
        try:
            peers.add("a")
            peers.add("b")
            coord = par.CapacityScatterCoordinator(meta, peers.registry)
            rows = coord.query_sync(pkg.new_query().token("common").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in rows) == list(range(6))  # exact, no duplicates
            needle = coord.query_sync(
                pkg.new_query().token("common").field_token("n", "3").build(), timeout=TIMEOUT)
            assert [r["n"] for r in needle] == [3]
            return rowset(rows), rowset(needle)
        finally:
            peers.stop()

    on_both(case)


def test_dead_peer_files_reassigned_to_survivor():
    def case(pkg, par, _):
        client, meta, _ = written_store(pkg, one_row_files(6))
        peers = Peers(pkg, par, client)
        try:
            peers.add("alive")
            peers.registry.announce("dead", "127.0.0.1", free_port(), capacity=1.0)
            coord = par.CapacityScatterCoordinator(meta, peers.registry)
            rows = coord.query_sync(pkg.new_query().token("common").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in rows) == list(range(6))
            return rowset(rows)
        finally:
            peers.stop()

    on_both(case)


def test_stale_snapshot_restarts_query_from_fresh_listing():
    """A merge publishes between the coordinator's snapshot and the peers'
    listings: the whole query restarts from a fresh snapshot, exactly."""

    def case(pkg, par, _):
        client = pkg.InMemoryObjectStore()
        meta, data = object_stores(pkg, client)
        writer = pkg.BloomSearchEngine(engine_config(pkg), meta, data)
        writer.start()
        for rows in one_row_files(6):
            writer.ingest_rows(rows, timeout=TIMEOUT)
            writer.flush(timeout=TIMEOUT)
        stale_listing = meta.get_maybe_files_for_query(None)
        assert writer.merge().files_processed > 0
        writer.stop(timeout=TIMEOUT)
        fresh = {mf.pointer for mf in meta.get_maybe_files_for_query(None)}
        assert any(mf.pointer not in fresh for mf in stale_listing)

        class StaleOnceMeta:
            def __init__(self):
                self.calls = 0

            def get_maybe_files_for_query(self, prefilter):
                self.calls += 1
                return stale_listing if self.calls == 1 else meta.get_maybe_files_for_query(
                    prefilter)

        peers = Peers(pkg, par, client)
        try:
            peers.add("alive")
            stale_meta = StaleOnceMeta()
            coord = par.CapacityScatterCoordinator(stale_meta, peers.registry)
            rows = coord.query_sync(pkg.new_query().token("common").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in rows) == list(range(6))
            assert stale_meta.calls >= 2
            return rowset(rows), stale_meta.calls
        finally:
            peers.stop()

    on_both(case)


def scripted_coordinator(par, pkg, script, **kw):
    coord = par.CapacityScatterCoordinator(None, None, **kw)
    attempts = []

    def fake_attempt(q, rq, eq, sq=None):
        attempts.append(1)
        script(len(attempts), rq, eq, pkg.StaleFileAssignmentError)
        rq.put(None)

    coord._query_attempt = fake_attempt
    return coord, attempts


def test_stale_attempt_discarded_wholesale_before_retry():
    def script(attempt, rq, eq, stale):
        if attempt == 1:
            rq.put({"n": 99})  # a doomed attempt's partial rows
            eq.put(stale("stale"))
        else:
            for i in range(3):
                rq.put({"n": i})

    def case(pkg, par, _):
        coord, attempts = scripted_coordinator(par, pkg, script, failover_buffer_rows=100,
                                               stale_snapshot_retries=2)
        rq, eq = queue.Queue(), queue.Queue()
        coord.query(pkg.new_query().build(), rq, eq)
        rows = drain(rq)
        assert sorted(r["n"] for r in rows) == [0, 1, 2]
        assert eq.empty() and len(attempts) == 2
        return rowset(rows)

    on_both(case)


def test_stale_past_holdback_cap_surfaces_error_not_retry():
    def script(attempt, rq, eq, stale):
        for i in range(5):  # past the cap: stream-through
            rq.put({"n": i})
        eq.put(stale("stale"))

    def case(pkg, par, _):
        coord, attempts = scripted_coordinator(par, pkg, script, failover_buffer_rows=2,
                                               stale_snapshot_retries=3)
        rq, eq = queue.Queue(), queue.Queue()
        coord.query(pkg.new_query().build(), rq, eq)
        rows = drain(rq)
        assert sorted(r["n"] for r in rows) == [0, 1, 2, 3, 4]
        assert isinstance(eq.get_nowait(), pkg.StaleFileAssignmentError)
        assert len(attempts) == 1
        return rowset(rows)

    on_both(case)


def test_mid_stream_death_retries_exactly_once():
    """A peer streams one row and dies: its partial buffer is discarded and
    its subset re-runs on the survivor, no duplicate."""

    def die_after_one_row(conn):
        tremote.send_frame(conn, {"row": {"n": 0, "tag": "common"}})

    def case(pkg, par, _):
        client, meta, _ = written_store(pkg, one_row_files(6))
        lsock = fake_peer(die_after_one_row)
        peers = Peers(pkg, par, client)
        try:
            peers.add("alive")
            peers.registry.announce("flaky", "127.0.0.1", lsock.getsockname()[1], capacity=1.0)
            coord = par.CapacityScatterCoordinator(meta, peers.registry)
            rows = coord.query_sync(pkg.new_query().token("common").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in rows) == list(range(6))
            return rowset(rows)
        finally:
            lsock.close()
            peers.stop()

    on_both(case)


def test_terminal_failure_delivers_buffered_rows_with_error():
    def half_broken(conn):
        for i in range(3):
            tremote.send_frame(conn, {"row": {"n": i, "tag": "common"}})
        tremote.send_frame(conn, {"error": "block 7: CRC mismatch"})
        tremote.send_frame(conn, {"done": True})

    def case(pkg, par, _):
        client, meta, _ = written_store(pkg, one_row_files(1))
        lsock = fake_peer(half_broken)
        try:
            registry = par.PeerRegistry(client, ttl_seconds=60)
            registry.announce("half-broken", "127.0.0.1", lsock.getsockname()[1], capacity=1.0)
            coord = par.CapacityScatterCoordinator(meta, registry, max_retries=1)
            rq, eq = queue.Queue(), queue.Queue()
            coord.query(pkg.new_query().token("common").build(), rq, eq)
            rows = drain(rq)
            assert sorted(r["n"] for r in rows) == [0, 1, 2], rows
            assert not eq.empty(), "the per-block error must surface"
            return rowset(rows)
        finally:
            lsock.close()

    on_both(case)


def test_buffer_cap_switches_to_stream_through():
    def case(pkg, par, _):
        client, meta, _ = written_store(pkg, [[{"n": i, "tag": "common"} for i in range(50)]])
        peers = Peers(pkg, par, client)
        try:
            peers.add("alive")
            coord = par.CapacityScatterCoordinator(meta, peers.registry, failover_buffer_rows=3)
            rows = coord.query_sync(pkg.new_query().token("common").build(), timeout=TIMEOUT)
            assert sorted(r["n"] for r in rows) == list(range(50))
            return rowset(rows)
        finally:
            peers.stop()

    on_both(case)


def test_death_after_stream_through_surfaces_error_not_duplicates():
    def flaky(conn):
        for i in range(6):  # past the cap of 3, then die
            tremote.send_frame(conn, {"row": {"n": 100 + i, "tag": "common"}})

    def case(pkg, par, _):
        client, meta, _ = written_store(pkg, [[{"n": i, "tag": "common"} for i in range(8)]])
        lsock = fake_peer(flaky)
        try:
            registry = par.PeerRegistry(client, ttl_seconds=60)
            registry.announce("flaky", "127.0.0.1", lsock.getsockname()[1], capacity=1.0)
            coord = par.CapacityScatterCoordinator(meta, registry, failover_buffer_rows=3)
            rq, eq = queue.Queue(), queue.Queue()
            coord.query(pkg.new_query().token("common").build(), rq, eq)
            ns = [r["n"] for r in drain(rq)]
            assert not eq.empty(), "a death after the flush must surface an error"
            assert len(ns) == len(set(ns)), "rows duplicated after failover"
            return sorted(ns)
        finally:
            lsock.close()

    on_both(case)


def test_all_peers_dead_surfaces_error():
    client, meta, _ = written_store(bt, [[{"x": 1, "tag": "t"}]], flush_each=False)
    registry = tpar.PeerRegistry(client, ttl_seconds=60)
    registry.announce("dead", "127.0.0.1", free_port())
    coord = tpar.CapacityScatterCoordinator(meta, registry)
    with pytest.raises(ConnectionError):
        coord.query_sync(bt.new_query().token("t").build(), timeout=TIMEOUT)


def test_no_live_peers_reports_error():
    client, meta, _ = written_store(bt, [[{"x": 1}]], flush_each=False)
    coord = tpar.CapacityScatterCoordinator(meta, tpar.PeerRegistry(client))
    with pytest.raises(RuntimeError):
        coord.query_sync(None, timeout=TIMEOUT)


# -- the serve CLI (tests/test_serve.py) ------------------------------------------


def spawn_serve(pkg_name: str, args: list[str]) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    return subprocess.Popen([sys.executable, "-m", f"{pkg_name}.serve", *args], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def wait_for_port(proc: subprocess.Popen) -> tuple[str, int]:
    """The peer's ``serving queries on HOST:PORT`` line, read on a thread so
    that a silent child cannot hang the test past its timeout."""
    found: queue.Queue = queue.Queue()

    def read():
        for line in proc.stdout:
            if line.startswith("serving queries on "):
                found.put(line.strip().rsplit(" ", 1)[1])
                break
        for _ in proc.stdout:  # keep the pipe drained
            pass

    threading.Thread(target=read, daemon=True).start()
    try:
        host, port = found.get(timeout=SERVE_TIMEOUT).rsplit(":", 1)
    except queue.Empty:
        raise AssertionError("the server never announced its port") from None
    return host, int(port)


def stop_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=SERVE_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=SERVE_TIMEOUT)


def serve_args(pkg_name: str, *args) -> list[str]:
    extra = ["--device", "cpu", "--probe-backend", "device"] if pkg_name.endswith("torch") \
        else ["--probe-backend", "host"]
    return [*args, "--host", "127.0.0.1", *extra]


def test_serve_filesystem_dataset(tmp_path):
    data_dir = str(tmp_path / "data")
    store = bt.FileSystemDataStore(data_dir)
    writer = bt.BloomSearchEngine(engine_config(bt), store, store)
    writer.start()
    writer.ingest_rows([{"n": i, "tag": "served"} for i in range(5)], timeout=TIMEOUT)
    writer.stop(timeout=TIMEOUT)
    procs = {name: spawn_serve(name, serve_args(name, "--dir", data_dir))
             for name in ("bloomsearch_tpu_torch", "bloomsearch_tpu")}
    try:
        got = {}
        for name, proc in procs.items():
            peer = tpar.RemoteQueryPeer(*wait_for_port(proc))
            got[name] = rowset(peer.query_sync(bt.new_query().token("served").build(),
                                               timeout=TIMEOUT))
        assert got["bloomsearch_tpu_torch"] == got["bloomsearch_tpu"]
        assert sorted(json.loads(r)["n"] for r in got["bloomsearch_tpu_torch"]) == list(range(5))
    finally:
        stop_all(procs.values())


def test_serve_object_store_with_registry(tmp_path):
    bucket = str(tmp_path / "bucket")
    client = bt.LocalDirObjectStore(bucket)
    writer = bt.BloomSearchEngine(engine_config(bt), *object_stores(bt, client))
    writer.start()
    for i in range(4):
        writer.ingest_rows([{"n": i, "tag": "shared"}], timeout=TIMEOUT)
        writer.flush(timeout=TIMEOUT)
    writer.stop(timeout=TIMEOUT)
    procs = [spawn_serve("bloomsearch_tpu_torch", serve_args(
        "bloomsearch_tpu_torch", "--object-dir", bucket, "--registry", "--peer-id", pid,
        "--capacity", capacity, "--row-cache-mb", "16"))
        for pid, capacity in (("pa", "2"), ("pb", "1"))]
    try:
        for p in procs:
            wait_for_port(p)
        registry = tpar.PeerRegistry(client)
        deadline = time.monotonic() + SERVE_TIMEOUT
        while len(registry.live_peers()) < 2:
            assert time.monotonic() < deadline, "peers never registered"
            time.sleep(0.1)
        query = {name: pkg.new_query().token("shared").build() for name, (pkg, _, _) in
                 PKGS.items()}
        got = {
            "port": tpar.CapacityScatterCoordinator(bt.ObjectStoreMetaStore(client),
                                                    registry).query_sync(query["port"],
                                                                         timeout=TIMEOUT),
            # The JAX package's coordinator over the port's peers.
            "jax": jpar.CapacityScatterCoordinator(
                bs.ObjectStoreMetaStore(bs.LocalDirObjectStore(bucket)),
                jpar.PeerRegistry(bs.LocalDirObjectStore(bucket))).query_sync(
                    query["jax"], timeout=TIMEOUT),
        }
        assert rowset(got["port"]) == rowset(got["jax"])
        assert sorted(r["n"] for r in got["port"]) == [0, 1, 2, 3]
    finally:
        stop_all(procs)


# -- the card's serving configuration on the CPU: host-shadowed peers -------------

FILES = 6
PARTITIONS = 10
ROWS = 20
CAPACITIES = (("a", 2.0), ("b", 1.0))
MERGED = 2  # files the third engine merges


def base_rows(f: int, p: int, rng) -> list[dict]:
    rows = []
    for i in range(ROWS):
        row = {"uid": f"b{f:02x}{p:02x}{i:04x}", "part": f"p{p:02d}",
               "msg": f"w{(i * 7 + p) % 20} file{f}tok", "pad": rng.bytes(40).hex()}
        if i == 3 and f % 2 == 1:
            row["msg"] += " needletok"
        rows.append(row)
    return rows


def refscale_layout_config(pkg, **kw):
    kw.setdefault("probe_backend", "device")
    return engine_config(pkg, row_data_compression="snappy",
                         partition_func=lambda row: row["part"], max_row_group_rows=10_000,
                         block_bloom_expected_items=200, **kw)


def write_bucket(directory) -> None:
    """Files of 10 partitions, a block each, written by the JAX package into
    a LocalDirObjectStore bucket (so both packages read one format)."""
    client = bs.LocalDirObjectStore(str(directory))
    engine = bs.BloomSearchEngine(refscale_layout_config(bs, probe_backend="host"),
                                  *object_stores(bs, client))
    engine.start()
    rng = np.random.default_rng(0)
    try:
        for f in range(FILES):
            for p in range(PARTITIONS):
                engine.ingest_rows(base_rows(f, p, rng), timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def shadow_queries(m) -> dict:
    q = m.new_query
    return {
        "needle": q().token("needletok").build(),
        "file": q().token("file4tok").build(),
        "kept_part": q().match_prefilter(m.partition(m.partition_equals("p03")))
        .token("w3").build(),
        "uid": q().token("b0305000b").build(),
        "or_tree": q().match(m.or_(m.token("needletok"),
                                   m.and_(m.field("msg"), m.token("absentword0q")))).build(),
    }


def residency(engine) -> dict:
    backend = engine._device_backend
    with backend._lock:
        banks = sorted((sb.capacity, sb.used, sb.dead, len(sb.segments))
                       for sb in backend._superbanks.values())
    cache = engine._row_cache
    with cache._lock:
        stream = (cache._bucket.used, len(cache._blocks))
    return {"superbanks": banks, "stream": stream, "host_shadow": cache.host_shadow}


class MergeBetweenSnapshotAndPlan:
    """The coordinator's MetaStore: once ``armed``, its next listing takes
    the snapshot and then lets ``merge`` run before returning it, so the
    merge lands between the coordinator's snapshot and the peers' plans."""

    def __init__(self, meta, merge):
        self.meta, self.merge = meta, merge
        self.armed = False

    def get_maybe_files_for_query(self, prefilter):
        snapshot = self.meta.get_maybe_files_for_query(prefilter)
        if self.armed:
            self.armed = False
            self.merge()
        return snapshot


class ListingView:
    """A MetaStore that lists only ``pointers`` (for the merging engine, so
    it merges just those files) and publishes to the real one."""

    def __init__(self, meta, pointers):
        self.meta, self.pointers = meta, set(pointers)

    def get_maybe_files_for_query(self, prefilter):
        return [mf for mf in self.meta.get_maybe_files_for_query(prefilter)
                if mf.pointer in self.pointers]

    def update(self, writes, deletes):
        self.meta.update(writes, deletes)

    def acquire_merge_lease(self, *args, **kwargs):
        return self.meta.acquire_merge_lease(*args, **kwargs)


def settle(engine) -> None:
    """Wait for the background bank warms the engine's queries scheduled."""
    deadline = time.monotonic() + TIMEOUT
    while True:
        with engine._warm_lock:
            if not engine._warming:
                return
        assert time.monotonic() < deadline, "background bank warms did not finish"
        time.sleep(0.005)


def drive_shadow_peers(pkg, par, bucket) -> dict:
    """The sequence on one package's peers -> {step: (rows, residency of each
    peer, stale retries)}. Each query's background bank warms land before
    the next query, so both packages probe the same groups sparsely."""
    client = pkg.LocalDirObjectStore(str(bucket))
    meta = pkg.ObjectStoreMetaStore(client)
    peers = Peers(pkg, par, client, probe_backend="device", row_data_compression="snappy",
                  partition_func=lambda row: row["part"], max_row_group_rows=10_000,
                  block_bloom_expected_items=200, row_cache_bytes=64 << 20,
                  # Pins in the block tasks: a background pin queue drops
                  # past 8 pending pins, a count that depends on timing.
                  row_cache_async_pins=False)
    merged: dict = {}

    def merge():
        listing = sorted(meta.get_maybe_files_for_query(None), key=lambda mf: mf.pointer)
        view = ListingView(meta, [mf.pointer for mf in listing[:MERGED]])
        merger = pkg.BloomSearchEngine(refscale_layout_config(pkg), view,
                                       pkg.ObjectStoreDataStore(client))
        merger.start()
        try:
            merged["stats"] = merger.merge()
        finally:
            merger.stop(timeout=TIMEOUT)

    coord_meta = MergeBetweenSnapshotAndPlan(meta, merge)
    coord = par.CapacityScatterCoordinator(coord_meta, peers.registry)
    attempts = []
    attempt = coord._query_attempt

    def counted_attempt(*args, **kwargs):
        attempts.append(1)
        return attempt(*args, **kwargs)

    coord._query_attempt = counted_attempt
    steps = {}
    try:
        engines = [peers.add(pid, capacity)[0] for pid, capacity in CAPACITIES]

        def record(step: str) -> None:
            before = len(attempts)
            queries = shadow_queries(pkg)
            rows = {}
            for name, q in queries.items():
                rows[name] = rowset(coord.query_sync(q, timeout=TIMEOUT))
                for engine in engines:
                    settle(engine)
            steps[step] = (rows, [residency(e) for e in engines],
                           len(attempts) - before - len(queries))

        record("cold")
        record("warm")
        coord_meta.armed = True
        record("merge")
        assert merged["stats"].files_processed == MERGED
        record("after")
    finally:
        peers.stop()
    return steps


SHADOW_STEPS = ("cold", "warm", "merge", "after")


@pytest.fixture(scope="module", params=["resident", "sparse"])
def shadow_parity(request, tmp_path_factory):
    """Both packages' peers through the sequence. ``sparse``: every group
    is probed sparsely until its background warm lands, as the card's
    refscale groups are (``SPARSE_BANK_BYTES`` 0 in both engine modules);
    ``resident``: the test's small groups load on first use."""
    import bloomsearch_tpu.bloom.probe as jax_probe
    import bloomsearch_tpu.engine as jax_engine
    import bloomsearch_tpu_torch.bloom.probe as port_probe
    import bloomsearch_tpu_torch.engine as port_engine

    root = tmp_path_factory.mktemp(f"torch_shadow_peers_{request.param}")
    write_bucket(root / "base")
    out, sparse_probes = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for name, engine_mod, probe_mod in (("jax", jax_engine, jax_probe),
                                            ("port", port_engine, port_probe)):
            if request.param == "sparse":
                mp.setattr(engine_mod, "SPARSE_BANK_BYTES", 0)
            sparse_probes[name] = 0

            def counted(*args, _name=name, _fn=probe_mod.probe_rows_sparse, **kwargs):
                sparse_probes[_name] += 1
                return _fn(*args, **kwargs)

            mp.setattr(probe_mod, "probe_rows_sparse", counted)
        for name, (pkg, par, _) in PKGS.items():
            shutil.copytree(root / "base", root / name)
            out[name] = drive_shadow_peers(pkg, par, root / name)
    assert sparse_probes["port"] == sparse_probes["jax"]
    assert (sparse_probes["port"] > 0) is (request.param == "sparse")
    return out


@pytest.mark.parametrize("step", SHADOW_STEPS)
def test_shadow_peers_rows_agree(shadow_parity, step):
    rows = {name: steps[step][0] for name, steps in shadow_parity.items()}
    assert rows["port"] == rows["jax"]
    got = {q: len(r) for q, r in rows["port"].items()}
    assert got["needle"] == (FILES // 2) * PARTITIONS
    assert got["file"] == PARTITIONS * ROWS
    assert got["uid"] == 1 and got["kept_part"] > 0


@pytest.mark.parametrize("step", SHADOW_STEPS)
def test_shadow_peers_residency_agrees(shadow_parity, step):
    """Each port peer's superbank capacity, used, dead and groups, stream
    chunks and pinned blocks, and host shadow equal its JAX counterpart's."""
    port, jax = (shadow_parity[name][step][1] for name in ("port", "jax"))
    assert port == jax
    assert all(peer["host_shadow"] is True for peer in port)
    assert all(peer["stream"][1] > 0 for peer in port)


@pytest.mark.parametrize("step", SHADOW_STEPS)
def test_shadow_peers_stale_retries_agree(shadow_parity, step):
    retries = {name: steps[step][2] for name, steps in shadow_parity.items()}
    assert retries["port"] == retries["jax"] == (1 if step == "merge" else 0)


# -- a block whose object another engine's merge has just deleted -----------------


def deleted_object_outcome(pkg, bucket, pinned: bool):
    """A peer on the bucket plans a query over every file, and between its
    plan and its block reads a third engine merges (and deletes) two files'
    objects -> (rows, error kinds); the expected rows for comparison."""
    client = pkg.LocalDirObjectStore(str(bucket))
    meta, data = object_stores(pkg, client)
    peer = pkg.BloomSearchEngine(
        refscale_layout_config(pkg, row_cache_bytes=64 << 20 if pinned else 0,
                               row_cache_async_pins=False), meta, data)
    peer.start()
    # One row in each file's p03 block: the merged files' blocks survive.
    query = pkg.new_query().match_prefilter(pkg.partition(pkg.partition_equals("p03"))) \
        .token("w3").build()
    try:
        want = rowset(peer.query_sync(query, timeout=TIMEOUT))  # pins, when serving
        plan = peer._plan_query_jobs

        def plan_then_merge(*args, **kwargs):
            jobs = plan(*args, **kwargs)
            listing = sorted(meta.get_maybe_files_for_query(None), key=lambda mf: mf.pointer)
            view = ListingView(meta, [mf.pointer for mf in listing[:MERGED]])
            merger = pkg.BloomSearchEngine(refscale_layout_config(pkg), view,
                                           pkg.ObjectStoreDataStore(client))
            merger.start()
            try:
                assert merger.merge().files_processed == MERGED
            finally:
                merger.stop(timeout=TIMEOUT)
            return jobs

        peer._plan_query_jobs = plan_then_merge
        result_q, error_q = queue.Queue(), queue.Queue()
        peer.query(query, result_q, error_q)
        rows = rowset(drain(result_q))
        errors = sorted({type(error_q.get_nowait()).__name__ for _ in range(error_q.qsize())})
        peer._plan_query_jobs = plan
        after = rowset(peer.query_sync(query, timeout=TIMEOUT))
    finally:
        peer.stop(timeout=TIMEOUT)
    return rows, errors, want, after


@pytest.mark.parametrize("pinned", [False, True], ids=["cold", "pinned"])
def test_deleted_object_gives_exact_rows_or_an_error(tmp_path, pinned):
    """Never silently wrong rows: a block read of the deleted object surfaces
    an error beside the other blocks' rows; a block pinned with its host
    shadow still answers from the card. The JAX package decides which."""
    write_bucket(tmp_path / "base")
    out = {}
    for name, (pkg, _, _) in PKGS.items():
        shutil.copytree(tmp_path / "base", tmp_path / name)
        out[name] = deleted_object_outcome(pkg, tmp_path / name, pinned)
    assert out["port"] == out["jax"]
    rows, errors, want, after = out["port"]
    assert len(want) == FILES and after == want
    if errors:
        assert set(rows) < set(want)
    else:
        assert rows == want
    assert bool(errors) is not pinned

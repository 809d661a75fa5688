"""The port's scale-out layer against the JAX package's, on the same inputs.

Object stores (local directory, fake S3 over HTTP), merge leases, the TCP
query protocol, peer discovery and capacity assignment, the ``serve`` CLI
and the entry points (`graft_entry.py`). The port's modules are host copies of the JAX
package's, so the two packages interoperate: data one writes the other
reads, a lease one holds the other cannot take, and a server of one answers
a client of the other with the same rows, stats and typed errors.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu.parallel as jpar  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
import bloomsearch_tpu_torch.parallel as tpar  # noqa: E402
from bloomsearch_tpu.coordination import FileLeaseCoordinator as JaxLeases  # noqa: E402
from bloomsearch_tpu_torch import graft_entry  # noqa: E402
from bloomsearch_tpu_torch.coordination import FileLeaseCoordinator as PortLeases  # noqa: E402

from s3fake import start_fake_s3  # noqa: E402

TIMEOUT = 20.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (bs, jpar), "port": (bt, tpar)}


def rows_for(f: int) -> list[dict]:
    return [{"n": f * 10 + i, "site": f"s{f}", "msg": f"tok{f}_{i} common"} for i in range(10)]


def engine_config(pkg, **kw):
    if pkg is bt:
        kw.setdefault("device", "cpu")
    return pkg.BloomSearchEngineConfig(row_data_compression="none", **kw)


def write(pkg, meta, data, files=3) -> None:
    engine = pkg.BloomSearchEngine(engine_config(pkg), meta, data)
    engine.start()
    try:
        for f in range(files):
            engine.ingest_rows(rows_for(f), timeout=TIMEOUT)
            engine.flush(timeout=TIMEOUT)
    finally:
        engine.stop(timeout=TIMEOUT)


def query_all(pkg, meta, data) -> dict:
    engine = pkg.BloomSearchEngine(engine_config(pkg, probe_backend="device"), meta, data)
    engine.start()
    try:
        return {
            name: sorted(json.dumps(r, sort_keys=True) for r in engine.query_sync(q, timeout=TIMEOUT))
            for name, q in (
                ("needle", pkg.new_query().token("tok1_3").build()),
                ("site", pkg.new_query().field_token("site", "s2").build()),
                ("all", None),
            )
        }
    finally:
        engine.stop(timeout=TIMEOUT)


def object_stores(pkg, client):
    return pkg.ObjectStoreMetaStore(client), pkg.ObjectStoreDataStore(client)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_object_store_dataset_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    bucket = str(tmp_path / "bucket")
    wpkg = PKGS[writer][0]
    write(wpkg, *object_stores(wpkg, wpkg.LocalDirObjectStore(bucket)))
    results = {
        name: query_all(pkg, *object_stores(pkg, pkg.LocalDirObjectStore(bucket)))
        for name, (pkg, _) in PKGS.items()
    }
    assert results["port"] == results["jax"]
    assert len(results["port"]["all"]) == 30 and len(results["port"]["needle"]) == 1


@pytest.mark.parametrize("holder", ["jax", "port"])
def test_merge_lease_is_exclusive_across_packages(tmp_path, holder):
    bucket = str(tmp_path / "bucket")
    metas = {name: pkg.ObjectStoreMetaStore(pkg.LocalDirObjectStore(bucket))
             for name, (pkg, _) in PKGS.items()}
    other = "port" if holder == "jax" else "jax"
    lease = metas[holder].acquire_merge_lease()
    assert lease is not None and lease.valid()
    assert metas[other].acquire_merge_lease() is None
    lease.release()
    second = metas[other].acquire_merge_lease()
    assert second is not None
    assert metas[holder].acquire_merge_lease() is None
    second.release()


def test_file_lease_semantics_match(tmp_path):
    """The same sequence on each package's FileLeaseCoordinator, and one
    package's lease seen by the other's on the same directory."""
    trace = {}
    for name, cls in (("jax", JaxLeases), ("port", PortLeases)):
        coord = cls(str(tmp_path / name))
        steps = []
        stale = coord.acquire_merge_lease(ttl_seconds=0.05)
        steps.append(stale is not None and coord.acquire_merge_lease() is None)
        time.sleep(0.1)
        fresh = coord.acquire_merge_lease()
        steps.append(fresh is not None)
        stale.release()  # must not clobber the fresh lease
        steps.append(coord.acquire_merge_lease() is None)
        fresh.release()
        with coord.acquire_merge_lease() as lease:
            steps.append(lease.valid() and coord.acquire_merge_lease() is None)
        steps.append(coord.acquire_merge_lease() is not None)
        trace[name] = steps
    assert trace["port"] == trace["jax"] == [True] * 5
    shared = str(tmp_path / "shared")
    lease = PortLeases(shared).acquire_merge_lease()
    assert JaxLeases(shared).acquire_merge_lease() is None
    lease.release()
    assert JaxLeases(shared).acquire_merge_lease() is not None


def test_s3_object_store_matches_reference():
    """Each package writes through its own S3ObjectStore to a fake S3
    server (SigV4-verified, over HTTP) and both read it back: the same
    manifest and rows whoever wrote."""
    results, manifests = {}, {}
    for writer, (wpkg, _) in PKGS.items():
        state, server, endpoint = start_fake_s3()
        try:
            def client(pkg):
                return pkg.S3ObjectStore(
                    state.bucket, endpoint=endpoint, scheme="http",
                    access_key=state.access_key, secret_key=state.secret_key,
                    region="us-east-1",
                )

            write(wpkg, *object_stores(wpkg, client(wpkg)))
            readers = {}
            for name, (pkg, _) in PKGS.items():
                meta, data = object_stores(pkg, client(pkg))
                manifests[(writer, name)] = sorted(
                    (len(f.metadata.data_blocks), f.metadata.data_blocks[0].rows)
                    for f in meta.get_maybe_files_for_query(None)
                )
                readers[name] = query_all(pkg, meta, data)
            assert readers["port"] == readers["jax"]
            results[writer] = readers["port"]
        finally:
            server.shutdown()
            server.server_close()
    assert results["port"] == results["jax"]
    assert len(set(map(tuple, manifests.values()))) == 1
    assert manifests[("port", "port")] == [(1, 10)] * 3


def local_engine(pkg, directory, rows):
    store = pkg.FileSystemDataStore(str(directory))
    engine = pkg.BloomSearchEngine(engine_config(pkg), store, store)
    engine.start()
    engine.ingest_rows(rows, timeout=TIMEOUT)
    engine.flush(timeout=TIMEOUT)
    return engine


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_query_server_answers_the_other_packages_peer(tmp_path, server_pkg):
    spkg, spar = PKGS[server_pkg]
    cpkg, cpar = PKGS["port" if server_pkg == "jax" else "jax"]
    engine = local_engine(spkg, tmp_path / "data", rows_for(0) + rows_for(1))
    try:
        with spar.QueryServer(engine) as server:
            peer = cpar.RemoteQueryPeer(*server.address)
            q = cpkg.new_query().token("tok1_3").build()
            assert peer.query_sync(q, timeout=TIMEOUT) == engine.query_sync(
                spkg.new_query().token("tok1_3").build(), timeout=TIMEOUT
            )
            assert len(peer.query_sync(None, timeout=TIMEOUT)) == 20
            # Stats arrive as the client package's BlockStats.
            result_q, stats_q = queue.Queue(), queue.Queue()
            peer.query(cpkg.new_query().token("common").build(), result_q, None, stats_q)
            while result_q.get(timeout=TIMEOUT) is not None:
                pass
            stats = [stats_q.get_nowait() for _ in range(stats_q.qsize())]
            assert stats and all(isinstance(s, cpkg.BlockStats) for s in stats)
            assert sum(s.rows_processed for s in stats) == 20
            # A stale assignment stays typed across the wire.
            result_q, error_q = queue.Queue(), queue.Queue()
            peer.query(cpkg.new_query().token("x").build(), result_q, error_q,
                       file_pointers={b"\x00" * 8})
            while result_q.get(timeout=TIMEOUT) is not None:
                pass
            assert isinstance(error_q.get_nowait(), cpkg.StaleFileAssignmentError)
    finally:
        engine.stop(timeout=TIMEOUT)


def test_capacity_assignment_matches_reference():
    class MF:
        def __init__(self, pointer, size):
            self.pointer, self.size = pointer, size

    rng = np.random.default_rng(3)
    files = [MF(f"f{i}".encode(), int(rng.integers(1, 10_000))) for i in range(40)]
    for capacities in ((1, 1, 1), (2, 1), (3.5, 1, 0.5, 2)):
        got, want = (
            par.assign_files_by_capacity(files, [
                par.PeerInfo(f"p{i}", "h", i, c, 0.0) for i, c in enumerate(capacities)
            ])
            for par in (tpar, jpar)
        )
        assert got == want


def test_capacity_scatter_over_two_port_peers_equals_reference():
    results = {}
    for name, (pkg, par) in PKGS.items():
        client = pkg.InMemoryObjectStore()
        meta, data = object_stores(pkg, client)
        write(pkg, meta, data, files=4)
        registry = par.PeerRegistry(client, ttl_seconds=60)
        peers = []
        try:
            for pid, capacity in (("a", 2.0), ("b", 1.0)):
                engine = pkg.BloomSearchEngine(engine_config(pkg), *object_stores(pkg, client))
                engine.start()
                server = par.QueryServer(engine)
                server.start()
                registry.announce(pid, *server.address, capacity=capacity)
                peers.append((engine, server))
            coord = par.CapacityScatterCoordinator(meta, registry)
            results[name] = [
                sorted(json.dumps(r, sort_keys=True) for r in coord.query_sync(q, timeout=TIMEOUT))
                for q in (pkg.new_query().token("common").build(),
                          pkg.new_query().token("tok2_4").build())
            ]
        finally:
            for engine, server in peers:
                server.stop()
                engine.stop(timeout=TIMEOUT)
    assert results["port"] == results["jax"]
    assert len(results["port"][0]) == 40 and len(results["port"][1]) == 1


def spawn_serve(args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}, **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "bloomsearch_tpu_torch.serve", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )


def test_serve_cli_on_the_cpu_answers_a_query(tmp_path):
    data_dir = str(tmp_path / "data")
    local_engine(bt, data_dir, rows_for(0)).stop(timeout=TIMEOUT)
    proc = spawn_serve(["--dir", data_dir, "--host", "127.0.0.1", "--device", "cpu",
                        "--probe-backend", "device"])
    try:
        t0 = time.monotonic()
        for line in proc.stdout:
            if line.startswith("serving queries on "):
                host, port = line.strip().rsplit(" ", 1)[1].rsplit(":", 1)
                break
            assert time.monotonic() - t0 < 60, "server never announced its port"
        else:
            raise AssertionError("server exited before announcing its port")
        for par, pkg in ((tpar, bt), (jpar, bs)):
            rows = par.RemoteQueryPeer(host, int(port)).query_sync(
                pkg.new_query().token("tok0_4").build(), timeout=TIMEOUT
            )
            assert rows == [rows_for(0)[4]]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=TIMEOUT)


def test_graft_entry_dryrun_on_a_4_shard_cpu_mesh():
    graft_entry.dryrun_multichip(4, device="cpu")


def test_graft_entry_forward_matches_reference():
    import jax

    import __graft_entry__ as ref_entry

    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    ref_fn, ref_args = ref_entry.entry()
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert got.shape == (4, 32)

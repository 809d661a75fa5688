"""The sharded wrappers (K3) on the card, against per-shard single-device
launches joined by hand and numpy oracles. No JAX: this file runs where
the JAX package cannot.

Every case is exact: the joined bitmap a wrapper returns is bit-identical
to the single-device kernel's words of each shard put side by side, and to
a numpy oracle of the probe (the bank's bits) or of the scan (a byte search
of each chunk's 480 payload starts). The meshes: 4 shards on one card (one
launch), 10 shards on one card (more than one launch's table holds: 2 probe
launches of at most 8 shards, 3 scan launches of at most 4), and one shard
on each of up to 4 distinct cards where two or more are visible. The
kernel modules' counters must show one launch per card (per table) for
each sharded call. Every test is marked ``cuda`` and skips without a card.
On a machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_card.py

(``--noconftest``: the suite's conftest imports JAX to pin its platform.)
"""

import threading

import numpy as np
import pytest
import torch

from bloomsearch_tpu_torch.kernels import probe as pk
from bloomsearch_tpu_torch.kernels import scan as ks
from bloomsearch_tpu_torch.parallel import mesh as pm

pytestmark = pytest.mark.cuda

T, K = 5, 7
ROWS = 300
CLAUSE_BITS = [0b00101, 0b10010, 0b01000]
MEMBER_BITS = [0b011, 0b101]
MESHES = ["4 shards on one card", "10 shards on one card", "distinct cards"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU form")
    return torch.device("cuda", 0)


def mesh_of(kind: str, dev) -> pm.Mesh:
    if kind == "distinct cards":
        n = min(torch.cuda.device_count(), 4)
        if n < 2:
            pytest.skip("needs two or more cards")
        return pm.Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return pm.Mesh((dev,) * (4 if kind.startswith("4") else 10))


def launches_per_call(mesh: pm.Mesh, capacity: int) -> int:
    """Launches the layout makes: one a card, or more where a card holds
    more shards than one launch's table."""
    return sum(-(-mesh.devices.count(d) // capacity) for d in mesh.distinct_devices())


def probe_case(n: int, seed: int):
    """uint32[ROWS, 128n - 9] bank (top bits set), T*K probes with shift 31
    among them, and columns where a term's every probe is set."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 2**32, size=(ROWS, 128 * n - 9), dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, ROWS, size=T * K).astype(np.int32)
    shifts = rng.integers(0, 32, size=T * K).astype(np.int32)
    shifts[::3] = 31
    for t in range(T):
        cols = rng.random(bank.shape[1]) < 0.5
        for j in range(K):
            p = t * K + j
            bank[rows[p], cols] |= np.uint32(1) << np.uint32(shifts[p])
    return bank, rows, shifts


def oracle_words(bank, rows, shifts, C: int, epilogue: str) -> np.ndarray:
    """The packed uint32 words of ``epilogue`` over the bank padded to C."""
    bank = np.pad(bank, ((0, 0), (0, C - bank.shape[1])))
    match = np.ones((T, C), dtype=bool)
    for p in range(T * K):
        match[p // K] &= ((bank[rows[p]] >> np.uint32(shifts[p])) & 1).astype(bool)
    if epilogue == "sharded_query_step":
        match = match.all(axis=0, keepdims=True)
    elif epilogue == "sharded_probe_clauses":
        clause = np.array([[(b >> t) & 1 for t in range(T)] for b in CLAUSE_BITS], bool)
        fails = ~(clause[:, :, None] & match[None]).any(axis=1)  # [clauses, C]
        member = np.array([[(b >> i) & 1 for i in range(len(CLAUSE_BITS))]
                           for b in MEMBER_BITS], bool)
        match = ~(member[:, :, None] & fails[None]).any(axis=1)
    return np.packbits(match, axis=1, bitorder="little").view(np.uint32)


def call(name: str, mesh, bank2d, rows, shifts):
    if name == "sharded_probe_packed":
        return pm.sharded_probe_packed(mesh, bank2d, rows, shifts, T, K)
    if name == "sharded_query_step":
        return pm.sharded_query_step(mesh, bank2d, rows, shifts, (1 << T) - 1, T, K)
    return pm.sharded_probe_clauses(mesh, bank2d, rows, shifts, CLAUSE_BITS, MEMBER_BITS, T, K)


def single(name: str, shard, rows, shifts) -> torch.Tensor:
    """The single-device kernel on one shard -> its words on the host."""
    if name == "sharded_probe_packed":
        out = pk.probe_and_pack(shard, rows, shifts, T, K)
    elif name == "sharded_query_step":
        out = pk.probe_reduce_and_pack(shard, rows, shifts, T, K, (1 << T) - 1)
    else:
        out = pk.probe_clauses_pack(shard, rows, shifts, T, K, CLAUSE_BITS, MEMBER_BITS)
    return out.cpu()


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("name", ["sharded_probe_packed", "sharded_query_step",
                                  "sharded_probe_clauses"])
def test_sharded_probe_matches_shards_joined_by_hand(dev, kind, name):
    mesh = mesh_of(kind, dev)
    bank, rows, shifts = probe_case(mesh.size, seed=mesh.size)
    bank2d = pm.shard_bank(mesh, bank)
    assert tuple(s.device for s in bank2d) == mesh.devices
    pk.reset_launch_counts()
    pm.reset_launch_counts()
    got = call(name, mesh, bank2d, rows, shifts)
    counter = {"sharded_probe_packed": "pack", "sharded_query_step": "reduce_and"}.get(
        name, "clauses")
    assert pk.launch_counts()[counter] == launches_per_call(mesh, pk.MAX_SHARDS)
    assert pm.launch_counts()[name] == 1
    if name == "sharded_query_step":
        got, total = got
        got = got[None, :]
    assert got.device.type == "cpu" and got.is_pinned()
    by_hand = torch.cat([single(name, s, rows, shifts) for s in bank2d], dim=1)
    if name == "sharded_query_step":
        by_hand = by_hand[:1]
    assert torch.equal(got, by_hand)
    want = oracle_words(bank, rows, shifts, 128 * mesh.size, name)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    bits = np.unpackbits(want.view(np.uint8))
    assert bits.any() and not bits.all()
    if name == "sharded_query_step":
        assert total == int(bits.sum())


def scan_case(n: int, shard_chunks: int, seed: int):
    """Random chunks (bytes >= 0x80 included) with each needle planted at
    bytes 479 (a hit) and 480 (not one: the next chunk's payload) of the
    chunks on each side of every shard boundary."""
    rng = np.random.default_rng(seed)
    G = n * shard_chunks
    chunks = rng.integers(0, 256, size=(G, ks.CHUNK_BYTES), dtype=np.uint8)
    needles = [b"\xc3\xa9t\xe9", b"bound", bytes(range(0x61, 0x61 + 32))]
    for r, nd in enumerate(needles):
        arr = np.frombuffer(nd, np.uint8)
        for boundary in range(shard_chunks, G, shard_chunks):
            for g, start in ((boundary - 1 - r, 479), (boundary + r, 479),
                             (boundary - 5 - r, 480), (boundary + 5 + r, 480)):
                chunks[g, start : start + len(arr)] = arr
    padded = np.zeros((4, ks.MAX_SCAN_WINDOW), np.int32)
    lens = np.zeros(4, np.int32)  # the fourth row: length 0, matches every chunk
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    return chunks, needles + [b""], padded, lens


def scan_oracle(chunks: np.ndarray, needles) -> np.ndarray:
    """uint32 words: needle n at some start < 480 of chunk g."""
    hits = np.array([[bytes(c[: 479 + len(nd)]).find(nd) >= 0 for c in chunks]
                     for nd in needles])
    return np.packbits(hits, axis=1, bitorder="little").view(np.uint32)


@pytest.mark.parametrize("kind", MESHES)
def test_sharded_scan_matches_shards_joined_by_hand(dev, kind):
    mesh = mesh_of(kind, dev)
    shard_chunks = 1024
    chunks, needles, padded, lens = scan_case(mesh.size, shard_chunks, seed=mesh.size)
    G = chunks.shape[0]
    stream = pm.sharded_update_rows(
        mesh, pm.sharded_zeros_rows(mesh, G, device=dev), chunks.view(np.int32), 0)
    assert tuple(s.device for s in stream) == mesh.devices
    ks.reset_launch_counts()
    pm.reset_launch_counts()
    got = pm.sharded_scan_all_rows(mesh, stream, padded, lens, n_real=4)
    assert ks.launch_counts() == {"stream": launches_per_call(mesh, ks.MAX_SEGMENTS),
                                  "segments": 0}
    assert pm.launch_counts()["sharded_scan_all_rows"] == 1
    assert got.shape == (4, G // 32) and got.is_pinned()
    by_hand = torch.cat([ks.byte_scan_stream(s, padded, lens, n_real=4).cpu()
                         for s in stream], dim=1)
    assert torch.equal(got, by_hand)
    want = scan_oracle(chunks, needles)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    bits = pm.unpack_bitmap(want, G)
    for r in range(3):
        for boundary in range(shard_chunks, G, shard_chunks):
            assert bits[r, boundary - 1 - r] and bits[r, boundary + r], (r, boundary)
    assert bits[3].all()


def test_pageable_output_is_refused(dev):
    """The kernels write a host output only through its device address:
    memory that is not page-locked raises before anything is launched."""
    bank = torch.zeros((ROWS, 128), dtype=torch.int32, device=dev)
    rows = np.zeros(T * K, np.int32)
    pageable = torch.zeros((T, 4), dtype=torch.int32)
    pk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError"):
        pk.probe_plan_into(pageable, [(0, [bank])], rows, rows, T, K, "pack")
    stream = torch.zeros((64, 128), dtype=torch.int32, device=dev)
    needle = np.zeros((1, ks.MAX_SCAN_WINDOW), np.int32)
    with pytest.raises(RuntimeError, match="cudaError"):
        ks.byte_scan_plan_into(torch.zeros((1, 2), dtype=torch.int32), [(0, [(stream, 0, 64)])],
                               needle, np.ones(1, np.int32), n_real=1)
    assert sum(pk.launch_counts().values()) == 0
    # The same outputs page-locked: the launches run and write every word.
    pinned = torch.full((T, 4), -7, dtype=torch.int32).pin_memory()
    pk.probe_plan_into(pinned, [(0, [bank])], rows, rows, T, K, "pack")
    assert not pinned.any()  # an all-zero bank matches nowhere


def test_wide_output_keeps_other_words(dev):
    """A launch stores only its own run of words: the words before
    ``first_word`` and after its run keep what they held."""
    rng = np.random.default_rng(3)
    banks = [torch.from_numpy(rng.integers(-(2**31), 2**31, size=(ROWS, 64),
                                           dtype=np.int64).astype(np.int32)).to(dev)
             for _ in range(3)]
    rows = rng.integers(0, ROWS, size=T * K).astype(np.int32)
    shifts = rng.integers(0, 32, size=T * K).astype(np.int32)
    for host in (False, True):
        out = torch.full((T, 11), 0x5A5A5A5A, dtype=torch.int32)
        out = out.pin_memory() if host else out.to(dev)
        pk.probe_plan_into(out, [(2, banks)], rows, shifts, T, K, "pack")
        out = out.cpu()
        want = torch.cat([pk.probe_and_pack(b, rows, shifts, T, K).cpu() for b in banks], dim=1)
        assert torch.equal(out[:, 2:8], want)
        assert (out[:, :2] == 0x5A5A5A5A).all() and (out[:, 8:] == 0x5A5A5A5A).all()


@pytest.mark.parametrize("name", ["sharded_query_step", "sharded_scan_all_rows"])
def test_a_fresh_thread_launches_into_the_joined_bitmap(dev, name):
    """The engine calls the wrappers from its worker threads. A thread that
    has made no CUDA call yet has no current context, and a page-locked
    buffer then has no device address until the launch makes the card's
    context current: the call must work there as on the main thread."""
    mesh = mesh_of("4 shards on one card", dev)
    bank, rows, shifts = probe_case(mesh.size, seed=9)
    bank2d = pm.shard_bank(mesh, bank)
    chunks, _, padded, lens = scan_case(mesh.size, 512, seed=9)
    stream = pm.sharded_update_rows(
        mesh, pm.sharded_zeros_rows(mesh, chunks.shape[0], device=dev), chunks.view(np.int32), 0)

    def run():
        if name == "sharded_query_step":
            return pm.sharded_query_step(mesh, bank2d, rows, shifts, (1 << T) - 1, T, K)[0]
        return pm.sharded_scan_all_rows(mesh, stream, padded, lens, n_real=4)

    want = run()
    got: list = []
    worker = threading.Thread(target=lambda: got.append(run()))
    worker.start()
    worker.join()
    assert len(got) == 1 and torch.equal(got[0], want)

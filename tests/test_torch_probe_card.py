"""K1 (its three epilogues) and K1f on the card, against their plain
PyTorch versions and a numpy oracle. No JAX: this file runs where the JAX
package cannot.

Every case is exact: the kernel's packed words (K1f's unpacked words) are
bit-identical to the plain version's and to the oracle's. The cases cover
term counts that are not powers of two, K up to 30, shift 31 on words whose
top bit is set, rows outside [0, R) (they read 0), C from 32 to 32,768, both
parameter capacities of the kernel (T*K up to ``MAX_PROBES``), probe
arrays given as numpy arrays and as CPU tensors, and launches captured in a
CUDA graph, each with its own probes. The plan entry (``probe_plan_into``,
``csrc/probe.cu``'s ``bs_probe_plan``, the K3 wrappers' and the
single-device combiner's one call) is held against single launches and
the plain version at the refscale main-path shapes, on one card and on
distinct cards, from two threads at once and from a fresh thread; it
keeps the caller's device, refuses pageable memory, waits for the cards it
reached after a failure part-way, and its record size is checked at bind.
Every test is marked ``cuda`` and skips without a card. On a machine with
one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_probe_card.py

(``--noconftest``: the suite's conftest imports JAX to pin its platform.)
"""

import ctypes
import threading

import numpy as np
import pytest
import torch

from bloomsearch_tpu_torch.kernels import probe as tk
from bloomsearch_tpu_torch.parallel import mesh as pm

pytestmark = pytest.mark.cuda

# (seed, R, C, T, K): C from 32 to 32,768; T = 1..32, mostly not powers of
# two; K up to 30; the last two (T*K over 256) take the larger capacity.
CASES = [
    (0, 40, 32, 1, 1),
    (1, 64, 96, 3, 7),
    (2, 1_000, 256, 5, 10),
    (3, 300, 4_096, 12, 20),
    (4, 200, 32_768, 7, 30),
    (5, 13_480, 32_768, 4, 10),
    (6, 500, 128, 32, 3),
    (7, 128, 224, 16, 40),
    (8, 96, 64, 32, 200),
]
OUTSIDE = [-1, -(2**31), 2**31 - 1]  # plus R and R + 5: rows that read 0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    return torch.device("cuda")


def make_case(seed: int, R: int, C: int, T: int, K: int):
    """uint32[R, C] bank (top bit set on half the words), T*K probes with
    shift 31 among them and some rows outside the bank, and planted
    columns where every probe of a term is set, so terms match somewhere."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 2**32, size=(R, C), dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, R, size=T * K).astype(np.int32)
    shifts = rng.integers(0, 32, size=T * K).astype(np.int32)
    shifts[::4] = 31
    for t in range(T):
        cols = rng.random(C) < 0.5
        for j in range(K):
            p = t * K + j
            bank[rows[p], cols] |= np.uint32(1) << np.uint32(shifts[p])
    # One term in three (the second, fifth, ...) gets a row outside the
    # bank: it can never match.
    for t in range(1, T, 3):
        p = t * K + int(rng.integers(0, K))
        rows[p] = (OUTSIDE + [R, R + 5])[t % 5]
    if C > 32:
        bank[:, C - 32:] = 0  # dead columns never match
    return bank, rows, shifts


def oracle_match(bank, rows, shifts, T, K) -> np.ndarray:
    R, C = bank.shape
    match = np.ones((T, C), dtype=bool)
    for p in range(T * K):
        r = int(rows[p])
        word = bank[r] if 0 <= r < R else np.zeros(C, np.uint32)
        match[p // K] &= ((word >> np.uint32(shifts[p] & 31)) & 1).astype(bool)
    return match


def oracle_floor(bank, rows, T, K) -> np.ndarray:
    R, C = bank.shape
    out = np.zeros((T, C), dtype=np.uint32)
    for p in range(T * K):
        r = int(rows[p])
        if 0 <= r < R:
            out[p // K] |= bank[r & ~7]
    return out


def pack(match: np.ndarray) -> np.ndarray:
    """bool[rows, C] -> uint32[rows, C/32], bit i of word w = column 32w+i."""
    return np.packbits(match, axis=1, bitorder="little").view(np.uint32)


def epilogues(T: int, seed: int):
    """(name, extra args, oracle of a match matrix) for the three modes:
    AND over every term but the second; 5 clauses of up to 3 terms (one
    empty) and 4 members (one with no clause)."""
    rng = np.random.default_rng(seed + 100)
    and_bits = ((1 << T) - 1) & ~2
    clauses = [int(sum(1 << int(t) for t in rng.choice(T, size=min(3, T), replace=False)))
               for _ in range(4)] + [0]
    members = [0b00011, 0b01100, 0b10001, 0]

    def reduce_and(m):
        active = [(and_bits >> t) & 1 for t in range(T)]
        return m[np.array(active, bool)].all(axis=0, keepdims=True)

    def cnf(m):
        ok = [m[[t for t in range(T) if (c >> t) & 1]].any(axis=0) for c in clauses]
        return np.stack([np.all([ok[i] for i in range(5) if (b >> i) & 1] or
                                [np.ones(m.shape[1], bool)], axis=0) for b in members])

    return [
        ("probe_and_pack", (), lambda m: m),
        ("probe_reduce_and_pack", (and_bits,), reduce_and),
        ("probe_clauses_pack", (clauses, members), cnf),
    ]


def words(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("seed,R,C,T,K", CASES)
def test_epilogues_match_plain_and_oracle(dev, seed, R, C, T, K):
    bank, rows, shifts = make_case(seed, R, C, T, K)
    on_card = torch.from_numpy(bank.view(np.int32)).to(dev)
    match = oracle_match(bank, rows, shifts, T, K)
    assert match.any() and not match.all()
    r_dev, s_dev = torch.from_numpy(rows).to(dev), torch.from_numpy(shifts).to(dev)
    plain_match = tk.probe_plain(on_card, r_dev, s_dev, T, K)
    np.testing.assert_array_equal(plain_match.cpu().numpy(), match)
    for name, extra, oracle in epilogues(T, seed):
        want = pack(oracle(match))
        # numpy probe arrays, then CPU tensors: the same launch.
        got = getattr(tk, name)(on_card, rows, shifts, T, K, *extra)
        got_t = getattr(tk, name)(on_card, torch.from_numpy(rows), torch.from_numpy(shifts),
                                  T, K, *extra)
        plain = {"probe_and_pack": lambda m: m,
                 "probe_reduce_and_pack": lambda m: tk.reduce_and_plain(m, *extra),
                 "probe_clauses_pack": lambda m: tk.clauses_plain(m, *extra)}[name]
        torch.cuda.synchronize()
        np.testing.assert_array_equal(words(got), want, err_msg=name)
        np.testing.assert_array_equal(words(got_t), want, err_msg=name)
        np.testing.assert_array_equal(
            words(tk.pack_bitmap_plain(plain(plain_match))), want, err_msg=name)


@pytest.mark.parametrize("seed,R,C,T,K", CASES)
def test_floor_matches_plain_and_oracle(dev, seed, R, C, T, K):
    bank, rows, shifts = make_case(seed, R, C, T, K)
    rows[1::3] = np.minimum(rows[1::3] | 7, R - 1)  # both ends of an 8-row group
    on_card = torch.from_numpy(bank.view(np.int32)).to(dev)
    got = tk.probe_floor(on_card, rows, shifts, T, K)
    plain = tk.probe_floor_plain(on_card, torch.from_numpy(rows).to(dev), T, K)
    torch.cuda.synchronize()
    want = oracle_floor(bank, rows, T, K)
    np.testing.assert_array_equal(words(got), want)
    np.testing.assert_array_equal(words(plain), want)


def test_probe_arrays_on_the_card_are_refused(dev):
    bank, rows, shifts = make_case(9, 16, 64, 2, 3)
    on_card = torch.from_numpy(bank.view(np.int32)).to(dev)
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="host data"):
        tk.probe_and_pack(on_card, torch.from_numpy(rows).to(dev), shifts, 2, 3)
    with pytest.raises(ValueError, match="host data"):
        tk.probe_floor(on_card, rows, torch.from_numpy(shifts).to(dev), 2, 3)
    with pytest.raises(ValueError):
        tk.probe_and_pack(on_card, np.zeros(tk.MAX_PROBES + 1, np.int32),
                          np.zeros(tk.MAX_PROBES + 1, np.int32), 1, tk.MAX_PROBES + 1)
    assert sum(tk.launch_counts().values()) == 0


def test_launch_counts_and_captured_launches_keep_their_own_probes(dev):
    """Each wrapper counts one launch where it launches; a chain captured
    in a CUDA graph keeps each launch's probe arrays (they are its
    parameters) and each replay counts them."""
    T, K, R, C = 3, 10, 200, 512
    bank, _, _ = make_case(10, R, C, T, K)
    on_card = torch.from_numpy(bank.view(np.int32)).to(dev)
    rng = np.random.default_rng(11)
    sets = [(rng.integers(0, R, T * K).astype(np.int32),
             rng.integers(0, 32, T * K).astype(np.int32)) for _ in range(3)]
    tk.reset_launch_counts()
    tk.probe_and_pack(on_card, *sets[0], T, K)
    tk.probe_reduce_and_pack(on_card, *sets[0], T, K, 7)
    tk.probe_clauses_pack(on_card, *sets[0], T, K, [1, 6], [3])
    assert tk.launch_counts() == {"pack": 1, "reduce_and": 1, "clauses": 1, "floor": 0}
    assert tk.launch_shapes() == {("pack", C, T, T, 0): 1, ("reduce_and", C, T, 1, 0): 1,
                                  ("clauses", C, T, 1, 2): 1}
    outs = [torch.empty((T, C), dtype=torch.int32, device=dev) for _ in sets]
    tk.probe_floor(on_card, *sets[0], T, K, out=outs[0])  # load outside the capture
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    chain = tk.CapturedLaunches(
        lambda: [tk.probe_floor(on_card, *s, T, K, out=o) for s, o in zip(sets, outs)], dev)
    assert tk.launch_counts()["floor"] == 0
    for o in outs:
        o.zero_()
    chain.replay()
    torch.cuda.synchronize()
    assert tk.launch_counts()["floor"] == 3
    for (rows, _), o in zip(sets, outs):
        np.testing.assert_array_equal(words(o), oracle_floor(bank, rows, T, K))


# -- the plan entry (bs_probe_plan) ---------------------------------------------

REFSCALE_ROWS = 1_347_900  # 3 keyspaces x 449,300 words (1M items, FPR 0.001)
SINGLE = {"pack": "probe_and_pack", "reduce_and": "probe_reduce_and_pack",
          "clauses": "probe_clauses_pack"}


@pytest.fixture
def card(dev):
    """The first card by its index (the plan tests set and compare
    devices)."""
    return torch.device("cuda", 0)


def random_banks(devices, rows: int, cols: int, seed: int) -> tuple:
    """Random bank shards int32[rows, cols], one on each of ``devices``,
    made on the card."""
    gens = {d: torch.Generator(device=d).manual_seed(seed) for d in dict.fromkeys(devices)}
    return tuple(torch.randint(-(2**31), 2**31, (rows, cols), generator=gens[d], device=d,
                               dtype=torch.int64).to(torch.int32) for d in devices)


def probe_args(T: int, rows: int, seed: int, K: int = 10) -> tuple:
    """Host probe arrays (shift 31 among them) and each epilogue's
    arguments: every term in the AND but the second, 3 clauses, 2 members."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, T * K).astype(np.int32)
    s = rng.integers(0, 32, T * K).astype(np.int32)
    s[::4] = 31
    extra = {"pack": {}, "reduce_and": {"and_bits": ((1 << T) - 1) & ~2},
             "clauses": {"clause_bits": [0b11 & ((1 << T) - 1), 1 << (T - 1), (1 << T) - 1],
                         "member_bits": [0b011, 0b110]}}
    return r, s, extra


def plant(banks, r, s, T: int, K: int, seed: int) -> None:
    """Set every probed bit of each term in some columns of each bank: a
    fifth of the columns for every term (so an AND of many terms matches
    somewhere), a further random third for each term alone."""
    gen = torch.Generator(device=banks[0].device).manual_seed(seed)
    for bank in banks:
        C = bank.shape[1]
        shared = torch.rand(C, generator=gen, device=gen.device) < 0.2
        for t in range(T):
            cols = (shared | (torch.rand(C, generator=gen, device=gen.device) < 0.3)).to(
                bank.device)
            for p in range(t * K, (t + 1) * K):
                bit = int(np.uint32(1 << int(s[p] & 31)).view(np.int32))
                bank[int(r[p])] |= torch.where(cols, bit, 0).to(torch.int32)


def plain_words(bank, r, s, T, K, epilogue, extra) -> torch.Tensor:
    match = tk.probe_plain(bank, torch.from_numpy(r).to(bank.device),
                           torch.from_numpy(s).to(bank.device), T, K)
    if epilogue == "reduce_and":
        match = tk.reduce_and_plain(match, extra["and_bits"])
    elif epilogue == "clauses":
        match = tk.clauses_plain(match, extra["clause_bits"], extra["member_bits"])
    return tk.pack_bitmap_plain(match).cpu()


def single(bank, r, s, T, K, epilogue, extra) -> torch.Tensor:
    """The single launch (bs_probe_launch) into a new device tensor."""
    return getattr(tk, SINGLE[epilogue])(bank, r, s, T, K, *extra.values()).cpu()


def mesh_kind(kind: str, dev):
    if kind == "distinct cards":
        n = min(torch.cuda.device_count(), 4)
        if n < 2:
            pytest.skip("needs two or more cards")
        return pm.Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return pm.Mesh((dev,) * 4)


@pytest.mark.parametrize("kind", ["4 shards on one card", "distinct cards"])
@pytest.mark.parametrize("epilogue", list(SINGLE))
def test_plan_matches_single_launches_at_the_main_path_shapes(card, kind, epilogue):
    """At refscale widths (R = 1,347,900; shards of 128 columns, the one-card
    bank of 256), T = 1, 4, 16 and 32 with K = 10 (32 x 10 takes the larger
    parameter capacity): the sharded wrapper (one plan call, a launch a
    card) equals the single launch on the shards joined on one card and the
    plain version; the single-device combiner's call (``probe_plan`` with one
    launch of the unsharded instantiation into a page-locked buffer) and the
    plan into a device buffer equal the single launch on the one-card bank."""
    mesh = mesh_kind(kind, card)
    shards = random_banks(mesh.devices, REFSCALE_ROWS, 128, 3)
    one_card = random_banks((card,), REFSCALE_ROWS, 256, 4)[0]
    wrapper = {"pack": pm.sharded_probe_packed, "reduce_and": pm.sharded_query_step,
               "clauses": pm.sharded_probe_clauses}[epilogue]

    def call(m, bank2d, r, s, T, extra):
        if epilogue == "reduce_and":
            return wrapper(m, bank2d, r, s, extra["and_bits"], T, 10)[0][None, :]
        if epilogue == "clauses":
            return wrapper(m, bank2d, r, s, extra["clause_bits"], extra["member_bits"], T, 10)
        return wrapper(m, bank2d, r, s, T, 10)

    for T in (1, 4, 16, 32):
        r, s, extras = probe_args(T, REFSCALE_ROWS, T)
        extra = extras[epilogue]
        plant(shards, r, s, T, 10, T)
        plant((one_card,), r, s, T, 10, T)
        flat = torch.cat([sh.to(card) for sh in shards], dim=1)
        tk.reset_launch_counts()
        got = call(mesh, shards, r, s, T, extra)
        assert got.is_pinned() and sum(tk.launch_counts().values()) == len(
            mesh.distinct_devices())
        want = single(flat, r, s, T, 10, epilogue, extra)
        assert torch.equal(got, want), (T, epilogue)
        assert torch.equal(got, plain_words(flat, r, s, T, 10, epilogue, extra)), (T, epilogue)
        bits = np.unpackbits(got.numpy().view(np.uint8))
        assert bits.any() and not bits.all(), (T, epilogue)
        one = tk.probe_plan([(0, [one_card])], 256 // 32, r, s, T, 10, epilogue, **extra)
        want_one = single(one_card, r, s, T, 10, epilogue, extra)
        assert one.is_pinned() and torch.equal(one, want_one), (T, epilogue)
        assert torch.equal(one, plain_words(one_card, r, s, T, 10, epilogue, extra))
        on_card = torch.full(tuple(want_one.shape), 7, dtype=torch.int32, device=card)
        tk.probe_plan_into(on_card, [(0, [one_card])], r, s, T, 10, epilogue, **extra)
        assert torch.equal(on_card.cpu(), want_one), (T, epilogue)


def test_two_threads_call_the_plan_at_once(card):
    """Two query threads probing at once, each with its own probes and
    epilogue, 200 calls each: every answer equals the one the main thread
    got alone (each thread waits on its own event)."""
    mesh = mesh_kind("4 shards on one card", card)
    shards = random_banks(mesh.devices, REFSCALE_ROWS, 128, 5)
    r4, s4, extra4 = probe_args(4, REFSCALE_ROWS, 6)
    r1, s1, extra1 = probe_args(1, REFSCALE_ROWS, 7)
    cases = [lambda: pm.sharded_probe_packed(mesh, shards, r4, s4, 4, 10),
             lambda: pm.sharded_query_step(mesh, shards, r1, s1, 1, 1, 10)[0]]
    want = [c() for c in cases]
    barrier = threading.Barrier(2)
    got: list = [[], []]

    def worker(i):
        barrier.wait()
        for _ in range(200):
            got[i].append(cases[i]())

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for i in range(2):
        assert len(got[i]) == 200 and all(torch.equal(w, want[i]) for w in got[i]), i


def test_the_callers_current_device_is_unchanged(card):
    """Each plan call sets the device of each card it launches on and gives
    the caller back the device it had: on one card and, where several are
    visible, from each card's thread state over a mesh of distinct cards."""
    n = min(torch.cuda.device_count(), 4)
    meshes = [mesh_kind("4 shards on one card", card)]
    if n >= 2:
        meshes.append(mesh_kind("distinct cards", card))
    banks = [random_banks(m.devices, 512, 128, 2) for m in meshes]
    r, s, _ = probe_args(3, 512, 8)
    try:
        for current in range(n):
            torch.cuda.set_device(current)
            for mesh, shards in zip(meshes, banks):
                pm.sharded_probe_clauses(mesh, shards, r, s, [0b011, 0b100], [0b11], 3, 10)
                assert torch.cuda.current_device() == current
                tk.probe_plan([(0, [shards[0]])], 4, r, s, 3, 10, "reduce_and", and_bits=0b111)
                assert torch.cuda.current_device() == current
    finally:
        torch.cuda.set_device(card)


def test_pageable_output_is_refused_by_the_plan(card):
    """A plan into host memory that is not page-locked raises before
    anything is launched: its words stay as they were and nothing counts."""
    bank = torch.zeros((64, 128), dtype=torch.int32, device=card)
    r = np.zeros(4, np.int32)
    out = torch.full((2, 4), 7, dtype=torch.int32)
    tk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError"):
        tk.probe_plan_into(out, [(0, [bank])], r, r, 2, 2, "pack")
    torch.cuda.synchronize()
    assert (out == 7).all() and sum(tk.launch_counts().values()) == 0


def test_a_failure_part_way_waits_for_the_cards_that_launched(card):
    """A plan whose second launch names a card index the record takes but
    no machine has: the call raises that error only once the first launch,
    queued behind some 50 ms of spinning on its stream, has finished, so
    its words are all there when the call returns, and the caller's
    current device is kept."""
    shards = random_banks((card,) * 4, REFSCALE_ROWS, 128, 4)
    r, s, _ = probe_args(16, REFSCALE_ROWS, 9)
    want = pm.sharded_probe_packed(pm.Mesh((card,) * 4), shards, r, s, 16, 10)
    rows, shifts = tk._check(shards[0], r, s, 16, 10)
    out = torch.full(tuple(want.shape), 0x5A5A5A5A, dtype=torch.int32).pin_memory()
    plan = [(0, list(shards)), (0, [shards[0]])]
    records = tk.plan_records(plan, {card: torch.cuda.current_stream(card).cuda_stream})
    records[1].device = 63  # below csrc/probe.cu's MAX_DEVICES (64)
    records[1].stream = None
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # the first launch waits behind it
    with pytest.raises(RuntimeError, match="cudaError 101"):  # cudaErrorInvalidDevice
        tk.plan_call(rows, shifts, 16, 10, "pack", records, out)
    assert torch.equal(out, want)
    assert torch.cuda.current_device() == card.index


def test_a_record_size_mismatch_is_refused_at_bind(card, monkeypatch):
    """A ``PlanLaunch`` mirror of another size than the library's record is
    refused when the library is bound, before any launch."""
    tk.library()

    class Padded(ctypes.Structure):
        _fields_ = tk.PlanLaunch._fields_ + [("extra", ctypes.c_int64)]

    monkeypatch.setattr(tk, "PlanLaunch", Padded)
    monkeypatch.setattr(tk, "_lib", None)
    with pytest.raises(RuntimeError, match="plan record is 104 bytes"):
        tk.library()


def test_a_fresh_thread_makes_the_single_device_call(card):
    """The engine's worker threads make the single-device combiner's call
    (``probe_plan`` over the one bank): a thread that has made no CUDA call has no current
    context, and the page-locked buffer then has no device address until
    the plan makes the card's context current."""
    bank = random_banks((card,), REFSCALE_ROWS, 256, 10)[0]
    r, s, _ = probe_args(2, REFSCALE_ROWS, 11)

    def run():
        return tk.probe_plan([(0, [bank])], 256 // 32, r, s, 2, 10, "clauses",
                             clause_bits=[0b01, 0b10], member_bits=[0b11])

    want = run()
    got: list = []
    worker = threading.Thread(target=lambda: got.append(run()))
    worker.start()
    worker.join()
    assert len(got) == 1 and torch.equal(got[0], want)

"""K1 (its three epilogues) and K1f on the card, against their plain
PyTorch versions and a numpy oracle. No JAX: this file runs where the JAX
package cannot.

Every case is exact: the kernel's packed words (K1f's unpacked words) are
bit-identical to the plain version's and to the oracle's. The cases cover
term counts that are not powers of two, K up to 30, shift 31 on words whose
top bit is set, rows outside [0, R) (they read 0), C from 32 to 32,768, both
parameter capacities of the kernel (T*K up to ``MAX_PROBES``), probe
arrays given as numpy arrays and as CPU tensors, and launches captured in a
CUDA graph, each with its own probes. Every test is marked ``cuda`` and
skips without a card. On a machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_probe_card.py

(``--noconftest``: the suite's conftest imports JAX to pin its platform.)
"""

import numpy as np
import pytest
import torch

from bloomsearch_tpu_torch.kernels import probe as tk

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

"""The port's block-bloom probe (K1 and its epilogues) against the JAX package.

Inputs come from numpy seeds and go through both packages: the JAX side runs
the Pallas kernel in interpret mode (``probe_bank_pallas_tk``) and the fused
epilogues with ``use_pallas=True, interpret=True``; the port's side runs the
wrappers on CPU tensors, i.e. the plain PyTorch versions. Every comparison is
exact: bit-identical packed words. One test runs the CUDA kernel against the
plain version and needs a card.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import bloomsearch_tpu as bs  # noqa: E402
from bloomsearch_tpu.bloom import BloomParams  # noqa: E402
from bloomsearch_tpu.bloom import pallas_kernels as pk  # noqa: E402
from bloomsearch_tpu.bloom.probe import compile_bloom_terms, stack_filter_bank  # noqa: E402
from bloomsearch_tpu.file_format import BloomFilters  # noqa: E402
from bloomsearch_tpu_torch.kernels import probe as tk  # noqa: E402


def make_case(seed: int, R: int, C: int, T: int, K: int, zero_cols: int = 0):
    """Random bank uint32[R, C] with bit 31 set often, T*K probes (shift 31
    among them), and planted full matches so every term matches somewhere."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 2**32, size=(R, C), dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, R, size=T * K).astype(np.int32)
    shifts = rng.integers(0, 32, size=T * K).astype(np.int32)
    shifts[::3] = 31
    for t in range(T):
        cols = rng.random(C) < 0.4
        for j in range(K):
            p = t * K + j
            bank[rows[p], cols] |= np.uint32(1) << np.uint32(shifts[p])
    if zero_cols:
        bank[:, C - zero_cols :] = 0
    return bank, rows, shifts


def port_args(bank, rows, shifts):
    return (
        torch.from_numpy(bank.view(np.int32).copy()),
        torch.from_numpy(rows),
        torch.from_numpy(shifts),
    )


def words(x) -> np.ndarray:
    """Packed words of either package as uint32."""
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def mask_bits(clause_mask, member_mask) -> tuple[list[int], list[int]]:
    """The JAX package's dense masks (clause [Cl, T], member [M, Cl],
    nonzero = in, padding rows included) -> the port's bit masks."""
    weights_t = 1 << np.arange(clause_mask.shape[1], dtype=np.int64)
    weights_c = 1 << np.arange(member_mask.shape[1], dtype=np.int64)
    clause_bits = (clause_mask != 0).astype(np.int64) @ weights_t
    member_bits = (member_mask != 0).astype(np.int64) @ weights_c
    return [int(b) for b in clause_bits], [int(b) for b in member_bits]


def jax_probe(bank, rows, shifts, T, K, **kw):
    return np.asarray(
        pk.probe_bank_pallas_tk(
            jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, K,
            interpret=True, **kw,
        )
    ) != 0


CASES = [
    # (seed, R, C, T, K, zero padding columns)
    (0, 8, 128, 1, 3, 0),
    (1, 16, 128, 3, 4, 32),
    (2, 24, 256, 4, 2, 64),
    (3, 40, 128, 2, 7, 0),
]


class TestProbeParity:
    @pytest.mark.parametrize("seed,R,C,T,K,zero", CASES)
    def test_probe_plain_matches_pallas(self, seed, R, C, T, K, zero):
        bank, rows, shifts = make_case(seed, R, C, T, K, zero)
        want = jax_probe(bank, rows, shifts, T, K)
        got = tk.probe_plain(*port_args(bank, rows, shifts), T, K).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()
        if zero:
            assert not got[:, C - zero :].any()

    def test_shift_31_on_top_bit_words(self):
        """int32 '>>' is arithmetic; '& 1' must still read bit 31 exactly."""
        bank = np.full((8, 128), 0x80000000, dtype=np.uint32)
        bank[:, 64:] = 0x7FFFFFFF
        rows = np.array([0, 5], dtype=np.int32)
        shifts = np.array([31, 31], dtype=np.int32)
        want = jax_probe(bank, rows, shifts, 1, 2)
        got = tk.probe_plain(*port_args(bank, rows, shifts), 1, 2).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0, :64].all() and not got[0, 64:].any()

    def test_multi_tile_bank_matches_pallas_c_tile_128(self):
        """C = 512 spans four 128-column tiles on the JAX side."""
        bank, rows, shifts = make_case(7, 16, 512, 3, 4)
        want = jax_probe(bank, rows, shifts, 3, 4, c_tile=128)
        got = tk.probe_plain(*port_args(bank, rows, shifts), 3, 4).numpy()
        np.testing.assert_array_equal(got, want)

    def test_pack_bitmap_matches(self):
        rng = np.random.default_rng(11)
        match = rng.random((5, 256)) < 0.5
        match[0, 31] = match[1, :32] = True  # top bit of a word
        want = words(pk.pack_bitmap(jnp.asarray(match)))
        got = words(tk.pack_bitmap_plain(torch.from_numpy(match)))
        np.testing.assert_array_equal(got, want)


class TestEpilogueParity:
    @pytest.mark.parametrize("seed,R,C,T,K,zero", CASES)
    def test_probe_and_pack(self, seed, R, C, T, K, zero):
        bank, rows, shifts = make_case(seed, R, C, T, K, zero)
        want = words(
            pk.probe_and_pack(
                jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, K,
                use_pallas=True, interpret=True,
            )
        )
        got = words(tk.probe_and_pack(*port_args(bank, rows, shifts), T, K))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("T,active", [(1, 1), (2, 1), (4, 3), (8, 5)])
    def test_reduce_and_with_padding_terms(self, T, active):
        """Tp padding terms (zero rows/shifts, as the bank pads) sit outside
        the AND and count as true."""
        K = 3
        bank, rows, shifts = make_case(20 + T, 16, 256, T, K, zero_cols=32)
        rows[active * K :] = 0
        shifts[active * K :] = 0
        and_mask = np.arange(T) < active
        want = words(
            pk.probe_reduce_and_pack(
                jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, K,
                jnp.asarray(and_mask), use_pallas=True, interpret=True,
            )
        )
        got = words(
            tk.probe_reduce_and_pack(
                *port_args(bank, rows, shifts), T, K, (1 << active) - 1
            )
        )
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("seed,T,Cp,Mp", [(30, 2, 16, 16), (31, 4, 16, 16), (32, 8, 32, 16)])
    def test_clauses(self, seed, T, Cp, Mp):
        rng = np.random.default_rng(seed)
        K = 2
        bank, rows, shifts = make_case(seed, 16, 128, T, K, zero_cols=32)
        n_clauses = Cp // 2
        n_members = Mp // 2
        clause = np.zeros((Cp, T), dtype=np.float32)
        clause[:n_clauses] = rng.random((n_clauses, T)) < 0.4
        member = np.zeros((Mp, Cp), dtype=np.float32)
        member[:n_members, :n_clauses] = rng.random((n_members, n_clauses)) < 0.3
        want = words(
            pk.probe_clauses_pack(
                jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, K,
                jnp.asarray(clause), jnp.asarray(member),
                use_pallas=True, interpret=True,
            )
        )
        cb, mb = mask_bits(clause, member)
        got = words(tk.probe_clauses_pack(*port_args(bank, rows, shifts), T, K, cb, mb))
        np.testing.assert_array_equal(got, want)
        # Padding members survive everywhere, as in the reference.
        assert (got[n_members:] == 0xFFFFFFFF).all()

    def test_sixteen_members_sixteen_clauses(self):
        """A full combined batch: 16 one-term members, one clause each."""
        T, K = 16, 2
        bank, rows, shifts = make_case(40, 16, 128, T, K)
        clause = np.eye(16, T, dtype=np.float32)
        member = np.eye(16, 16, dtype=np.float32)
        want = words(
            pk.probe_clauses_pack(
                jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, K,
                jnp.asarray(clause), jnp.asarray(member),
                use_pallas=True, interpret=True,
            )
        )
        cb, mb = mask_bits(clause, member)
        assert cb == [1 << i for i in range(16)] and mb == cb
        got = words(tk.probe_clauses_pack(*port_args(bank, rows, shifts), T, K, cb, mb))
        np.testing.assert_array_equal(got, want)


def test_real_bloom_filter_bank():
    """A bank built from real BloomFilters, probed for real query terms."""
    params = BloomParams(1000, 0.01)
    triples = []
    for fields, tokens, fts in [
        (["service"], ["error", "timeout"], ["service::payment"]),
        (["level"], ["info"], ["level::info"]),
        (["service", "level"], ["error"], ["service::auth"]),
    ]:
        t = BloomFilters.from_params(params)
        t.field.add_keys(fields)
        t.token.add_keys(tokens)
        t.field_token.add_keys(fts)
        triples.append(t)
    host = stack_filter_bank(triples)  # uint32[3, W, 3]
    _, W, B = host.shape
    bank = np.zeros((pk.round_up_rows(3 * W), 128), dtype=np.uint32)
    bank[: 3 * W, :B] = host.reshape(3 * W, B)
    q = bs.new_query().token("error").field("level").field_token("service", "payment").build()
    terms = compile_bloom_terms(q.bloom)
    word_idx, bit_idx = terms.positions_for(params.m_bits, params.k)
    rows = (terms.ks_idx[:, None].astype(np.int32) * W + word_idx).reshape(-1).astype(np.int32)
    shifts = bit_idx.reshape(-1).astype(np.int32)
    T, K = len(terms), params.k
    want = words(
        pk.probe_and_pack(
            jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, K,
            use_pallas=True, interpret=True,
        )
    )
    got = words(tk.probe_and_pack(*port_args(bank, rows, shifts), T, K))
    np.testing.assert_array_equal(got, want)
    bits = np.unpackbits(got.view(np.uint8), axis=1, bitorder="little")[:, :B]
    np.testing.assert_array_equal(bits, [[1, 0, 1], [0, 1, 1], [1, 0, 0]])


def test_wrappers_reject_what_the_kernel_does_not_take():
    bank, rows, shifts = make_case(50, 8, 128, 2, 2)
    b, r, s = port_args(bank, rows, shifts)
    with pytest.raises(ValueError):
        tk.probe_and_pack(b.to(torch.int64), r, s, 2, 2)
    with pytest.raises(ValueError):
        tk.probe_and_pack(b[:, :100].contiguous(), r, s, 2, 2)
    with pytest.raises(ValueError):
        tk.probe_and_pack(b, r[:3], s[:3], 2, 2)
    with pytest.raises(ValueError):
        tk.probe_clauses_pack(b, r, s, 2, 2, [1] * 33, [1])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    dev = torch.device("cuda")
    tk.reset_launch_counts()
    for seed, (R, C, T, K) in enumerate([(40, 256, 3, 10), (16, 4096, 16, 2), (1024, 128, 1, 7)]):
        bank, rows, shifts = make_case(60 + seed, R, C, T, K, zero_cols=32)
        cpu = port_args(bank, rows, shifts)
        gpu = tuple(t.to(dev) for t in cpu)
        cb = [(1 << (i % T)) | (1 << ((i + 1) % T)) for i in range(16)]
        mb = [(1 << m) | (1 << ((m + 5) % 16)) for m in range(16)]
        for fn, extra in (
            (tk.probe_and_pack, ()),
            (tk.probe_reduce_and_pack, ((1 << T) - 1,)),
            (tk.probe_clauses_pack, (cb, mb)),
        ):
            got = fn(*gpu, T, K, *extra)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(words(got.cpu()), words(fn(*cpu, T, K, *extra)))
    assert tk.launch_counts() == {"pack": 3, "reduce_and": 3, "clauses": 3}
    assert tk.launch_shapes()[("clauses", 256, 3, 16, 16)] == 1
    assert sum(tk.launch_shapes().values()) == 9

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
        """Padding terms (zero rows/shifts, as the JAX bank pads) sit outside
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


def jax_epilogue(name, bank, rows, shifts, T, K, extra):
    """The JAX package's fused epilogue ``name`` through its Pallas kernel
    in interpret mode, with the port's bit-mask arguments as its masks."""
    args = (jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts), T, K)
    common = dict(use_pallas=True, interpret=True)
    if name == "probe_and_pack":
        return words(pk.probe_and_pack(*args, **common))
    if name == "probe_reduce_and_pack":
        mask = np.array([(extra[0] >> t) & 1 for t in range(T)], dtype=bool)
        return words(pk.probe_reduce_and_pack(*args, jnp.asarray(mask), **common))
    cb, mb = extra
    clause = np.array([[(b >> t) & 1 for t in range(T)] for b in cb], np.float32)
    member = np.array([[(b >> i) & 1 for i in range(len(cb))] for b in mb], np.float32)
    return words(pk.probe_clauses_pack(*args, jnp.asarray(clause), jnp.asarray(member),
                                       **common))


def odd_epilogue_args(T: int) -> dict:
    """Each epilogue's arguments at T terms: the AND skips term 1; three
    clauses (one of the last term alone), two members."""
    return {
        "probe_and_pack": (),
        "probe_reduce_and_pack": (((1 << T) - 1) & ~2,),
        "probe_clauses_pack": ([0b11 & ((1 << T) - 1), 1 << (T - 1), (1 << T) - 1],
                               [0b011, 0b110]),
    }


class TestHostProbeArrays:
    """The probe arrays are host data: numpy arrays or CPU tensors, any term
    count up to 32 (no power-of-two padding), any K up to the limit."""

    @pytest.mark.parametrize("T,K", [(3, 1), (5, 7), (6, 10), (7, 20), (11, 30)])
    @pytest.mark.parametrize("name", ["probe_and_pack", "probe_reduce_and_pack",
                                      "probe_clauses_pack"])
    def test_numpy_and_cpu_tensor_probes_match_pallas(self, T, K, name):
        bank, rows, shifts = make_case(T * 100 + K, 64, 256, T, K, zero_cols=32)
        extra = odd_epilogue_args(T)[name]
        want = jax_epilogue(name, bank, rows, shifts, T, K, extra)
        b = torch.from_numpy(bank.view(np.int32).copy())
        fn = getattr(tk, name)
        np.testing.assert_array_equal(words(fn(b, rows, shifts, T, K, *extra)), want)
        np.testing.assert_array_equal(
            words(fn(b, torch.from_numpy(rows), torch.from_numpy(shifts), T, K, *extra)), want)
        if name == "probe_and_pack":
            assert want.any() and not want.all()

    def test_probe_arrays_on_another_device_are_refused(self):
        bank, rows, shifts = make_case(70, 8, 128, 2, 2)
        b = torch.from_numpy(bank.view(np.int32).copy())
        meta = torch.empty(4, dtype=torch.int32, device="meta")
        for fn, extra in ((tk.probe_and_pack, ()), (tk.probe_reduce_and_pack, (3,)),
                          (tk.probe_clauses_pack, ([1], [1]))):
            with pytest.raises(ValueError, match="host data"):
                fn(b, meta, shifts, 2, 2, *extra)
            with pytest.raises(ValueError, match="host data"):
                fn(b, rows, meta, 2, 2, *extra)
        with pytest.raises(ValueError, match="host data"):
            tk.probe_floor(b, meta, shifts, 2, 2)
        with pytest.raises(ValueError):
            tk.probe_and_pack(b, rows.astype(np.int64), shifts, 2, 2)
        with pytest.raises(ValueError):
            tk.probe_and_pack(b, torch.from_numpy(rows).long(), shifts, 2, 2)

    def test_probe_limit_is_refused_one_past_it(self):
        """T*K = MAX_PROBES (the kernel's parameter capacity) runs and equals
        the JAX package's probe; one more probe, or a 33rd term, is
        refused."""
        T, K = 32, tk.MAX_PROBES // 32
        assert T * K == tk.MAX_PROBES == 6400
        bank, rows, shifts = make_case(71, 16, 128, T, K)
        want = np.asarray(pk.probe_bank_xla(jnp.asarray(bank), jnp.asarray(rows),
                                            jnp.asarray(shifts), K))
        got = tk.probe_plain(*port_args(bank, rows, shifts), T, K).numpy()
        np.testing.assert_array_equal(got, want)
        b = torch.from_numpy(bank.view(np.int32).copy())
        np.testing.assert_array_equal(tk.probe_and_pack(b, rows, shifts, T, K).numpy(),
                                      tk.pack_bitmap_plain(torch.from_numpy(want.copy())).numpy())
        over = np.zeros(tk.MAX_PROBES + 1, np.int32)
        with pytest.raises(ValueError, match="6400 probes"):
            tk.probe_and_pack(b, over, over, 1, tk.MAX_PROBES + 1)
        with pytest.raises(ValueError, match="6400 probes"):
            tk.probe_floor(b, over, over, 1, tk.MAX_PROBES + 1)
        with pytest.raises(ValueError):
            tk.probe_and_pack(b, np.zeros(33, np.int32), np.zeros(33, np.int32), 33, 1)

    def test_rows_outside_the_bank_read_zero(self):
        """The kernel's row check, in the plain versions: a probe of a row
        outside [0, R) reads 0, so its term never matches."""
        bank = np.full((16, 64), 0xFFFFFFFF, dtype=np.uint32)
        rows = np.array([0, 3, -1, 5, 16, 2, 2**31 - 1, 7], dtype=np.int32)
        shifts = np.full(8, 31, dtype=np.int32)
        b = torch.from_numpy(bank.view(np.int32).copy())
        got = words(tk.probe_and_pack(b, rows, shifts, 4, 2))
        np.testing.assert_array_equal(got, [[0xFFFFFFFF] * 2, [0] * 2, [0] * 2, [0] * 2])
        floor = tk.probe_floor(b, rows, shifts, 4, 2).numpy().view(np.uint32)
        assert (floor == 0xFFFFFFFF).all()  # each term has one row inside


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    dev = torch.device("cuda")
    tk.reset_launch_counts()
    for seed, (R, C, T, K) in enumerate([(40, 256, 3, 10), (16, 4096, 16, 2), (1024, 128, 1, 7)]):
        bank, rows, shifts = make_case(60 + seed, R, C, T, K, zero_cols=32)
        cpu = port_args(bank, rows, shifts)
        gpu = (cpu[0].to(dev), rows, shifts)  # the probe arrays stay host arrays
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
    assert tk.launch_counts() == {"pack": 3, "reduce_and": 3, "clauses": 3, "floor": 0}
    assert tk.launch_shapes()[("clauses", 256, 3, 16, 16)] == 1
    assert sum(tk.launch_shapes().values()) == 9


# -- the plan entry (probe_plan_into, csrc/probe.cu's bs_probe_plan) -----------


def c_plan_layout() -> tuple[list[tuple[str, int]], list[tuple[str, int]], int]:
    """csrc/probe.cu's PlanLaunch as its source states it -> (each field
    with the offset its comment gives, in order; the offsets its
    static_assert holds; the size the static_assert holds)."""
    import re

    with open(tk.SOURCE) as fh:
        text = fh.read()
    body = re.search(r"struct PlanLaunch \{(.*?)\};", text, re.S).group(1)
    fields = [(name, int(off)) for name, off in
              re.findall(r"(\w+)(?:\[\w+\])?;\s*// (?:offset )?(\d+)", body)]
    asserted = [(name, int(off)) for name, off in
                re.findall(r"offsetof\(PlanLaunch, (\w+)\) == (\d+)", text)]
    size = int(re.search(r"sizeof\(PlanLaunch\) == (\d+)", text).group(1))
    return fields, asserted, size


def test_plan_record_mirror_has_the_c_layout():
    """``PlanLaunch`` puts every field where the C record's declaration and
    its ``static_assert`` put it, read from ``csrc/probe.cu`` itself, and
    is as large: a record off by a field would launch on the wrong
    pointers."""
    import ctypes

    fields, asserted, size = c_plan_layout()
    mirror = [(name, getattr(tk.PlanLaunch, name).offset) for name, _ in tk.PlanLaunch._fields_]
    assert mirror == fields
    assert len(asserted) == len(fields) - 1 and set(asserted) <= set(mirror)
    assert ctypes.sizeof(tk.PlanLaunch) == size == 104
    assert tk.PlanLaunch.shards.size == 8 * tk.MAX_SHARDS


def plan_banks(seed: int, T: int, K: int, n: int = 3, R: int = 40, C: int = 128):
    """``n`` banks uint32[R, C] with bit 31 set on half the words, T*K probes
    (shift 31 among them) and columns where every probe of a term is set:
    some shared by every term (so an AND of 32 terms still matches), the
    rest the term's own."""
    rng = np.random.default_rng(seed)
    banks = rng.integers(0, 2**32, size=(n, R, C), dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, R, size=T * K).astype(np.int32)
    shifts = rng.integers(0, 32, size=T * K).astype(np.int32)
    shifts[::3] = 31
    shared = rng.random((n, C)) < 0.2
    for t in range(T):
        cols = shared | (rng.random((n, C)) < 0.3)
        for j in range(K):
            p = t * K + j
            for i in range(n):
                banks[i, rows[p], cols[i]] |= np.uint32(1) << np.uint32(shifts[p])
    return banks, rows, shifts


PLAN_EPILOGUES = {
    # epilogue: (its arguments at T terms, the single-bank wrapper)
    "pack": (lambda T: {}, "probe_and_pack"),
    "reduce_and": (lambda T: {"and_bits": ((1 << T) - 1) & ~2}, "probe_reduce_and_pack"),
    "clauses": (lambda T: {"clause_bits": [0b11 & ((1 << T) - 1), 1 << (T - 1), (1 << T) - 1],
                           "member_bits": [0b011, 0b110, 0b100]}, "probe_clauses_pack"),
}


@pytest.mark.parametrize("T", [1, 3, 16, 32])
@pytest.mark.parametrize("epilogue", list(PLAN_EPILOGUES))
def test_plan_on_cpu_banks_fills_each_launch_slice(T, epilogue):
    """``probe_plan_into`` on CPU banks: launch (first word, banks) lands
    its banks' words one after another from its first word, equal to each
    launch made as a plan of its own, to each bank's single-bank wrapper (the plain
    versions), to the JAX package's fused epilogue on each bank (Pallas in
    interpret mode) and to the JAX mesh's sharded wrapper over the banks
    side by side; the words no launch covers keep what they held."""
    import jax

    from bloomsearch_tpu.parallel import mesh as jm

    K = 3 if T < 32 else 2
    banks, rows, shifts = plan_banks(T * 7 + len(epilogue), T, K)
    tb = [torch.from_numpy(b.view(np.int32).copy()) for b in banks]
    extra_of, single = PLAN_EPILOGUES[epilogue]
    extra = extra_of(T)
    out_rows = {"pack": T, "reduce_and": 1}.get(epilogue, 3)
    plan = [(1, [tb[1], tb[0]]), (10, [tb[2]])]  # words 1-8 and 10-13 of 16
    out = torch.full((out_rows, 16), 0x5A5A5A5A, dtype=torch.int32)
    tk.reset_launch_counts()
    tk.probe_plan_into(out, plan, rows, shifts, T, K, epilogue, **extra)
    assert sum(tk.launch_counts().values()) == 0
    assert (out[:, [0, 9, 14, 15]] == 0x5A5A5A5A).all()
    got = torch.cat([out[:, 1:9], out[:, 10:14]], dim=1)
    by_launch = torch.full((out_rows, 16), 0x5A5A5A5A, dtype=torch.int32)
    for first, bs in plan:
        tk.probe_plan_into(by_launch, [(first, bs)], rows, shifts, T, K, epilogue, **extra)
    assert torch.equal(out, by_launch)
    order = [1, 0, 2]
    args = [extra.get("and_bits")] if epilogue == "reduce_and" else (
        [extra["clause_bits"], extra["member_bits"]] if epilogue == "clauses" else [])
    plain = torch.cat([getattr(tk, single)(tb[i], rows, shifts, T, K, *args) for i in order],
                      dim=1)
    assert torch.equal(got, plain)
    name = {"pack": "probe_and_pack", "reduce_and": "probe_reduce_and_pack"}.get(
        epilogue, "probe_clauses_pack")
    ref = np.concatenate([jax_epilogue(name, banks[i], rows, shifts, T, K, args) for i in order],
                         axis=-1)
    np.testing.assert_array_equal(words(got), ref.reshape(out_rows, -1))
    jmesh = jm.default_mesh(3)
    logical = np.concatenate([banks[i] for i in order], axis=1)
    jbank2d = jm.shard_bank(jmesh, logical)
    r, s = jnp.asarray(rows), jnp.asarray(shifts)
    common = dict(use_pallas=True, interpret=True)
    if epilogue == "pack":
        want = jm.sharded_probe_packed(jmesh, jbank2d, r, s, T, K, **common)
    elif epilogue == "reduce_and":
        mask = jnp.asarray([(args[0] >> t) & 1 for t in range(T)], dtype=bool)
        want = jm.sharded_query_step(jmesh, jbank2d, r, s, mask, T, K, **common)[0][None, :]
    else:
        cb, mb = args
        clause = jnp.asarray([[(b >> t) & 1 for t in range(T)] for b in cb], jnp.float32)
        member = jnp.asarray([[(b >> i) & 1 for i in range(len(cb))] for b in mb], jnp.float32)
        want = jm.sharded_probe_clauses(jmesh, jbank2d, r, s, clause, member, T, K, **common)
    np.testing.assert_array_equal(words(got), words(jax.device_get(want)))
    bits = np.unpackbits(words(got).view(np.uint8))
    assert bits.any() and not bits.all()


@pytest.mark.parametrize("bad", [
    "empty plan", "a launch of no banks", "too many shards", "mixed shapes", "mixed types",
    "first word below 0", "first word past the output", "too many clauses",
    "too many members", "wrong output rows", "unknown epilogue", "banks off the CPU and card",
])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    """Each of these raises ``ValueError`` before anything runs, and the
    output keeps every word (a pageable output for CUDA banks is refused
    by the card's test file, where a card can refuse it)."""
    bank = torch.zeros((16, 128), dtype=torch.int32)
    rows = np.zeros(4, np.int32)
    T, K, epilogue, extra, out_rows = 2, 2, "pack", {}, 2
    plan = [(0, [bank])]
    if bad == "empty plan":
        plan = []
    elif bad == "a launch of no banks":
        plan = [(0, [bank]), (4, [])]
    elif bad == "too many shards":
        plan = [(0, [bank] * (tk.MAX_SHARDS + 1))]
    elif bad == "mixed shapes":
        plan = [(0, [bank]), (4, [torch.zeros((8, 128), dtype=torch.int32)])]
    elif bad == "mixed types":
        plan = [(0, [bank, torch.zeros((16, 128), dtype=torch.int64)])]
    elif bad == "first word below 0":
        plan = [(-1, [bank])]
    elif bad == "first word past the output":
        plan = [(0, [bank]), (5, [bank])]
    elif bad == "too many clauses":
        epilogue, extra, out_rows = "clauses", {"clause_bits": [1] * 33, "member_bits": [1]}, 1
    elif bad == "too many members":
        epilogue, extra, out_rows = "clauses", {"clause_bits": [1], "member_bits": [1] * 33}, 33
    elif bad == "wrong output rows":
        out_rows = 3
    elif bad == "unknown epilogue":
        epilogue = "or"
    elif bad == "banks off the CPU and card":
        plan = [(0, [torch.zeros((16, 128), dtype=torch.int32, device="meta")])]
    out = torch.full((out_rows, 8), 7, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.probe_plan_into(out, plan, rows, rows, T, K, epilogue, **extra)
    assert (out == 7).all()

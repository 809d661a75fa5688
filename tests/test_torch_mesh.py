"""The port's mesh (K3) against the JAX package's, bit for bit.

The JAX side runs ``parallel/mesh.py`` over 2 and 4 of the conftest's
virtual CPU devices with the Pallas kernels in interpret mode; the port runs
its sharded wrappers over a 2- and 4-shard CPU mesh (the kernels' plain
versions). Both get the same numpy banks, probe arrays, clause masks,
stream chunks and needles. Tolerance: none — packed words, survivor totals,
logical contents, capacities and placements must be equal.
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu.rowcache as rc_ref  # noqa: E402
from bloomsearch_tpu.bloom import BloomParams  # noqa: E402
from bloomsearch_tpu.bloom import bank as jbank  # noqa: E402
from bloomsearch_tpu.bloom.probe import compile_bloom_terms, stack_filter_bank  # noqa: E402
from bloomsearch_tpu.file_format import BloomFilters  # noqa: E402
from bloomsearch_tpu.parallel import mesh as jm  # noqa: E402
from bloomsearch_tpu_torch.bloom import bank as tbank  # noqa: E402
from bloomsearch_tpu_torch.kernels import probe as pk  # noqa: E402
from bloomsearch_tpu_torch.kernels import scan as ks  # noqa: E402
from bloomsearch_tpu_torch.parallel import mesh as pm  # noqa: E402
from bloomsearch_tpu_torch.rowcache import rowcache_from_reference  # noqa: E402

from test_torch_rowcache import block_of  # noqa: E402

PARAMS = BloomParams(1000, 0.01)
MK = (PARAMS.m_bits, PARAMS.k, "classic")
T, K = 4, 7


def words(x) -> np.ndarray:
    """A packed result (JAX array or torch tensor) as uint32 words."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


def logical(x, axis: int) -> np.ndarray:
    """The port's sharded array joined in shard order, as numpy."""
    return torch.cat(list(x), dim=axis).numpy()


def meshes(n):
    return jm.default_mesh(n), pm.default_mesh(n, "cpu")


def random_probe_case(seed: int, n: int):
    """A bank with random words (bit 31 included) over 128·n + 37 logical
    columns (so the mesh pads), and T·K probes with shift 31 among them."""
    rng = np.random.default_rng(seed)
    rows = 3 * PARAMS.num_words
    bank = rng.integers(0, 2**32, size=(rows, 128 * n + 37), dtype=np.uint32)
    # Dense columns so multi-probe terms still match somewhere.
    bank[:, ::5] = 0xFFFFFFFF
    row_idx = rng.integers(0, rows, size=T * K).astype(np.int32)
    shift = rng.integers(0, 32, size=T * K).astype(np.int32)
    shift[0] = 31
    return bank, row_idx, shift


class TestMesh:
    def test_default_mesh_and_padding(self):
        assert pm.default_mesh(None, "cpu").size == 1
        mesh = pm.default_mesh(4, "cpu")
        assert mesh.shape == {pm.BLOCK_AXIS: 4} == dict(jm.default_mesh(4).shape)
        for c in (1, 127, 512, 513, 1000):
            assert pm.pad_columns_for_mesh(c, mesh) == jm.pad_columns_for_mesh(c, jm.default_mesh(4))
        packed = np.random.default_rng(0).integers(0, 2**32, size=(3, 5), dtype=np.uint32)
        np.testing.assert_array_equal(pm.unpack_bitmap(packed, 150), jm.unpack_bitmap(packed, 150))

    def test_no_card_cuda_mesh_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match="mesh_devices=2 but only 0"):
            pm.default_mesh(2, "cuda")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("epilogue", ["pack", "query_step", "clauses"])
def test_probe_wrappers_match_reference(n, epilogue):
    jmesh, tmesh = meshes(n)
    bank, row_idx, shift = random_probe_case(n, n)
    jbank2d = jm.shard_bank(jmesh, bank)
    tbank2d = pm.shard_bank(tmesh, bank)
    assert [s.shape for s in tbank2d] == [(bank.shape[0], 256)] * n
    common = dict(use_pallas=True, interpret=True)
    r, s = jnp.asarray(row_idx), jnp.asarray(shift)
    if epilogue == "pack":
        want = jm.sharded_probe_packed(jmesh, jbank2d, r, s, T, K, **common)
        got = pm.sharded_probe_packed(tmesh, tbank2d, row_idx, shift, T, K)
    elif epilogue == "query_step":
        mask = np.array([True, False, True, True])
        want, want_total = jm.sharded_query_step(
            jmesh, jbank2d, r, s, jnp.asarray(mask), T, K, **common
        )
        and_bits = int(sum(1 << t for t in range(T) if mask[t]))
        got, total = pm.sharded_query_step(tmesh, tbank2d, row_idx, shift, and_bits, T, K)
        assert total == int(want_total)
        assert total == int(np.unpackbits(words(got).view(np.uint8)).sum())
    else:
        rng = np.random.default_rng(n + 10)
        clause = (rng.random((5, T)) < 0.5).astype(np.float32)
        clause[:, 0] = 1.0
        member = np.array([[1, 1, 0, 0, 0], [0, 0, 1, 1, 1], [1, 0, 0, 0, 1]], np.float32)
        want = jm.sharded_probe_clauses(
            jmesh, jbank2d, r, s, jnp.asarray(clause), jnp.asarray(member), T, K, **common
        )
        clause_bits = [int(sum(1 << t for t in range(T) if row[t])) for row in clause]
        member_bits = [int(sum(1 << i for i in range(5) if row[i])) for row in member]
        got = pm.sharded_probe_clauses(
            tmesh, tbank2d, row_idx, shift, clause_bits, member_bits, T, K
        )
    np.testing.assert_array_equal(words(got), words(want))
    assert words(got).any() and not words(got).all()
    # The joined bitmap is the unsharded kernel's on the logical bank.
    flat = torch.from_numpy(np.ascontiguousarray(
        np.pad(bank, ((0, 0), (0, 256 * n - bank.shape[1])))).view(np.int32))
    rt, st = torch.from_numpy(row_idx), torch.from_numpy(shift)
    if epilogue == "pack":
        unsharded = pk.probe_and_pack(flat, rt, st, T, K)
    elif epilogue == "query_step":
        unsharded = pk.probe_reduce_and_pack(flat, rt, st, T, K, and_bits)[0]
    else:
        unsharded = pk.probe_clauses_pack(flat, rt, st, T, K, clause_bits, member_bits)
    np.testing.assert_array_equal(words(got), words(unsharded))


@pytest.mark.parametrize("epilogue", ["pack", "query_step", "clauses"])
def test_probe_wrappers_take_host_tensors_at_an_odd_term_count(epilogue):
    """On the 4-shard CPU mesh the probe arrays are host data given to every
    shard as they are: CPU tensors at T = 3 (no power-of-two padding) equal
    the JAX mesh's result, and a probe array on another device is refused."""
    n, t, k = 4, 3, 5
    jmesh, tmesh = meshes(n)
    rng = np.random.default_rng(77)
    bank = rng.integers(0, 2**32, size=(40, 128 * n + 9), dtype=np.uint32)
    bank[:, ::3] = 0xFFFFFFFF
    row_idx = rng.integers(0, 40, size=t * k).astype(np.int32)
    shift = rng.integers(0, 32, size=t * k).astype(np.int32)
    jbank2d, tbank2d = jm.shard_bank(jmesh, bank), pm.shard_bank(tmesh, bank)
    r, s = jnp.asarray(row_idx), jnp.asarray(shift)
    rt, st = torch.from_numpy(row_idx), torch.from_numpy(shift)
    common = dict(use_pallas=True, interpret=True)
    clause = np.array([[1, 1, 0], [0, 0, 1]], np.float32)
    member = np.array([[1, 1], [0, 1]], np.float32)
    calls = {
        "pack": (lambda rr, ss: pm.sharded_probe_packed(tmesh, tbank2d, rr, ss, t, k),
                 lambda: jm.sharded_probe_packed(jmesh, jbank2d, r, s, t, k, **common)),
        "query_step": (
            lambda rr, ss: pm.sharded_query_step(tmesh, tbank2d, rr, ss, 0b101, t, k)[0],
            lambda: jm.sharded_query_step(jmesh, jbank2d, r, s, jnp.asarray([True, False, True]),
                                          t, k, **common)[0]),
        "clauses": (
            lambda rr, ss: pm.sharded_probe_clauses(tmesh, tbank2d, rr, ss, [0b011, 0b100],
                                                    [0b11, 0b10], t, k),
            lambda: jm.sharded_probe_clauses(jmesh, jbank2d, r, s, jnp.asarray(clause),
                                             jnp.asarray(member), t, k, **common)),
    }
    port, ref = calls[epilogue]
    want = words(ref())
    np.testing.assert_array_equal(words(port(rt, st)), want)
    np.testing.assert_array_equal(words(port(row_idx, shift)), want)
    assert want.any() and not want.all()
    with pytest.raises(ValueError, match="host data"):
        port(rt.to("meta"), st)


def stand_in(device: str, shape: tuple):
    """What ``card_layout`` reads of a shard: its device and shape (CUDA
    devices need no card here)."""
    return types.SimpleNamespace(device=torch.device(device), shape=shape)


# (shard devices, axis, shard width, capacity) -> per device: (positions,
# first words, launches). Repeated and distinct devices, more shards than
# a launch's table holds (probe 8, scan 4), and devices that interleave.
LAYOUTS = [
    (["cuda:0"] * 4, 1, 128, 8, {"cuda:0": ((0, 1, 2, 3), (0, 4, 8, 12), ((0, 1, 2, 3),))}),
    ([f"cuda:{i}" for i in range(4)], 1, 128, 8,
     {f"cuda:{i}": ((i,), (4 * i,), ((i,),)) for i in range(4)}),
    (["cuda:0"] * 12, 1, 256, 8,
     {"cuda:0": (tuple(range(12)), tuple(range(0, 96, 8)),
                 (tuple(range(8)), tuple(range(8, 12))))}),
    (["cuda:0"] * 10, 0, 512, 4,
     {"cuda:0": (tuple(range(10)), tuple(range(0, 160, 16)),
                 ((0, 1, 2, 3), (4, 5, 6, 7), (8, 9)))}),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], 0, 900_096, 4,
     {"cuda:0": ((0, 1), (0, 28_128), ((0, 1),)),
      "cuda:1": ((2, 3), (56_256, 84_384), ((2, 3),))}),
    (["cuda:1", "cuda:0", "cuda:1", "cuda:0"], 1, 128, 8,
     {"cuda:1": ((0, 2), (0, 8), ((0,), (2,))), "cuda:0": ((1, 3), (4, 12), ((1,), (3,)))}),
    (["cpu"] * 8, 1, 128, 8, {"cpu": (tuple(range(8)), tuple(range(0, 32, 4)),
                                      (tuple(range(8)),))}),
]


@pytest.mark.parametrize("devices, axis, width, capacity, want", LAYOUTS)
def test_card_layout_groups_shards_by_card(devices, axis, width, capacity, want):
    shape = (7, width) if axis == 1 else (width, 128)
    shards = tuple(stand_in(d, shape) for d in devices)
    layout = pm.card_layout(shards, axis, capacity)
    assert [str(c.device) for c in layout] == list(want)  # first appearance, mesh order
    for card in layout:
        assert (card.shards, card.offsets, card.launches) == want[str(card.device)]
        assert all(len(run) <= capacity for run in card.launches)
    # Every word of the joined output belongs to exactly one launch.
    words = sorted(w for c in layout for i, off in zip(c.shards, c.offsets)
                   for w in range(off, off + width // 32))
    assert words == list(range(len(devices) * width // 32))


def test_card_layout_refuses_widths_off_the_word():
    with pytest.raises(ValueError, match="multiple of 32"):
        pm.card_layout((stand_in("cpu", (5, 48)),) * 2, 1, 8)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("epilogue", ["pack", "query_step", "clauses"])
def test_probe_wrappers_at_odd_term_counts_and_bit_31(n, epilogue):
    """2, 4 and 8 shards (the 8-shard mesh is one full launch table), T = 5
    (odd), shift 31 on words whose top bit is set: bit for bit the JAX
    mesh's words, the unsharded plain version's and, for the query step,
    its survivor total."""
    t, k = 5, 3
    jmesh, tmesh = meshes(n)
    rng = np.random.default_rng(100 + n)
    rows = 3 * PARAMS.num_words
    bank = rng.integers(0, 2**32, size=(rows, 128 * n - 19), dtype=np.uint32)
    bank[:, ::4] = 0xFFFFFFFF
    row_idx = rng.integers(0, rows, size=t * k).astype(np.int32)
    shift = rng.integers(0, 32, size=t * k).astype(np.int32)
    shift[::2] = 31
    bank[:, 1::7] |= np.uint32(1 << 31)
    jbank2d, tbank2d = jm.shard_bank(jmesh, bank), pm.shard_bank(tmesh, bank)
    assert len(tbank2d) == n and tbank2d[0].shape == (rows, 128)
    r, s = jnp.asarray(row_idx), jnp.asarray(shift)
    common = dict(use_pallas=True, interpret=True)
    flat = torch.from_numpy(np.ascontiguousarray(
        np.pad(bank, ((0, 0), (0, 128 * n - bank.shape[1])))).view(np.int32))
    if epilogue == "pack":
        want = jm.sharded_probe_packed(jmesh, jbank2d, r, s, t, k, **common)
        got = pm.sharded_probe_packed(tmesh, tbank2d, row_idx, shift, t, k)
        plain = pk.probe_and_pack(flat, row_idx, shift, t, k)
    elif epilogue == "query_step":
        mask = np.array([True, True, False, True, True])
        want, want_total = jm.sharded_query_step(jmesh, jbank2d, r, s, jnp.asarray(mask), t, k,
                                                 **common)
        got, total = pm.sharded_query_step(tmesh, tbank2d, row_idx, shift, 0b11011, t, k)
        plain = pk.probe_reduce_and_pack(flat, row_idx, shift, t, k, 0b11011)[0]
        assert total == int(want_total) == int(np.unpackbits(words(got).view(np.uint8)).sum())
        assert got.shape == (4 * n,)
    else:
        clause = np.array([[1, 0, 1, 0, 0], [0, 1, 0, 0, 1], [0, 0, 0, 1, 0]], np.float32)
        member = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
        want = jm.sharded_probe_clauses(jmesh, jbank2d, r, s, jnp.asarray(clause),
                                        jnp.asarray(member), t, k, **common)
        got = pm.sharded_probe_clauses(tmesh, tbank2d, row_idx, shift, [0b00101, 0b10010, 0b01000],
                                       [0b011, 0b101], t, k)
        plain = pk.probe_clauses_pack(flat, row_idx, shift, t, k, [0b00101, 0b10010, 0b01000],
                                      [0b011, 0b101])
    np.testing.assert_array_equal(words(got), words(want))
    np.testing.assert_array_equal(words(got), words(plain))
    bits = np.unpackbits(words(got).view(np.uint8))
    assert bits.any() and not bits.all()


@pytest.mark.parametrize("epilogue", ["pack", "reduce_and", "clauses"])
def test_more_shards_than_a_launch_holds(epilogue):
    """A 20-shard CPU mesh (three launches of at most 8 banks) joins to the
    unsharded plain version's words, and to the JAX 8-device mesh's on the
    columns both hold."""
    n, t, k = 20, 3, 4
    rng = np.random.default_rng(5)
    rows = 3 * PARAMS.num_words
    bank = rng.integers(0, 2**32, size=(rows, 128 * 8), dtype=np.uint32)
    bank[:, ::3] = 0xFFFFFFFF
    row_idx = rng.integers(0, rows, size=t * k).astype(np.int32)
    shift = rng.integers(0, 32, size=t * k).astype(np.int32)
    tmesh = pm.default_mesh(n, "cpu")
    tbank2d = pm.shard_bank(tmesh, bank)
    assert [len(c.launches) for c in pm.card_layout(tbank2d, 1, pk.MAX_SHARDS)] == [3]
    flat = torch.from_numpy(np.ascontiguousarray(
        np.pad(bank, ((0, 0), (0, 128 * n - bank.shape[1])))).view(np.int32))
    jmesh = jm.default_mesh(8)
    jbank2d = jm.shard_bank(jmesh, bank)
    r, s = jnp.asarray(row_idx), jnp.asarray(shift)
    common = dict(use_pallas=True, interpret=True)
    if epilogue == "pack":
        got = pm.sharded_probe_packed(tmesh, tbank2d, row_idx, shift, t, k)
        plain = pk.probe_and_pack(flat, row_idx, shift, t, k)
        ref = jm.sharded_probe_packed(jmesh, jbank2d, r, s, t, k, **common)
    elif epilogue == "reduce_and":
        got = pm.sharded_query_step(tmesh, tbank2d, row_idx, shift, 0b111, t, k)[0]
        plain = pk.probe_reduce_and_pack(flat, row_idx, shift, t, k, 0b111)[0]
        ref = jm.sharded_query_step(jmesh, jbank2d, r, s, jnp.ones(t, bool), t, k, **common)[0]
    else:
        got = pm.sharded_probe_clauses(tmesh, tbank2d, row_idx, shift, [0b011, 0b100], [0b11],
                                       t, k)
        plain = pk.probe_clauses_pack(flat, row_idx, shift, t, k, [0b011, 0b100], [0b11])
        ref = jm.sharded_probe_clauses(jmesh, jbank2d, r, s,
                                       jnp.asarray([[1, 1, 0], [0, 0, 1]], jnp.float32),
                                       jnp.asarray([[1, 1]], jnp.float32), t, k, **common)
    np.testing.assert_array_equal(words(got), words(plain))
    np.testing.assert_array_equal(words(got)[..., :32], words(ref))
    assert not words(got)[..., 32:].any()  # padding columns never match


def planted_chunks(G: int, needles, seed: int) -> np.ndarray:
    """Random chunks (bytes >= 0x80 included) with needle r planted on both
    sides of every 512-chunk shard boundary: at start 479 of chunk
    boundary-1-r (a hit), at start r of chunk boundary+r and at start 480
    of chunk boundary+8+r (that byte belongs to the next chunk's payload)."""
    rng = np.random.default_rng(seed)
    chunks = rng.integers(0, 256, size=(G, ks.CHUNK_BYTES), dtype=np.uint8)
    for r, nd in enumerate(needles):
        arr = np.frombuffer(nd, np.uint8)
        for boundary in range(512, G, 512):
            for g, start in ((boundary - 1 - r, 479), (boundary + r, r), (boundary + 8 + r, 480)):
                chunks[g, start : start + len(arr)] = arr
    return chunks


@pytest.mark.parametrize("n", [2, 4, 8])
def test_scan_wrapper_matches_reference(n):
    jmesh, tmesh = meshes(n)
    G = 512 * n
    needles = [b"\xc3\xa9t\xe9", b"needle", bytes(range(0x61, 0x61 + 31)), b"\xff" * 32]
    chunks = planted_chunks(G, needles, n)
    padded = np.zeros((8, ks.MAX_SCAN_WINDOW), np.int32)
    lens = np.zeros(8, np.int32)
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    rows32 = chunks.view(np.int32)
    jrows = jax.device_put(jnp.asarray(rows32), jm.rows_sharding(jmesh))
    want = jm.sharded_scan_all_rows(
        jmesh, jrows, jnp.asarray(padded), jnp.asarray(lens), n_real=6, max_words=9,
        stream_stride=ks.STREAM_STRIDE, interpret=True,
    )
    trows = pm.sharded_update_rows(tmesh, pm.sharded_zeros_rows(tmesh, G), rows32, 0)
    got = pm.sharded_scan_all_rows(tmesh, trows, padded, lens, n_real=6)
    np.testing.assert_array_equal(words(got), words(want))
    unsharded = ks.byte_scan_stream(
        torch.from_numpy(rows32.copy()), padded, lens, n_real=6
    )
    np.testing.assert_array_equal(words(got), words(unsharded))
    bits = pm.unpack_bitmap(words(got), G)
    for r in range(4):
        for boundary in range(512, G, 512):
            assert bits[r, boundary - 1 - r] and bits[r, boundary + r], (r, boundary)
    assert bits[4:].all()  # padding rows (length 0) match every chunk


def test_scan_wrapper_with_more_shards_than_a_launch_holds():
    """10 shards on the CPU (three launches of at most 4 ranges): matches at
    bytes 479 and 480 on each side of every shard boundary land as the
    unsharded plain scan's and the JAX 8-device mesh's on the chunks both
    hold."""
    n = 10
    tmesh = pm.default_mesh(n, "cpu")
    G = 512 * n
    needles = [b"\xe9t\xe9!", b"boundary", bytes(range(0x41, 0x41 + 32))]
    chunks = planted_chunks(G, needles, 11)
    padded = np.zeros((8, ks.MAX_SCAN_WINDOW), np.int32)  # the JAX kernel's 8 rows
    lens = np.zeros(8, np.int32)
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    rows32 = chunks.view(np.int32)
    trows = pm.sharded_update_rows(tmesh, pm.sharded_zeros_rows(tmesh, G), rows32, 0)
    assert [len(c.launches) for c in pm.card_layout(trows, 0, ks.MAX_SEGMENTS)] == [3]
    got = pm.sharded_scan_all_rows(tmesh, trows, padded, lens, n_real=3)
    unsharded = ks.byte_scan_stream(torch.from_numpy(rows32.copy()), padded, lens, n_real=3)
    np.testing.assert_array_equal(words(got), words(unsharded))
    jmesh = jm.default_mesh(8)
    head = rows32[: 512 * 8]
    jrows = jax.device_put(jnp.asarray(head), jm.rows_sharding(jmesh))
    want = jm.sharded_scan_all_rows(
        jmesh, jrows, jnp.asarray(padded), jnp.asarray(lens), n_real=3, max_words=9,
        stream_stride=ks.STREAM_STRIDE, interpret=True,
    )
    np.testing.assert_array_equal(words(got)[:, : 512 * 8 // 32], words(want))
    bits = pm.unpack_bitmap(words(got), G)
    for r in range(3):
        for boundary in range(512, G, 512):
            assert bits[r, boundary - 1 - r] and bits[r, boundary + r], (r, boundary)


@pytest.mark.parametrize("axis", ["columns", "rows"])
def test_helpers_match_reference_across_shard_boundaries(axis):
    """Zeros, a straddling update, growth (columns move to other shards)
    and a compaction whose runs cross shards, on a 4-way mesh."""
    jmesh, tmesh = meshes(4)
    rng = np.random.default_rng(7)
    if axis == "columns":
        other, size, grown = 6, 512, 1024
        chunk = rng.integers(0, 2**31, size=(other, 100), dtype=np.int64).astype(np.uint32)
        jz = jm.sharded_zeros(jmesh, other, size)
        tz = pm.sharded_zeros(tmesh, other, size)
        np.testing.assert_array_equal(words(logical(tz, 1)), words(jz))
        ju = jm.sharded_update_columns(jmesh, jz, jnp.asarray(chunk), jnp.int32(90))
        tu = pm.sharded_update_columns(tmesh, tz, chunk.view(np.int32), 90)
        jp = jm.sharded_pad_columns(jmesh, ju, grown)
        tp = pm.sharded_pad_columns(tmesh, tu, grown)
        idx = np.r_[np.arange(95, 140), np.arange(180, 190), np.arange(2, 4)]
        jt = jm.sharded_take_columns(jmesh, jp, jnp.asarray(idx.astype(np.int32)), 512)
        tt = pm.sharded_take_columns(tmesh, tp, idx, 512)
        dim = 1
    else:
        other, size, grown = 128, 2048, 4096
        chunk = rng.integers(-(2**31), 2**31, size=(100, other), dtype=np.int64).astype(np.int32)
        jz = jm.sharded_zeros_rows(jmesh, size, other, dtype=jnp.int32)
        tz = pm.sharded_zeros_rows(tmesh, size, other)
        np.testing.assert_array_equal(words(logical(tz, 0)), words(jz))
        ju = jm.sharded_update_rows(jmesh, jz, jnp.asarray(chunk), jnp.int32(470))
        tu = pm.sharded_update_rows(tmesh, tz, chunk, 470)
        jp = jm.sharded_pad_rows(jmesh, ju, grown)
        tp = pm.sharded_pad_rows(tmesh, tu, grown)
        idx = np.r_[np.arange(480, 540), np.arange(560, 570), np.arange(0, 3)]
        jt = jm.sharded_take_rows(jmesh, jp, jnp.asarray(idx.astype(np.int32)), 2048)
        tt = pm.sharded_take_rows(tmesh, tp, idx, 2048)
        dim = 0
    for j, t, n in ((ju, tu, size), (jp, tp, grown), (jt, tt, size)):
        assert len(t) == 4 and all(s.shape[dim] == n // 4 for s in t)
        np.testing.assert_array_equal(words(logical(t, dim)), words(j))
    assert tu is tz  # the update writes in place (slack only, by the callers)
    assert all(a is not b for a, b in zip(tp, tu))  # growth: new shards


def make_bank(per_block_keys):
    triples = []
    for field_keys, token_keys, ft_keys in per_block_keys:
        t = BloomFilters.from_params(PARAMS)
        t.field.add_keys(field_keys)
        t.token.add_keys(token_keys)
        t.field_token.add_keys(ft_keys)
        triples.append(t)
    return stack_filter_bank(triples)


def tagged(tag, n):
    return make_bank([([f"{tag}{i}"], [f"t{tag}{i}", "shared"], []) for i in range(n)])


def assert_same_superbank(ref, port, n):
    assert port.segments == ref.segments
    assert (port.capacity, port.used, port.dead) == (ref.capacity, ref.used, ref.dead)
    assert [s.shape[1] for s in port.bank2d] == [port.capacity // n] * n
    np.testing.assert_array_equal(
        words(logical(port.bank2d, 1)), np.asarray(ref.bank2d)[: port.num_rows]
    )


def test_superbank_on_a_mesh_matches_reference():
    """Capacities, placements and contents equal the JAX mesh's through
    straddling inserts, growth and compaction."""
    jmesh, tmesh = meshes(4)
    ref = jbank.Superbank(PARAMS.m_bits, PARAMS.k, "classic", jnp, jax, mesh=jmesh)
    port = tbank.Superbank(PARAMS.m_bits, PARAMS.k, "classic", "cpu", mesh=tmesh)
    steps = [("insert", b"a", tagged("a", 100)), ("insert", b"b", tagged("b", 130)),
             ("insert", b"c", tagged("c", 300)), ("remove", b"b", None),
             ("insert", b"d", tagged("d", 500)), ("remove", b"a", None),
             ("remove", b"c", None), ("compact", None, None), ("insert", b"e", tagged("e", 5))]
    for op, key, bank in steps:
        if op == "insert":
            assert port.insert(key, bank) == ref.insert(key, bank)
        elif op == "remove":
            port.remove(key)
            ref.remove(key)
        else:
            port.maybe_compact()
            ref.maybe_compact()
        assert_same_superbank(ref, port, 4)
    assert port.mesh.size == 4 and ref.capacity == port.capacity == 512


def probe_arrays(*tokens):
    q = bs.new_query()
    for t in tokens:
        q.token(t)
    terms = compile_bloom_terms(q.build().bloom)
    word_idx, bit_idx = terms.positions_for(PARAMS.m_bits, PARAMS.k)
    rows = (terms.ks_idx[:, None].astype(np.int32) * PARAMS.num_words + word_idx).reshape(-1)
    return terms, rows, bit_idx.reshape(-1).astype(np.int32)


def test_superbank_from_a_mesh_reference_probes_the_same():
    jmesh, _ = meshes(4)
    ref = jbank.Superbank(PARAMS.m_bits, PARAMS.k, "classic", jnp, jax, mesh=jmesh)
    for key, tag, n in ((b"x", "x", 140), (b"y", "y", 7), (b"z", "z", 300)):
        ref.insert(key, tagged(tag, n))
    ref.remove(b"y")
    port = tbank.superbank_from_reference(
        ref.bank2d, ref.segments, ref.m_bits, ref.k, ref.layout, "cpu"
    )
    assert port.mesh is not None and port.mesh.size == 4
    assert_same_superbank(ref, port, 4)
    terms, rows, shifts = probe_arrays("tz1", "shared")
    jback = jbank.DeviceProbeBackend(mesh_devices=4)
    tback = tbank.DeviceProbeBackend(device="cpu", mesh_devices=4)
    for reduce_and in (False, True):
        want = jback._probe_superbank_batched(
            ref.bank2d, ref.capacity, ref.k, rows, shifts, len(terms), reduce_and
        )
        got = tback._probe_superbank_batched(
            port.bank2d, port.capacity, port.k, rows, shifts, len(terms), reduce_and
        )
        np.testing.assert_array_equal(got, want)
    start, n = ref.segments[b"z"]
    assert got[0, start : start + n].tolist() == [False, True] + [False] * (n - 2)


def test_backend_on_a_mesh_matches_reference_and_warms_every_shard(monkeypatch):
    jback = jbank.DeviceProbeBackend(mesh_devices=4)
    tback = tbank.DeviceProbeBackend(device="cpu", mesh_devices=4)
    banks = {b"F1": tagged("p", 200), b"F2": tagged("q", 90)}
    requests = [(p, 0, MK, (lambda b=b: b)) for p, b in banks.items()]
    terms, _, _ = probe_arrays("tp150", "shared")
    for reduce_and in (False, True):
        want = jback.probe_groups(requests, terms, reduce_and=reduce_and)
        got = tback.probe_groups(requests, terms, reduce_and=reduce_and)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert tback.stats()["mesh_devices"] == jback.stats()["mesh_devices"] == 4
    assert tback.stats()["superbanks"].keys() == jback.stats()["superbanks"].keys()
    for name, entry in tback.stats()["superbanks"].items():
        assert entry["capacity"] == jback.stats()["superbanks"][name]["capacity"] == 512
    seen = []
    orig = pk.probe_plan_into
    monkeypatch.setattr(
        pk, "probe_plan_into",
        lambda out, plan, *a, **kw: seen.append(
            (a[-1], [(first, [b.shape for b in banks]) for first, banks in plan]))
        or orig(out, plan, *a, **kw),
    )
    assert tback.precompile_probe_programs() == 3
    # One plan call an epilogue, its one launch over the four CPU shards
    # (one device).
    assert sorted(e for e, _ in seen) == ["clauses", "pack", "reduce_and"]
    assert all(launches == [(0, [(3 * PARAMS.num_words, 128)] * 4)] for _, launches in seen)


def test_rowcache_from_a_mesh_reference_scans_the_same():
    ref = rc_ref.DeviceRowCache(64 << 20, mesh_devices=4)
    blocks = {}
    for b in range(3):
        data, offsets, lengths = block_of(
            [{"m": f"row {b}-{i} " + "pad" * (i % 40)} for i in range(300)]
        )
        blocks[(b"f", b)] = ref.pin((b"f", b), data, offsets, lengths)
    port = rowcache_from_reference(ref, "cpu")
    assert port.mesh is not None and port.mesh.size == 4
    assert port._bucket.cap == ref._bucket.cap and port._bucket.cap % 2048 == 0
    assert [s.shape[0] for s in port._bucket.matrix] == [port._bucket.cap // 4] * 4
    np.testing.assert_array_equal(logical(port._bucket.matrix, 0), np.asarray(ref._bucket.matrix))
    needles = [b"row 1-7 ", b"pad", b"absent"]
    want = ref.scan_many(list(blocks.values()), needles)
    got = port.scan_many([port.get(k) for k in blocks], needles)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert port.stats()["scan_launches"] == 1


# -- the sparse sharded scan ---------------------------------------------------

# (starts, counts, shard rows, shards) -> (pieces, range_base). Inside a
# shard, clamped at a shard's end, straddling one and two boundaries,
# ending at the stream's end, and a range over whole middle shards.
PIECE_CASES = {
    "inside_a_shard": (([100], [45], 512, 4), ([(0, 100, 64)], [0])),
    "clamped_at_a_shard_end": (([500], [10], 512, 4), ([(0, 480, 32)], [20])),
    "straddles_one_boundary": (([500], [30], 512, 2), ([(0, 480, 32), (1, 0, 32)], [20])),
    "straddles_two_boundaries": (([500], [600], 512, 4),
                                 ([(0, 480, 32), (1, 0, 512), (2, 0, 96)], [20])),
    "ends_at_the_stream_end": (([2008], [40], 512, 4), ([(3, 448, 64)], [24])),
    "straddles_into_the_stream_end": (([1500], [548], 512, 4),
                                      ([(2, 448, 64), (3, 0, 512)], [28])),
    "over_whole_middle_shards": (([100], [4000], 512, 10),
                                 ([(0, 96, 416)] + [(i, 0, 512) for i in range(1, 8)]
                                  + [(8, 0, 32)], [4])),
    "unaligned_boundary_start": (([511], [2], 512, 8), ([(0, 480, 32), (1, 0, 32)], [31])),
    "several_ranges": (([0, 500, 1030, 1530], [32, 30, 40, 518], 512, 4),
                       ([(0, 0, 32), (0, 480, 32), (1, 0, 32), (2, 6, 64), (2, 480, 32),
                         (3, 0, 512)], [0, 52, 96, 186])),
}


def output_map(pieces, shard_rows: int) -> np.ndarray:
    """The logical stream chunk behind every logical output chunk."""
    return np.concatenate([np.arange(i * shard_rows + r, i * shard_rows + r + n)
                           for i, r, n in pieces])


def assert_pieces_cover(starts, counts, shard_rows, n_shards, pieces, range_base):
    """Every piece lies in its shard, starts on an output word and reads a
    multiple of 32 rows; each range's requested chunks are one run of the
    output from its base."""
    for i, r, n in pieces:
        assert 0 <= i < n_shards and n > 0 and n % 32 == 0 and 0 <= r and r + n <= shard_rows
    where = output_map(pieces, shard_rows)
    for s, n, b in zip(starts, counts, range_base):
        np.testing.assert_array_equal(where[b : b + n], np.arange(s, s + n))
    # Nothing is read that rounding to 32 a piece does not ask for.
    assert len(where) < sum(counts) + 32 * len(pieces)


@pytest.mark.parametrize("case", sorted(PIECE_CASES))
def test_segment_pieces_cut_ranges_at_shard_boundaries(case):
    args, want = PIECE_CASES[case]
    got = pm.segment_pieces(*args)
    assert got == want
    assert_pieces_cover(*args, *got)


@pytest.mark.parametrize("n_shards", [2, 4, 8, 10, 16])
def test_segment_pieces_keep_random_ranges_whole(n_shards):
    """Random sorted ranges of 1 to 1.5 shards, some at the stream's ends,
    over shards of 64 to 512 rows."""
    rng = np.random.default_rng(n_shards)
    for shard_rows in (64, 96, 512):
        total = shard_rows * n_shards
        for _ in range(50):
            counts = rng.integers(1, shard_rows * 3 // 2, size=4)
            starts = rng.integers(0, total - counts + 1)
            starts[0], starts[-1] = 0, total - counts[-1]
            order = np.argsort(starts)
            starts, counts = starts[order].tolist(), counts[order].tolist()
            pieces, base = pm.segment_pieces(starts, counts, shard_rows, n_shards)
            assert_pieces_cover(starts, counts, shard_rows, n_shards, pieces, base)


@pytest.mark.parametrize("starts, counts, rows, shards", [
    ([0], [0], 512, 4),  # an empty range
    ([2040], [16], 512, 4),  # past the stream's end
    ([-1], [4], 512, 4),
    ([0], [4], 48, 4),  # shards off the 32-chunk tile
])
def test_segment_pieces_refuse_what_no_launch_takes(starts, counts, rows, shards):
    with pytest.raises(ValueError):
        pm.segment_pieces(starts, counts, rows, shards)


# (devices of the shards, pieces) -> the launches, as (device, [(first
# word, piece indices)]): one card's 7 pieces (two launches), distinct
# cards (only those with pieces), and devices that interleave.
LAUNCH_CASES = [
    (["cuda:0"] * 4, PIECE_CASES["several_ranges"][1][0] + [(3, 0, 32)],
     [("cuda:0", [(0, [0, 1, 2, 3]), (5, [4, 5, 6])])]),
    ([f"cuda:{i}" for i in range(4)], PIECE_CASES["straddles_two_boundaries"][1][0],
     [("cuda:0", [(0, [0])]), ("cuda:1", [(1, [1])]), ("cuda:2", [(17, [2])])]),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], PIECE_CASES["several_ranges"][1][0],
     [("cuda:0", [(0, [0, 1, 2])]), ("cuda:1", [(3, [3, 4, 5])])]),
    (["cuda:1", "cuda:0", "cuda:1", "cuda:0"], PIECE_CASES["several_ranges"][1][0],
     [("cuda:1", [(0, [0, 1]), (3, [3, 4])]), ("cuda:0", [(2, [2]), (6, [5])])]),
    (["cpu"] * 10, PIECE_CASES["over_whole_middle_shards"][1][0],
     [("cpu", [(0, [0, 1, 2, 3]), (61, [4, 5, 6, 7]), (125, [8])])]),
]


@pytest.mark.parametrize("devices, pieces, want", LAUNCH_CASES)
def test_piece_launches_group_pieces_by_card(devices, pieces, want):
    got = pm.piece_launches(pieces, [torch.device(d) for d in devices], ks.MAX_SEGMENTS)
    assert [(str(d), launches) for d, launches in got] == want
    for dev, launches in got:
        mine = sum(devices[i] == str(dev) for i, _, _ in pieces)
        assert len(launches) >= -(-mine // ks.MAX_SEGMENTS)
        assert all(len(idx) <= ks.MAX_SEGMENTS for _, idx in launches)
    # The launches' words tile the output in piece order.
    words = sorted((w, idx) for _, launches in got for w, idx in launches)
    at = 0
    for w, idx in words:
        assert w == at
        at += sum(pieces[i][2] for i in idx) // 32
    assert at == sum(n for _, _, n in pieces) // 32


def segment_ranges(n: int, shard_rows: int = 512) -> tuple[list[int], list[int]]:
    """Up to 4 sorted ranges on an n-shard stream: one straddling the first
    boundary (starting off the word), one inside a shard clamped at its
    end, one over two or three shards, and one ending at the stream's
    end."""
    G = n * shard_rows
    ranges = [(shard_rows - 37, 70)]
    if n >= 4:
        ranges.append((2 * shard_rows - 20, 19))  # inside shard 1, past its last word
        # Over shards 2 and 3, or 2 to 4 (the whole of 3) where there are 8 or more.
        ranges.append((2 * shard_rows + 3, (2 if n >= 8 else 1) * shard_rows + 100))
    ranges.append((G - 45, 45))
    ranges = sorted(set(ranges))[:4]
    return [s for s, _ in ranges], [c for _, c in ranges]


def bits_at(words: np.ndarray, firsts, counts) -> list[np.ndarray]:
    """Each range's bits bool[rows, count] from its first output chunk."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1, bitorder="little")
    return [bits[:, f : f + c].astype(bool) for f, c in zip(firsts, counts)]


@pytest.mark.parametrize("n", [2, 4, 8, 10])
def test_sharded_segments_match_unsharded_segments_and_reference(n, monkeypatch):
    """On n CPU shards: every requested chunk of ``sharded_scan_segments``
    equals ``byte_scan_segments`` on the unsharded stream, the dense scan
    and the JAX package's ``scan_segments`` (XLA and Pallas interpret),
    with matches at bytes 479 and 480 beside every shard boundary; one
    launch covers up to 4 pieces, and only the pieces are read."""
    from test_torch_scan import SCAN_SEGMENTS

    tmesh = pm.default_mesh(n, "cpu")
    G = 512 * n
    needles = [b"\xc3\xa9t\xe9", b"needle", bytes(range(0x61, 0x61 + 31)), b"\xff" * 32]
    chunks = planted_chunks(G, needles, 30 + n)
    padded = np.zeros((8, ks.MAX_SCAN_WINDOW), np.int32)  # the JAX kernel's 8 rows
    lens = np.zeros(8, np.int32)
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    rows32 = chunks.view(np.int32)
    trows = pm.sharded_update_rows(tmesh, pm.sharded_zeros_rows(tmesh, G), rows32, 0)
    starts, counts = segment_ranges(n)
    launched = []
    orig = pm.byte_scan_plan_into
    monkeypatch.setattr(pm, "byte_scan_plan_into", lambda out, plan, *a, **kw: (
        launched.extend((first, [(b.data_ptr(), s, c) for b, s, c in ranges])
                        for first, ranges in plan)
        or orig(out, plan, *a, **kw)))
    got, base = pm.sharded_scan_segments(tmesh, trows, starts, padded, lens, n_real=4,
                                         seg_chunks=counts)
    pieces, want_base = pm.segment_pieces(starts, counts, 512, n)
    assert base == want_base and got.shape == (4, sum(p[2] for p in pieces) // 32)
    # One launch a run of up to 4 pieces (all in one plan), reading exactly the pieces.
    assert len(launched) == -(-len(pieces) // ks.MAX_SEGMENTS)
    read = [r for _, ranges in launched for r in ranges]
    assert read == [(trows[i].data_ptr(), r, c) for i, r, c in pieces]
    flat = torch.from_numpy(rows32.copy())
    single = ks.byte_scan_segments(flat, starts, padded, lens, n_real=4,
                                   seg_chunks=counts).numpy()
    read_at, rounded = ks.segment_layout(starts, counts, G)
    single_base = [int(o) + s - r for o, s, r in zip(np.cumsum([0] + rounded[:-1]), starts,
                                                     read_at)]
    dense = ks.byte_scan_stream(flat, padded, lens, n_real=4).numpy()
    seg = max(512, 1 << (max(counts) - 1).bit_length())
    jax_starts = np.array(starts, np.int32)
    jax_base = [p * seg + s - min(s, G - seg) for p, s in enumerate(starts)]
    mine = bits_at(words(got), base, counts)
    for want in (bits_at(single.view(np.uint32), single_base, counts),
                 bits_at(dense.view(np.uint32), starts, counts)):
        for a, b in zip(mine, want):
            np.testing.assert_array_equal(a, b)
    for use_pallas in (False, True):
        ref = np.asarray(SCAN_SEGMENTS(
            jnp.asarray(rows32), jnp.asarray(jax_starts), jnp.asarray(padded), jnp.asarray(lens),
            n_real=4, max_words=9, seg_chunks=seg, use_pallas=use_pallas, interpret=use_pallas))
        for a, b in zip(mine, bits_at(ref, jax_base, counts)):
            np.testing.assert_array_equal(a, b)
    # The planted hits beside every boundary inside a requested range.
    logical = np.zeros((4, G), bool)
    for s, c, m in zip(starts, counts, mine):
        logical[:, s : s + c] = m
    seen = 0
    for r in range(4):
        for boundary in range(512, G, 512):
            for g in (boundary - 1 - r, boundary + r):
                if any(s <= g < s + c for s, c in zip(starts, counts)):
                    assert logical[r, g], (r, g)
                    seen += 1
    assert seen >= 4


def test_sharded_segments_count_only_cuda_launches():
    mesh = pm.default_mesh(4, "cpu")
    pm.reset_launch_counts()
    ks.reset_launch_counts()
    stream = pm.sharded_zeros_rows(mesh, 2048)
    needle = np.zeros((1, ks.MAX_SCAN_WINDOW), np.int32)
    out, base = pm.sharded_scan_segments(mesh, stream, [500], needle, np.ones(1, np.int32),
                                         n_real=1, seg_chunks=[30])
    assert base == [20] and out.shape == (1, 2) and not out.is_pinned()
    assert pm.launch_counts()["sharded_scan_segments"] == 0
    assert ks.launch_counts() == {"stream": 0, "segments": 0}


def test_ranges_into_a_wide_output_keep_other_words():
    """``byte_scan_ranges_into`` on CPU bases: each range's words land one
    after another from the first word; the words around them keep what
    they held; ranges off the tile or outside their base are refused."""
    rng = np.random.default_rng(4)
    bases = [torch.from_numpy(rng.integers(0, 256, size=(128, ks.CHUNK_BYTES), dtype=np.uint8)
                              .view(np.int32).copy()) for _ in range(2)]
    padded = np.zeros((2, ks.MAX_SCAN_WINDOW), np.int32)
    padded[0, :1], padded[1, :2] = [7], [7, 9]
    lens = np.array([1, 2], np.int32)
    out = torch.full((2, 9), 0x5A5A5A5A, dtype=torch.int32)
    ks.byte_scan_ranges_into(out, 2, [bases[1], bases[0], bases[1]], [32, 0, 96], [64, 32, 32],
                             padded, lens, n_real=2)
    want = torch.cat([ks.byte_scan_stream(b[s : s + c], padded, lens, n_real=2)
                      for b, s, c in ((bases[1], 32, 64), (bases[0], 0, 32), (bases[1], 96, 32))],
                     dim=1)
    assert torch.equal(out[:, 2:6], want)
    assert (out[:, :2] == 0x5A5A5A5A).all() and (out[:, 6:] == 0x5A5A5A5A).all()
    for st, ct in (([0], [48]), ([112], [32]), ([0] * 5, [32] * 5)):
        with pytest.raises(ValueError):
            ks.byte_scan_ranges_into(out, 0, [bases[0]] * len(st), st, ct, padded, lens,
                                     n_real=2)


def plan_spy(monkeypatch) -> list:
    """Record each ``byte_scan_plan_into`` call's plan and count_as."""
    calls = []
    orig = pm.byte_scan_plan_into

    def spy(out, plan, *a, count_as="segments", **kw):
        calls.append((plan, count_as))
        return orig(out, plan, *a, count_as=count_as, **kw)

    monkeypatch.setattr(pm, "byte_scan_plan_into", spy)
    return calls


def record_fields(rec) -> tuple:
    n = rec.n_ranges
    return (rec.device, n, rec.stream, list(rec.base[:n]), list(rec.start[:n]),
            list(rec.chunks[:n]), rec.rows_total, rec.first_word)


@pytest.mark.parametrize("n", [1, 2, 4, 10])
def test_sparse_plan_records_follow_the_pieces(n, monkeypatch):
    """The one call of ``sharded_scan_segments`` on n CPU shards (one: the
    single-device row cache's stream tensor, no mesh), ranges across
    boundaries included: its plan is ``piece_launches``' launches of
    ``segment_pieces``' pieces in order, and the C records built from it
    (``plan_records``) hold each piece's base pointer, first row and rows,
    the shard's rows, the launch's first word and the stream."""
    shard_rows = 512
    tmesh = pm.default_mesh(n, "cpu") if n > 1 else None
    stream = pm.sharded_zeros_rows(tmesh, shard_rows * n)
    shards = stream if n > 1 else (stream,)
    starts, counts = segment_ranges(n) if n > 1 else ([5, 300], [40, 212])
    needle = np.zeros((2, ks.MAX_SCAN_WINDOW), np.int32)
    calls = plan_spy(monkeypatch)
    out, base = pm.sharded_scan_segments(tmesh, stream, starts, needle, np.ones(2, np.int32),
                                         n_real=2, seg_chunks=counts)
    pieces, want_base = pm.segment_pieces(starts, counts, shard_rows, n)
    launches = [l for _, ls in pm.piece_launches(pieces, [s.device for s in shards],
                                                 ks.MAX_SEGMENTS) for l in ls]
    assert base == want_base and len(calls) == 1
    plan, count_as = calls[0]
    assert count_as == "segments" and len(plan) == len(launches)
    if n == 1:
        read, rounded = ks.segment_layout(starts, counts, shard_rows)
        assert [(r, c) for _, ranges in plan for _, r, c in ranges] == list(zip(read, rounded))
    records = ks.plan_records(plan, {torch.device("cpu"): 7})
    for rec, (first, ranges), (word, idx) in zip(records, plan, launches):
        assert first == word
        assert [(b.data_ptr(), r, c) for b, r, c in ranges] == [
            (shards[pieces[i][0]].data_ptr(), pieces[i][1], pieces[i][2]) for i in idx]
        assert record_fields(rec) == (
            -1, len(idx), 7, [shards[pieces[i][0]].data_ptr() for i in idx],
            [pieces[i][1] for i in idx], [pieces[i][2] for i in idx], shard_rows, word)
    assert out.shape == (2, sum(c for _, _, c in pieces) // 32) and out.all()  # 0-byte needles


@pytest.mark.parametrize("n", [1, 2, 4, 10])
def test_dense_plan_records_follow_the_card_layout(n, monkeypatch):
    """``sharded_scan_all_rows`` hands ``card_layout``'s launches (whole
    shards, up to 4 a launch) to one plan call counted as dense launches;
    the records hold every shard whole at its word offset, a launch of one
    shard as a dense-mode record (``n_ranges`` 0 over its base's rows)."""
    shard_rows = 512
    tmesh = pm.default_mesh(n, "cpu")
    stream = pm.sharded_zeros_rows(tmesh, shard_rows * n) if n > 1 else (
        pm.sharded_zeros_rows(None, shard_rows),)
    needle = np.zeros((1, ks.MAX_SCAN_WINDOW), np.int32)
    calls = plan_spy(monkeypatch)
    out = pm.sharded_scan_all_rows(tmesh, stream, needle, np.ones(1, np.int32), n_real=1)
    assert out.shape == (1, shard_rows * n // 32) and out.all()
    (plan, count_as), = calls
    runs = [run for card in pm.card_layout(stream, 0, ks.MAX_SEGMENTS) for run in card.launches]
    assert count_as == "stream" and len(plan) == len(runs) == -(-n // ks.MAX_SEGMENTS)
    for rec, run in zip(ks.plan_records(plan, {torch.device("cpu"): None}), runs):
        ranges = len(run) if len(run) > 1 else 0
        bases = [stream[i].data_ptr() for i in run][:ranges]
        assert record_fields(rec) == (-1, ranges, None, bases, [0] * ranges,
                                      [shard_rows] * ranges, shard_rows, run[0] * shard_rows // 32)
        assert rec.base[0] == stream[run[0]].data_ptr()


PROBE_WRAPPERS = {
    # wrapper: (its call on (mesh, bank2d, rows, shifts), epilogue, output rows)
    "sharded_probe_packed": (
        lambda m, b, r, s: pm.sharded_probe_packed(m, b, r, s, 3, 2), "pack", 3),
    "sharded_query_step": (
        lambda m, b, r, s: pm.sharded_query_step(m, b, r, s, 0b101, 3, 2)[0][None, :],
        "reduce_and", 1),
    "sharded_probe_clauses": (
        lambda m, b, r, s: pm.sharded_probe_clauses(m, b, r, s, [0b011, 0b100], [0b11, 0b10],
                                                    3, 2), "clauses", 2),
}


def probe_plan_spy(monkeypatch) -> list:
    """Record each ``probe_plan_into`` call's plan, epilogue and output."""
    calls = []
    orig = pk.probe_plan_into

    def spy(out, plan, *a, **kw):
        calls.append((plan, a[-1], out))
        return orig(out, plan, *a, **kw)

    monkeypatch.setattr(pk, "probe_plan_into", spy)
    return calls


def probe_record_fields(rec) -> tuple:
    n = rec.n_shards
    return (rec.device, n, rec.stream, list(rec.shards[:n]), rec.R, rec.C, rec.first_word)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 10])
@pytest.mark.parametrize("name", list(PROBE_WRAPPERS))
def test_probe_plan_records_follow_the_card_layout(n, name, monkeypatch):
    """Each probe wrapper on n CPU shards (one: a one-shard mesh) makes one
    ``probe_plan_into`` call whose plan is ``card_layout``'s launches in
    order, up to 8 shards a launch, each at its first shard's word offset;
    the C records built from it hold each launch's shard pointers, R, C,
    first word and stream; the joined words equal the plain version on the
    banks side by side."""
    call, epilogue, out_rows = PROBE_WRAPPERS[name]
    rng = np.random.default_rng(n)
    bank = rng.integers(0, 2**32, size=(12, 128 * n), dtype=np.uint32)
    bank[:, ::3] = 0xFFFFFFFF
    rows = rng.integers(0, 12, size=6).astype(np.int32)
    shifts = rng.integers(0, 32, size=6).astype(np.int32)
    tmesh = pm.default_mesh(n, "cpu")
    shards = bank2d = pm.shard_bank(tmesh, bank)
    assert isinstance(shards, tuple) and len(shards) == n
    calls = probe_plan_spy(monkeypatch)
    got = call(tmesh, bank2d, rows, shifts)
    (plan, called_as, out), = calls
    runs = [run for card in pm.card_layout(bank2d, 1, pk.MAX_SHARDS) for run in card.launches]
    assert called_as == epilogue and len(plan) == len(runs) == -(-n // pk.MAX_SHARDS)
    assert out.shape == (out_rows, 4 * n) and not out.is_pinned()
    for (first, banks), run in zip(plan, runs):
        assert first == 4 * run[0] and [b.data_ptr() for b in banks] == [
            shards[i].data_ptr() for i in run]
    for rec, run in zip(pk.plan_records(plan, {torch.device("cpu"): 9}), runs):
        assert probe_record_fields(rec) == (-1, len(run), 9, [shards[i].data_ptr() for i in run],
                                            12, 128, 4 * run[0])
    flat = torch.from_numpy(bank.view(np.int32))
    single = {"pack": lambda: pk.probe_and_pack(flat, rows, shifts, 3, 2),
              "reduce_and": lambda: pk.probe_reduce_and_pack(flat, rows, shifts, 3, 2, 0b101),
              "clauses": lambda: pk.probe_clauses_pack(flat, rows, shifts, 3, 2, [0b011, 0b100],
                                                       [0b11, 0b10])}[epilogue]
    assert torch.equal(got, single())


class StandInBank:
    """What ``probe_plan_into`` reads of a bank on a card: shape, type,
    device, contiguity and its address (no card needed)."""

    def __init__(self, device: str, address: int):
        self.device, self.address = torch.device(device), address
        self.shape, self.dtype = torch.Size((12, 128)), torch.int32

    def dim(self) -> int:
        return 2

    def is_contiguous(self) -> bool:
        return True

    def data_ptr(self) -> int:
        return self.address


def test_a_plan_that_fails_part_way_raises_and_counts_nothing(monkeypatch):
    """A probe wrapper over two cards whose plan call fails part-way (a
    stub library stands in for the C entry, which waits for every card it
    reached before it returns the error): the wrapper makes the one
    foreign call with both cards' records, raises the error, returns no
    buffer and counts no launch and no sharded call."""
    seen = []

    class Stub:
        def bs_probe_plan(self, rows, shifts, T, K, mode, and_bits, clauses, n_clauses, members,
                          n_members, records, n_launches, out, out_stride, on_host, stamps):
            seen.append(([(r.device, r.n_shards, r.first_word) for r in records[:n_launches]],
                         mode, and_bits, out_stride, on_host))
            return 700  # cudaErrorIllegalAddress on the second card

    real_empty = torch.empty
    pinned = []

    def empty(*shape, pin_memory=False, **kw):
        pinned.append(pin_memory)
        return real_empty(*shape, **kw)

    monkeypatch.setattr(pk, "library", lambda: Stub())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 100 + index,
                        raising=False)
    monkeypatch.setattr(pm.torch, "empty", empty)
    mesh = pm.Mesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    shards = (StandInBank("cuda:0", 0x1000), StandInBank("cuda:1", 0x2000))
    pm.reset_launch_counts()
    pk.reset_launch_counts()
    rows = np.zeros(3, np.int32)
    got = []
    with pytest.raises(RuntimeError, match="cudaError 700"):
        got.append(pm.sharded_query_step(mesh, shards, rows, rows, 0b111, 3, 1))
    assert not got and pinned == [True]
    assert seen == [([(0, 1, 0), (1, 1, 4)], pk.MODE_REDUCE, 0b111, 8, True)]
    assert sum(pk.launch_counts().values()) == 0
    assert pm.launch_counts() == dict.fromkeys(pm.launch_counts(), 0)

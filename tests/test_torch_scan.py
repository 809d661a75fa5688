"""The port's stream byte scan (K2, dense and segment modes) against the
JAX package's, bit for bit.

``byte_scan_plain`` (the wrappers' CPU path and the CUDA kernel's reference)
is held against the Pallas kernel ``byte_scan_pallas_swar`` in stream mode
(``stream_stride=480``, interpret mode), against the XLA sliding-window path
of ``rowcache._scan_matrix`` (``scan_all`` / ``scan_segments`` with
``use_pallas=False``) and against a bytes oracle. Tolerance: none, the
packed words must be equal.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bloomsearch_tpu.bloom.pallas_kernels import (  # noqa: E402
    byte_scan_pallas_swar,
    scan_word_bucket,
)
from bloomsearch_tpu.rowcache import _device_scan_fn  # noqa: E402
from bloomsearch_tpu_torch.kernels import scan as ks  # noqa: E402

STRIDE = ks.STREAM_STRIDE
LENGTH_GROUPS = [(1, 2, 3, 4, 5, 7, 8, 15), (31, 32, 6, 9, 16, 17, 24, 29)]


def pack_needles(needles, n_rows=8):
    padded = np.zeros((n_rows, ks.MAX_SCAN_WINDOW), dtype=np.int32)
    lens = np.zeros(n_rows, dtype=np.int32)
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    return padded, lens


def oracle(chunks: np.ndarray, needle: bytes) -> np.ndarray:
    """bool[G]: the needle starts at some byte < 480 of the chunk."""
    out = np.zeros(chunks.shape[0], dtype=bool)
    for g in range(chunks.shape[0]):
        pos = chunks[g].tobytes().find(needle)
        out[g] = 0 <= pos < STRIDE
    return out


def unpack(words, rows: int, G: int) -> np.ndarray:
    words = np.ascontiguousarray(np.asarray(words)).view(np.uint32)
    return np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")[:rows, :G].astype(bool)


def port_dense(chunks, padded, lens, n_real):
    rows32 = torch.from_numpy(chunks.view(np.int32).copy())
    return ks.byte_scan_stream(rows32, padded, lens, n_real=n_real).numpy()


def jax_words(lens, n_real) -> int:
    """The JAX kernel's word bucket for these needles (the port has none)."""
    return scan_word_bucket(int(np.asarray(lens)[:n_real].max()))


def jax_pallas(chunks, padded, lens, n_real, max_words):
    return np.asarray(byte_scan_pallas_swar(
        jnp.asarray(chunks.view(np.int32)), jnp.asarray(padded), jnp.asarray(lens),
        n_real=n_real, max_words=max_words, stream_stride=STRIDE, interpret=True,
    ))


SCAN_ALL, SCAN_SEGMENTS = _device_scan_fn(None)


def jax_xla(chunks, padded, lens, n_real, max_words):
    return np.asarray(SCAN_ALL(
        jnp.asarray(chunks.view(np.int32)), jnp.asarray(padded), jnp.asarray(lens),
        n_real=n_real, max_words=max_words, use_pallas=False, interpret=False,
    ))


def planted_stream(seed: int, needles, G: int = 512) -> np.ndarray:
    """Random bytes (>= 0x80 included) with each needle planted at every
    start alignment mod 4, at start 479 (hits) and at start 480 (belongs to
    the next chunk: must not hit)."""
    rng = np.random.default_rng(seed)
    chunks = rng.integers(0, 256, size=(G, ks.CHUNK_BYTES), dtype=np.uint8)
    for nd in needles:
        arr = np.frombuffer(nd, np.uint8)
        for a in range(4):
            g = int(rng.integers(0, G))
            s = int(rng.integers(0, STRIDE // 4 - 8)) * 4 + a
            chunks[g, s : s + len(nd)] = arr
        chunks[int(rng.integers(0, G)), STRIDE - 1 : STRIDE - 1 + len(nd)] = arr
        chunks[int(rng.integers(0, G)), STRIDE : STRIDE + len(nd)] = arr
    return chunks


@pytest.mark.parametrize("lengths", LENGTH_GROUPS)
def test_plain_matches_pallas_xla_and_oracle(lengths):
    rng = np.random.default_rng(sum(lengths))
    # Bytes >= 0x80 in every position of the needles and the stream.
    needles = [bytes(rng.integers(0x70, 256, size=ln, dtype=np.uint8)) for ln in lengths]
    chunks = planted_stream(len(lengths) + lengths[0], needles)
    padded, lens = pack_needles(needles)
    max_words = scan_word_bucket(max(lengths))
    got = port_dense(chunks, padded, lens, len(needles))
    assert got.dtype == np.int32 and got.shape == (len(needles), 512 // 32)
    np.testing.assert_array_equal(got.view(np.uint32), jax_pallas(chunks, padded, lens, len(needles), max_words))
    np.testing.assert_array_equal(got.view(np.uint32), jax_xla(chunks, padded, lens, len(needles), max_words))
    bits = unpack(got, len(needles), 512)
    for r, nd in enumerate(needles):
        np.testing.assert_array_equal(bits[r], oracle(chunks, nd), err_msg=repr(nd))


def test_valid_start_boundary():
    """A match starting at byte 479 hits; one starting at byte 480 belongs
    to the next chunk and must not (the JAX package's boundary case)."""
    rng = np.random.default_rng(23)
    chunks = rng.integers(97, 123, size=(512, ks.CHUNK_BYTES), dtype=np.uint8)
    nd = b"xyzzy-needle"
    arr = np.frombuffer(nd, np.uint8)
    chunks[3, STRIDE - 1 : STRIDE - 1 + len(nd)] = arr
    chunks[7, STRIDE : STRIDE + len(nd)] = arr
    chunks[11, : len(nd)] = arr
    padded, lens = pack_needles([nd])
    max_words = scan_word_bucket(len(nd))
    got = port_dense(chunks, padded, lens, 1)
    np.testing.assert_array_equal(got.view(np.uint32), jax_pallas(chunks, padded, lens, 1, max_words))
    expect = np.zeros(512, dtype=bool)
    expect[3] = expect[11] = True
    np.testing.assert_array_equal(unpack(got, 1, 512)[0], expect)


def test_padding_rows_match_every_chunk_and_leave_real_rows_alone():
    """Sparse launches run n_real = 8 with length-0 padding rows: those
    match every chunk, and the real rows equal a launch without them."""
    needles = [b"ab", b"\xff\xfe\x80"]
    chunks = planted_stream(5, needles)
    padded, lens = pack_needles(needles)
    full = port_dense(chunks, padded, lens, 8)
    np.testing.assert_array_equal(full.view(np.uint32), jax_pallas(chunks, padded, lens, 8, 2))
    np.testing.assert_array_equal(full.view(np.uint32), jax_xla(chunks, padded, lens, 8, 2))
    assert (full[2:] == -1).all()  # every bit set
    np.testing.assert_array_equal(full[:2], port_dense(chunks, padded[:2], lens[:2], 2))


@pytest.mark.parametrize("n_segs", [1, 2, 4])
def test_segments_match_jax_scan_segments(n_segs):
    """Segment mode, clamped starts included: a start past cap - seg_chunks
    reads from the clamped start, and a segment may end exactly at cap."""
    G, seg_chunks = 2048, 512
    needles = [b"seg", b"\x90needle", b"q"]
    chunks = planted_stream(40 + n_segs, needles, G=G)
    starts = np.array([G - seg_chunks, 1900, 0, 700][:n_segs], dtype=np.int32)
    padded, lens = pack_needles(needles)
    rows32 = torch.from_numpy(chunks.view(np.int32).copy())
    got = ks.byte_scan_segments(
        rows32, starts.tolist(), padded, lens, n_real=8, seg_chunks=seg_chunks
    ).numpy()
    assert got.shape == (8, n_segs * seg_chunks // 32)
    for use_pallas in (False, True):
        want = np.asarray(SCAN_SEGMENTS(
            jnp.asarray(chunks.view(np.int32)), jnp.asarray(starts), jnp.asarray(padded),
            jnp.asarray(lens), n_real=8, max_words=4, seg_chunks=seg_chunks,
            use_pallas=use_pallas, interpret=use_pallas,
        ))
        np.testing.assert_array_equal(got.view(np.uint32), want)
    clamped = [min(int(s), G - seg_chunks) for s in starts]
    sub = np.concatenate([chunks[s : s + seg_chunks] for s in clamped])
    bits = unpack(got, 3, n_segs * seg_chunks)
    for r, nd in enumerate(needles):
        np.testing.assert_array_equal(bits[r], oracle(sub, nd), err_msg=repr(nd))


@pytest.mark.parametrize(
    "bad",
    [
        dict(rows=(64, 64)),  # not 128 words a row
        dict(rows=(48, 128)),  # not a multiple of 32 rows
        dict(n_real=9),  # more than 8 needles
        dict(length=33),  # longer than the window
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rows = torch.zeros(bad.get("rows", (64, 128)), dtype=torch.int32)
    n_real = bad.get("n_real", 1)
    padded = np.zeros((max(n_real, 1), 32), np.int32)
    lens = np.zeros(max(n_real, 1), np.int32)
    lens[0] = bad.get("length", 3)
    with pytest.raises(ValueError):
        ks.byte_scan_stream(rows, padded, lens, n_real=n_real)


@pytest.mark.parametrize("length", range(1, ks.MAX_SCAN_WINDOW + 1))
def test_every_needle_length_needs_no_word_bucket(length):
    """The wrappers take no word bucket: a needle of every length from 1 to
    32 bytes, alone in its launch, gives the words of the JAX package's
    ``scan_all`` (called with its own bucket for that length) and of the
    bytes oracle, planted at every start alignment and at 479 / 480."""
    rng = np.random.default_rng(100 + length)
    nd = bytes(rng.integers(0x70, 256, size=length, dtype=np.uint8))
    chunks = planted_stream(200 + length, [nd], G=128)
    padded, lens = pack_needles([nd], n_rows=1)
    got = port_dense(chunks, padded, lens, 1)
    np.testing.assert_array_equal(got.view(np.uint32), jax_xla(chunks, padded, lens, 1,
                                                               jax_words(lens, 1)))
    np.testing.assert_array_equal(unpack(got, 1, 128)[0], oracle(chunks, nd))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ks.reset_launch_counts()
    chunks = planted_stream(1, [b"abc"], G=64)
    padded, lens = pack_needles([b"abc"])
    port_dense(chunks, padded, lens, 1)
    assert ks.launch_counts() == {"stream": 0, "segments": 0}
    assert ks.launch_shapes() == {}


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the scan kernel has no CPU form")
    dev = torch.device("cuda")
    for lengths in LENGTH_GROUPS:
        rng = np.random.default_rng(sum(lengths))
        needles = [bytes(rng.integers(0x70, 256, size=ln, dtype=np.uint8)) for ln in lengths]
        chunks = planted_stream(3, needles, G=2048)
        padded, lens = pack_needles(needles)
        rows32 = torch.from_numpy(chunks.view(np.int32).copy()).to(dev)
        for n_real in (1, 2, 4, 8):
            got = ks.byte_scan_stream(rows32, padded, lens, n_real=n_real)
            want = ks.byte_scan_plain(rows32, padded, lens, n_real)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (lengths, n_real)
        for n_segs in (1, 2, 4):
            starts = [2048 - 512, 1900, 0, 700][:n_segs]
            got = ks.byte_scan_segments(
                rows32, starts, padded, lens, n_real=8, seg_chunks=512)
            want = ks.byte_scan_plain(rows32, padded, lens, 8, starts, 512)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (lengths, n_segs)
        for case, ranges in RANGE_CASES.items():
            starts, counts = [s for s, _ in ranges], [n for _, n in ranges]
            got = ks.byte_scan_segments(
                rows32, starts, padded, lens, n_real=3, seg_chunks=counts)
            want = ks.byte_scan_plain(rows32, padded, lens, 3, starts, counts)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (lengths, case)


def jax_scan_all_bits(chunks, padded, lens, n_real) -> np.ndarray:
    """bool[n_real, G]: the JAX package's ``scan_all`` (XLA path) over the
    whole stream."""
    words = jax_xla(chunks, padded, lens, n_real, jax_words(lens, n_real))
    return unpack(words, n_real, chunks.shape[0])


RANGE_CASES = {
    # (first row, requested chunks) per range, over a 2048-chunk stream
    "unequal_unaligned": [(5, 45), (700, 100), (1203, 33), (64, 7)],
    "clamped_at_the_end": [(2030, 18), (1000, 64)],  # 2030 + 32 > 2048: reads from 2016
    "ends_at_the_end": [(2048 - 96, 96), (0, 1)],
    "one_range_rounded_up": [(321, 31)],
}


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_unequal_ranges_match_jax_scan_all_cut_at_the_ranges(case):
    """Segment mode over ranges of unequal, unaligned lengths: each range
    is rounded up to 32 chunks and clamped into the stream; its bits equal
    the JAX package's scan_all over the same stream cut at the range, the
    plain version over the cut rows, and (on the requested chunks) the
    bytes oracle."""
    G = 2048
    needles = [b"seg", b"\x90needle", b"q", b"\xff\xfe\x80\x81\x82"]
    chunks = planted_stream(60 + len(case), needles, G=G)
    padded, lens = pack_needles(needles, n_rows=len(needles))
    n_real = len(needles)
    rows32 = torch.from_numpy(chunks.view(np.int32).copy())
    starts = [s for s, _ in RANGE_CASES[case]]
    counts = [n for _, n in RANGE_CASES[case]]
    read, rounded = ks.segment_layout(starts, counts, G)
    assert rounded == [-(-n // 32) * 32 for n in counts]
    assert all(0 <= r <= s and r + n <= G for r, s, n in zip(read, starts, rounded))
    got = ks.byte_scan_segments(rows32, starts, padded, lens, n_real=n_real,
                                seg_chunks=counts).numpy()
    assert got.shape == (n_real, sum(rounded) // 32)
    bits = unpack(got, n_real, sum(rounded))
    full = jax_scan_all_bits(chunks, padded, lens, n_real)
    want = np.concatenate([full[:, r : r + n] for r, n in zip(read, rounded)], axis=1)
    np.testing.assert_array_equal(bits, want)
    cut = torch.cat([rows32[r : r + n] for r, n in zip(read, rounded)])
    np.testing.assert_array_equal(got, ks.byte_scan_plain(cut, padded, lens, n_real).numpy())
    offset = 0
    for s, n, r, rn in zip(starts, counts, read, rounded):
        first = offset + s - r  # where the requested chunks sit
        for row, nd in enumerate(needles):
            np.testing.assert_array_equal(
                bits[row, first : first + n], oracle(chunks[s : s + n], nd), err_msg=repr(nd))
        offset += rn


@pytest.mark.parametrize("odd", ["last", "first", "middle"])
@pytest.mark.parametrize("length", [5, 8, 31, 32])
def test_repeated_byte_stream_worst_case(length, odd):
    """A stream of one repeated byte and a needle of that byte with one
    other byte (last, first or in the middle): every start passes a filter
    on the needle's first or last 4 bytes and no chunk hits, except those
    where the needle was planted (one at start 479, one at 480 that must
    not hit). A needle of the byte alone hits every chunk."""
    G = 256
    chunks = np.full((G, ks.CHUNK_BYTES), ord("a"), dtype=np.uint8)
    at = {"last": length - 1, "first": 0, "middle": length // 2}[odd]
    near = b"a" * at + b"b" + b"a" * (length - 1 - at)
    for g, s in ((3, 0), (40, 201), (77, STRIDE - 1), (78, STRIDE)):
        chunks[g, s : s + length] = np.frombuffer(near, np.uint8)
    needles = [near, b"a" * length]
    padded, lens = pack_needles(needles, n_rows=2)
    got = port_dense(chunks, padded, lens, 2)
    bits = unpack(got, 2, G)
    np.testing.assert_array_equal(bits, jax_scan_all_bits(chunks, padded, lens, 2))
    assert bits[0].nonzero()[0].tolist() == [3, 40, 77]
    assert bits[1].all()
    for row, nd in enumerate(needles):
        np.testing.assert_array_equal(bits[row], oracle(chunks, nd))


@pytest.mark.parametrize(
    "starts, counts",
    [
        ([0] * 5, 32),  # more than 4 ranges
        ([0, 64], [32]),  # a count missing
        ([0], [0]),  # an empty range
        ([0], [65]),  # rounds to 96 > the 64-row stream
    ],
)
def test_segment_layout_rejects_what_the_kernel_does_not_take(starts, counts):
    rows = torch.zeros((64, 128), dtype=torch.int32)
    padded, lens = pack_needles([b"abc"], n_rows=1)
    with pytest.raises(ValueError):
        ks.byte_scan_segments(rows, starts, padded, lens, n_real=1, seg_chunks=counts)


# csrc/scan.cu's PlanLaunch, field by field: (name, offset, size).
PLAN_LAUNCH_LAYOUT = [("device", 0, 4), ("n_ranges", 4, 4), ("stream", 8, 8), ("base", 16, 32),
                      ("start", 48, 32), ("chunks", 80, 32), ("rows_total", 112, 8),
                      ("first_word", 120, 8)]


def test_plan_record_mirror_has_the_c_layout():
    """``PlanLaunch`` puts every field where the C record (and its
    ``static_assert``) has it, 128 bytes in all: a record off by a field
    would launch on the wrong pointers."""
    import ctypes

    got = [(name, getattr(ks.PlanLaunch, name).offset, getattr(ks.PlanLaunch, name).size)
           for name, _ in ks.PlanLaunch._fields_]
    assert got == PLAN_LAUNCH_LAYOUT
    assert ctypes.sizeof(ks.PlanLaunch) == 128


def test_plan_on_cpu_bases_fills_each_launch_slice():
    """``byte_scan_plan_into`` on CPU tensors: each launch's ranges land one
    after another from its first word, as the unsharded JAX scan over the
    same chunks gives them; the words no launch covers keep what they
    held."""
    rng = np.random.default_rng(6)
    chunks = rng.integers(0, 256, size=(3 * 128, ks.CHUNK_BYTES), dtype=np.uint8)
    chunks[200, 479 : 479 + 3] = np.frombuffer(b"pl\xe9", np.uint8)
    bases = [torch.from_numpy(chunks[i * 128 : (i + 1) * 128].view(np.int32).copy())
             for i in range(3)]
    padded, lens = pack_needles([b"pl\xe9", b"\x00\x01"], n_rows=2)
    plan = [(1, [(bases[1], 32, 64), (bases[0], 0, 32)]), (6, [(bases[2], 96, 32)])]
    out = torch.full((2, 9), 0x5A5A5A5A, dtype=torch.int32)
    ks.reset_launch_counts()
    ks.byte_scan_plan_into(out, plan, padded, lens, n_real=2)
    assert ks.launch_counts() == {"stream": 0, "segments": 0}
    logical = np.concatenate([chunks[128 + 32 : 128 + 96], chunks[0:32], chunks[352:384]])
    want = jax_scan_all_bits(logical, padded, lens, 2)
    bits = unpack(out[:, 1:5].numpy(), 2, 128)
    np.testing.assert_array_equal(bits[:, :96], want[:, :96])
    np.testing.assert_array_equal(unpack(out[:, 6:7].numpy(), 2, 32), want[:, 96:])
    assert bits[0, 200 - 160]  # the needle planted at byte 479
    assert (out[:, [0, 5, 7, 8]] == 0x5A5A5A5A).all()


@pytest.mark.parametrize("bad", ["empty", "five ranges", "off the tile", "past the base",
                                 "narrow output", "two shapes", "wrong rows"])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    base = torch.zeros((128, 128), dtype=torch.int32)
    padded, lens = pack_needles([b"abc"], n_rows=1)
    plan = {
        "empty": [],
        "five ranges": [(0, [(base, 0, 32)] * 5)],
        "off the tile": [(0, [(base, 0, 48)])],
        "past the base": [(0, [(base, 112, 32)])],
        "narrow output": [(3, [(base, 0, 64)])],
        "two shapes": [(0, [(base, 0, 32), (torch.zeros((64, 128), dtype=torch.int32), 0, 32)])],
        "wrong rows": [(0, [(base, 0, 32)])],
    }[bad]
    out = torch.zeros((2 if bad == "wrong rows" else 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ks.byte_scan_plan_into(out, plan, padded, lens, n_real=1)

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

from bloomsearch_tpu.bloom.pallas_kernels import byte_scan_pallas_swar  # noqa: E402
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


def port_dense(chunks, padded, lens, n_real, max_words):
    rows32 = torch.from_numpy(chunks.view(np.int32).copy())
    return ks.byte_scan_stream(rows32, padded, lens, n_real=n_real, max_words=max_words).numpy()


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
    max_words = ks.scan_word_bucket(max(lengths))
    got = port_dense(chunks, padded, lens, len(needles), max_words)
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
    max_words = ks.scan_word_bucket(len(nd))
    got = port_dense(chunks, padded, lens, 1, max_words)
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
    full = port_dense(chunks, padded, lens, 8, 2)
    np.testing.assert_array_equal(full.view(np.uint32), jax_pallas(chunks, padded, lens, 8, 2))
    np.testing.assert_array_equal(full.view(np.uint32), jax_xla(chunks, padded, lens, 8, 2))
    assert (full[2:] == -1).all()  # every bit set
    np.testing.assert_array_equal(full[:2], port_dense(chunks, padded[:2], lens[:2], 2, 2))


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
        rows32, starts.tolist(), padded, lens, n_real=8, max_words=4, seg_chunks=seg_chunks
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
        dict(length=20, max_words=2),  # longer than its word bucket
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rows = torch.zeros(bad.get("rows", (64, 128)), dtype=torch.int32)
    n_real = bad.get("n_real", 1)
    padded = np.zeros((max(n_real, 1), 32), np.int32)
    lens = np.zeros(max(n_real, 1), np.int32)
    lens[0] = bad.get("length", 3)
    with pytest.raises(ValueError):
        ks.byte_scan_stream(rows, padded, lens, n_real=n_real, max_words=bad.get("max_words", 9))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ks.reset_launch_counts()
    chunks = planted_stream(1, [b"abc"], G=64)
    padded, lens = pack_needles([b"abc"])
    port_dense(chunks, padded, lens, 1, 2)
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
            got = ks.byte_scan_stream(rows32, padded, lens, n_real=n_real, max_words=9)
            want = ks.byte_scan_plain(rows32, padded, lens, n_real)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (lengths, n_real)
        for n_segs in (1, 2, 4):
            starts = [2048 - 512, 1900, 0, 700][:n_segs]
            got = ks.byte_scan_segments(
                rows32, starts, padded, lens, n_real=8, max_words=9, seg_chunks=512)
            want = ks.byte_scan_plain(rows32, padded, lens, 8, starts, 512)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (lengths, n_segs)

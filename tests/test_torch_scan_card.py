"""The stream byte scan (K2) on the card in all its launches, against its
plain version and a numpy bytes oracle. No JAX: this file runs where the
JAX package cannot.

Dense mode, the one-card dense call through the plan entry at every
needle count, segment mode, ``byte_scan_ranges_into`` (ranges of one card's
shards into a wider output), the sparse sharded scan
``sharded_scan_segments`` (K3-e) on 4 and 10 shards of one card and on one
shard a card where two or more cards are visible, and the one foreign call
both sharded scans and the single-device sparse scan make
(``byte_scan_plan_into``, ``csrc/scan.cu``'s ``bs_scan_plan``): at K3-e's
and K3-d's main-path shapes against the unsharded kernels and the plain
version, from a fresh thread, from two threads at once, with the caller's
current device kept, a pageable output and a failure part-way through, and
a record of the wrong size refused at bind. Every case is exact: the
words equal the plain version's, and each needle's bits equal a byte
search of each chunk's 480 payload starts. Matches are planted at bytes
479 (a hit) and 480 (not one: the next chunk's payload) beside every
shard boundary. Every test is marked ``cuda`` and skips without a card. On
a machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_card.py

(``--noconftest``: the suite's conftest imports JAX to pin its platform.)
"""

import ctypes
import threading

import numpy as np
import pytest
import torch

from bloomsearch_tpu_torch.kernels import scan as ks
from bloomsearch_tpu_torch.parallel import mesh as pm

pytestmark = pytest.mark.cuda

NEEDLES = [b"\xc3\xa9t\xe9", b"bound", b"x", bytes(range(0x61, 0x61 + 32)), b"ab\xffcd\x80ef"]
MESHES = ["4 shards on one card", "10 shards on one card", "distinct cards"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the scan kernel has no CPU form")
    return torch.device("cuda", 0)


def mesh_of(kind: str, dev) -> pm.Mesh:
    if kind == "distinct cards":
        n = min(torch.cuda.device_count(), 4)
        if n < 2:
            pytest.skip("needs two or more cards")
        return pm.Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return pm.Mesh((dev,) * (4 if kind.startswith("4") else 10))


def planted(G: int, shard_rows: int, seed: int) -> np.ndarray:
    """Random chunks (bytes >= 0x80 included) with needle r planted at
    bytes 479 and 480 of chunks on each side of every shard boundary and
    at every alignment mod 4 somewhere."""
    rng = np.random.default_rng(seed)
    chunks = rng.integers(0, 256, size=(G, ks.CHUNK_BYTES), dtype=np.uint8)
    for r, nd in enumerate(NEEDLES):
        arr = np.frombuffer(nd, np.uint8)
        for boundary in range(shard_rows, G, shard_rows):
            for g, start in ((boundary - 1 - r, 479), (boundary + r, 479),
                             (boundary - 5 - r, 480), (boundary + 5 + r, 480)):
                chunks[g, start : start + len(arr)] = arr
        for a in range(4):
            chunks[int(rng.integers(0, G)), 4 * int(rng.integers(0, 100)) + a :][: len(arr)] = arr
    return chunks


def packed(n_real: int, n_rows: int | None = None,
           needles: list = NEEDLES) -> tuple[np.ndarray, np.ndarray]:
    """The first ``n_real`` needles as (int32[rows, 32], int32[rows]),
    padded with length-0 rows to ``n_rows``."""
    n_rows = n_rows or n_real
    padded = np.zeros((n_rows, ks.MAX_SCAN_WINDOW), np.int32)
    lens = np.zeros(n_rows, np.int32)
    for r, nd in enumerate(needles[:n_real]):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    return padded, lens


def oracle(chunks: np.ndarray, n_real: int, needles: list = NEEDLES) -> np.ndarray:
    """bool[n_real, G]: needle n at some start < 480 of chunk g."""
    return np.array([[bytes(c[: 479 + len(nd)]).find(nd) >= 0 for c in chunks]
                     for nd in needles[:n_real]])


def bits(words: torch.Tensor) -> np.ndarray:
    w = np.ascontiguousarray(words.cpu().numpy()).view(np.uint8)
    return np.unpackbits(w, axis=-1, bitorder="little").astype(bool)


def test_dense_mode_matches_plain_and_oracle(dev):
    G = 2048
    chunks = planted(G, 512, 1)
    rows32 = torch.from_numpy(chunks.view(np.int32).copy()).to(dev)
    want = oracle(chunks, len(NEEDLES))
    ks.reset_launch_counts()
    for n_real in (1, 2, len(NEEDLES)):
        padded, lens = packed(n_real, 8)
        got = ks.byte_scan_stream(rows32, padded, lens, n_real=8)
        plain = ks.byte_scan_plain(rows32, padded, lens, 8)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), n_real
        np.testing.assert_array_equal(bits(got)[:n_real], want[:n_real])
        assert bits(got)[n_real:].all()  # length-0 rows match every chunk
    assert ks.launch_counts() == {"stream": 3, "segments": 0}


EIGHT_NEEDLES = NEEDLES + [b"\x00\x01", b"tile", b"ring-end!"]


# 64 tiles, and 1,323: more tiles than the card's persistent blocks (two an
# SM), not a multiple of them or of the 4-tile ring, so blocks walk 5 or 6
# tiles and stop part-way round the ring.
@pytest.mark.parametrize("G", [2048, 32 * 1323])
def test_one_card_dense_plan_call_matches_the_dense_launch(dev, G):
    """The one-card row cache's dense call (``sharded_scan_all_rows`` with
    no mesh: one ``bs_scan_plan`` launch over the whole stream, a
    dense-mode record, into page-locked memory) gives dense mode's words
    (``byte_scan_stream``), the plain version's and the oracle's at every
    n_real from 1 to 8; it counts one dense "stream" launch and no mesh
    call."""
    chunks = planted(G, 512, 7)
    rows32 = torch.from_numpy(chunks.view(np.int32).copy()).to(dev)
    for n_real in range(1, ks.MAX_SCAN_NEEDLES + 1):
        padded, lens = packed(n_real, needles=EIGHT_NEEDLES)
        ks.reset_launch_counts()
        pm.reset_launch_counts()
        got = pm.sharded_scan_all_rows(None, rows32, padded, lens, n_real=n_real)
        assert got.device.type == "cpu" and got.is_pinned()
        assert ks.launch_shapes() == {("stream", G, n_real, 0, ()): 1}  # a dense record
        assert pm.launch_counts()["sharded_scan_all_rows"] == 0
        dense = ks.byte_scan_stream(rows32, padded, lens, n_real=n_real)
        plain = ks.byte_scan_plain(rows32, padded, lens, n_real)
        torch.cuda.synchronize()
        assert torch.equal(got, dense.cpu()) and torch.equal(dense, plain), n_real
        assert (bits(got)[:, :G] == oracle(chunks, n_real, EIGHT_NEEDLES)).all(), n_real
    ks.reset_launch_counts()


def test_a_dense_record_writes_its_whole_base_at_its_first_word(dev):
    """A plan launch of one range over a whole base is a dense-mode record
    (``n_ranges`` 0): in one plan with a two-range launch after it, its
    words land from its first word as dense mode's and the plain
    version's do, and the words outside both launches keep their value."""
    chunks = planted(1024, 512, 11)
    rows32 = torch.from_numpy(chunks.view(np.int32).copy()).to(dev)
    a, b = rows32[:512].clone(), rows32[512:].clone()
    padded, lens = packed(5)
    plan = [(3, [(a, 0, 512)]), (3 + 16, [(b, 256, 256), (b, 0, 256)])]
    records = ks.plan_records(plan, {dev: 0})
    assert [r.n_ranges for r in records] == [0, 2]
    out = torch.full((5, 3 + 32 + 2), 0x5A5A5A5A, dtype=torch.int32, pin_memory=True)
    ks.reset_launch_counts()
    ks.byte_scan_plan_into(out, plan, padded, lens, n_real=5, count_as="stream")
    assert ks.launch_shapes() == {("stream", 512, 5, 0, ()): 1,
                                  ("stream", 512, 5, 2, (256, 256)): 1}
    swapped = torch.cat([b[256:], b[:256]])
    want = torch.cat([ks.byte_scan_stream(a, padded, lens, n_real=5),
                      ks.byte_scan_plain(swapped, padded, lens, 5)], dim=1).cpu()
    assert torch.equal(out[:, 3:35], want)
    assert (out[:, :3] == 0x5A5A5A5A).all() and (out[:, 35:] == 0x5A5A5A5A).all()
    ks.reset_launch_counts()


@pytest.mark.parametrize("bad", ["null base", "rows off the tile", "no rows"])
def test_a_dense_record_refuses_what_the_kernel_does_not_take(dev, bad):
    """A dense-mode record with a null base, or rows that are not a
    positive multiple of 32, is refused before anything launches
    (cudaErrorInvalidValue, 1): the output keeps its words."""
    rows32 = torch.zeros((64, 128), dtype=torch.int32, device=dev)
    padded, lens = packed(1)
    needle_bytes, real_lens = ks._check(rows32, padded, lens, 1)
    records = ks.plan_records([(0, [(rows32, 0, 64)])], {dev: 0})
    assert records[0].n_ranges == 0
    if bad == "null base":
        records[0].base[0] = None
    else:
        records[0].rows_total = 48 if bad == "rows off the tile" else 0
    out = torch.full((1, 2), 7, dtype=torch.int32, pin_memory=True)
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        ks.plan_call(needle_bytes, real_lens, records, out)
    torch.cuda.synchronize()
    assert (out == 7).all()


def test_segment_mode_matches_plain_and_oracle(dev):
    """Ranges of unequal, unaligned lengths, one clamped at the stream's
    end and one ending there."""
    G = 2048
    chunks = planted(G, 512, 2)
    rows32 = torch.from_numpy(chunks.view(np.int32).copy()).to(dev)
    n_real = len(NEEDLES)
    padded, lens = packed(n_real)
    want = oracle(chunks, n_real)
    for starts, counts in (([5, 700, 1203, 2030], [45, 100, 33, 18]),
                           ([0, 2048 - 96], [1, 96]), ([321], [31])):
        ks.reset_launch_counts()
        got = ks.byte_scan_segments(rows32, starts, padded, lens, n_real=n_real,
                                    seg_chunks=counts)
        plain = ks.byte_scan_plain(rows32, padded, lens, n_real, starts, counts)
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
        assert ks.launch_counts() == {"stream": 0, "segments": 1}
        read, rounded = ks.segment_layout(starts, counts, G)
        at, b = 0, bits(got)
        for s, n, r, rn in zip(starts, counts, read, rounded):
            np.testing.assert_array_equal(b[:, at + s - r : at + s - r + n], want[:, s : s + n])
            at += rn


@pytest.mark.parametrize("host", [False, True])
def test_ranges_into_a_wide_output_keep_other_words(dev, host):
    """``byte_scan_ranges_into`` over ranges of three shards of one card,
    into a device or page-locked output wider than its words: the words
    land from the first word on, the others keep what they held."""
    shard_rows = 512
    chunks = planted(3 * shard_rows, shard_rows, 3)
    shards = [torch.from_numpy(chunks[i * shard_rows : (i + 1) * shard_rows].view(np.int32)
                               .copy()).to(dev) for i in range(3)]
    padded, lens = packed(3)
    starts, counts = [480, 0, 32, 256], [32, 64, 96, 256]
    bases = [shards[0], shards[1], shards[2], shards[2]]
    out = torch.full((3, 20), 0x5A5A5A5A, dtype=torch.int32)
    out = out.pin_memory() if host else out.to(dev)
    ks.reset_launch_counts()
    ks.byte_scan_ranges_into(out, 3, bases, starts, counts, padded, lens, n_real=3)
    torch.cuda.synchronize()
    assert ks.launch_counts() == {"stream": 0, "segments": 1}
    out = out.cpu()
    want = torch.cat([ks.byte_scan_plain(b[s : s + c], padded, lens, 3).cpu()
                      for b, s, c in zip(bases, starts, counts)], dim=1)
    assert torch.equal(out[:, 3:17], want)
    assert (out[:, :3] == 0x5A5A5A5A).all() and (out[:, 17:] == 0x5A5A5A5A).all()
    logical = [(0, 480, 32), (1, 0, 64), (2, 32, 96), (2, 256, 256)]
    oracle_bits = np.concatenate(
        [oracle(chunks[i * shard_rows + s : i * shard_rows + s + c], 3) for i, s, c in logical],
        axis=1)
    np.testing.assert_array_equal(bits(out[:, 3:17]), oracle_bits)


def test_pageable_output_is_refused(dev):
    """A host output the card cannot address raises before a launch."""
    stream = torch.zeros((64, 128), dtype=torch.int32, device=dev)
    padded, lens = packed(1)
    ks.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError"):
        ks.byte_scan_ranges_into(torch.zeros((1, 2), dtype=torch.int32), 0, [stream], [0], [64],
                                 padded, lens, n_real=1)
    assert ks.launch_counts() == {"stream": 0, "segments": 0}


def sharded_ranges(n: int, shard_rows: int) -> tuple[list[int], list[int]]:
    """Sorted ranges: across the first boundary (off the word), inside
    shard 1 clamped at its end and over two or more shards (where there
    are 4 shards or more), and one ending at the stream's end."""
    G = n * shard_rows
    if n < 4:
        return [shard_rows - 37, G - 45], [70, 45]
    span = (2 if n >= 8 else 1) * shard_rows + 100
    ranges = [(shard_rows - 37, 70), (2 * shard_rows - 20, 19), (2 * shard_rows + 3, span),
              (G - 45, 45)]
    return [s for s, _ in ranges], [c for _, c in ranges]


@pytest.mark.parametrize("kind", MESHES)
def test_sharded_segments_match_the_unsharded_launch(dev, kind):
    """``sharded_scan_segments`` equals, at every requested chunk, the
    unsharded segment launch, the plain version and the oracle; it makes
    ceil(pieces / 4) launches on each card that holds a piece and none on
    the others, and one call in the mesh counter."""
    mesh = mesh_of(kind, dev)
    shard_rows = 1024 if mesh.size <= 4 else 512
    G = mesh.size * shard_rows
    chunks = planted(G, shard_rows, mesh.size)
    stream = pm.sharded_update_rows(
        mesh, pm.sharded_zeros_rows(mesh, G, device=dev), chunks.view(np.int32), 0)
    n_real = len(NEEDLES)
    padded, lens = packed(n_real)
    starts, counts = sharded_ranges(mesh.size, shard_rows)
    pieces, want_base = pm.segment_pieces(starts, counts, shard_rows, mesh.size)
    plan = pm.piece_launches(pieces, mesh.devices, ks.MAX_SEGMENTS)
    ks.reset_launch_counts()
    pm.reset_launch_counts()
    got, base = pm.sharded_scan_segments(mesh, stream, starts, padded, lens, n_real=n_real,
                                         seg_chunks=counts)
    assert ks.launch_counts() == {"stream": 0, "segments": sum(len(ls) for _, ls in plan)}
    assert pm.launch_counts()["sharded_scan_segments"] == 1
    for device, launches in plan:
        mine = sum(mesh.devices[i] == device for i, _, _ in pieces)
        assert len(launches) == -(-mine // ks.MAX_SEGMENTS), device
    held = {mesh.devices[i] for i, _, _ in pieces}
    assert {d for d, _ in plan} == held
    assert base == want_base and got.is_pinned()
    assert got.shape == (n_real, sum(n for _, _, n in pieces) // 32)
    flat = torch.from_numpy(chunks.view(np.int32).copy()).to(dev)
    single = ks.byte_scan_segments(flat, starts, padded, lens, n_real=n_real,
                                   seg_chunks=counts)
    read, rounded = ks.segment_layout(starts, counts, G)
    single_base = np.cumsum([0] + rounded[:-1]) + np.array(starts) - np.array(read)
    by_pieces = torch.cat([ks.byte_scan_plain(stream[i][r : r + n], padded, lens, n_real).cpu()
                           for i, r, n in pieces], dim=1)
    assert torch.equal(got, by_pieces)
    want = oracle(chunks, n_real)
    mine, theirs = bits(got), bits(single)
    for s, n, b, sb in zip(starts, counts, base, single_base):
        np.testing.assert_array_equal(mine[:, b : b + n], theirs[:, sb : sb + n])
        np.testing.assert_array_equal(mine[:, b : b + n], want[:, s : s + n])
    # The planted hits beside the boundaries inside the ranges.
    hit = 0
    for r in range(n_real):
        for boundary in range(shard_rows, G, shard_rows):
            g = boundary - 1 - r
            for s, n, b in zip(starts, counts, base):
                if s <= g < s + n:
                    assert mine[r, b + g - s], (r, g)
                    hit += 1
    assert hit > 0


@pytest.mark.parametrize("kind", ["4 shards on one card", "one stream tensor"])
def test_a_fresh_thread_launches_the_sparse_sharded_scan(dev, kind):
    """The engine calls the wrapper from its worker threads: a thread with
    no CUDA context yet gets the same words as the main thread, on a mesh
    and as the single-device row cache calls it (no mesh)."""
    mesh = mesh_of("4 shards on one card", dev)
    G = 4 * 512
    chunks = planted(G, 512, 9)
    stream = pm.sharded_update_rows(
        mesh, pm.sharded_zeros_rows(mesh, G, device=dev), chunks.view(np.int32), 0)
    if kind == "one stream tensor":
        mesh, stream = None, torch.from_numpy(chunks.view(np.int32).copy()).to(dev)
    padded, lens = packed(3)
    starts, counts = sharded_ranges(4, 512)

    def run():
        return pm.sharded_scan_segments(mesh, stream, starts, padded, lens, n_real=3,
                                        seg_chunks=counts)

    want = run()
    got: list = []
    worker = threading.Thread(target=lambda: got.append(run()))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and len(got) == 1
    assert torch.equal(got[0][0], want[0]) and got[0][1] == want[1]


# -- the plan entry (bs_scan_plan) ---------------------------------------------

REFSCALE_SHARD = 900_096  # the refscale stream (3,600,384 chunks) over 4 shards
BLOCK = 15_307  # chunks of a refscale block
EIGHT = NEEDLES + [b"ab", b"\x00\x00", b"zq\x80"]


def packed_of(needles: list) -> tuple[np.ndarray, np.ndarray]:
    padded = np.zeros((len(needles), ks.MAX_SCAN_WINDOW), np.int32)
    lens = np.zeros(len(needles), np.int32)
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    return padded, lens


def random_stream(devices, shard_rows: int, seed: int) -> tuple:
    """Random stream shards, one on each of ``devices``, made on the card."""
    gens = {d: torch.Generator(device=d).manual_seed(seed) for d in dict.fromkeys(devices)}
    return tuple(torch.randint(-(2**31), 2**31, (shard_rows, 128), generator=gens[d], device=d,
                               dtype=torch.int64).to(torch.int32) for d in devices)


def main_path_ranges(shard_rows: int, n_shards: int) -> list[int]:
    """Three ranges of a block: across the first boundary, inside shard 1,
    ending at the stream's end (the smoke's main-path shape)."""
    return [shard_rows - BLOCK // 2 - 5, shard_rows + shard_rows // 3, shard_rows * n_shards - BLOCK]


@pytest.mark.parametrize("kind", ["4 shards on one card", "distinct cards"])
def test_plan_matches_the_unsharded_kernels_at_the_main_path_shapes(dev, kind):
    """At refscale shard widths, 1 and 8 needles: the dense sharded scan
    (K3-d, one plan launch a card) equals the unsharded dense launch, the
    sparse sharded scan (K3-e) and the single-device sparse call (no mesh)
    equal the unsharded segment launch at every requested chunk, and all
    of them the plain version (over windows of the dense scan)."""
    mesh = mesh_of(kind, dev)
    stream = random_stream(mesh.devices, REFSCALE_SHARD, 5)
    flat = torch.cat([s.to(dev) for s in stream])
    G = flat.shape[0]
    starts, counts = main_path_ranges(REFSCALE_SHARD, mesh.size), [BLOCK] * 3
    layout = pm.card_layout(stream, 0, ks.MAX_SEGMENTS)
    for n_real in (1, 8):
        padded, lens = packed_of(EIGHT[:n_real])
        kw = dict(n_real=n_real)
        ks.reset_launch_counts()
        dense = pm.sharded_scan_all_rows(mesh, stream, padded, lens, **kw)
        assert ks.launch_counts() == {"stream": sum(len(c.launches) for c in layout),
                                      "segments": 0}
        want = ks.byte_scan_stream(flat, padded, lens, **kw).cpu()
        assert dense.is_pinned() and torch.equal(dense, want), n_real
        for lo in (0, REFSCALE_SHARD - 16_384, G - 32_768):
            plain = ks.byte_scan_plain(flat[lo : lo + 32_768], padded, lens, n_real).cpu()
            assert torch.equal(dense[:, lo // 32 : lo // 32 + 1024], plain), (n_real, lo)
        ks.reset_launch_counts()
        got, base = pm.sharded_scan_segments(mesh, stream, starts, padded, lens,
                                             seg_chunks=counts, **kw)
        pieces, _ = pm.segment_pieces(starts, counts, REFSCALE_SHARD, mesh.size)
        launches = pm.piece_launches(pieces, mesh.devices, ks.MAX_SEGMENTS)
        assert ks.launch_counts()["segments"] == sum(len(ls) for _, ls in launches)
        one, one_base = pm.sharded_scan_segments(None, flat, starts, padded, lens,
                                                 seg_chunks=counts, **kw)
        single = ks.byte_scan_segments(flat, starts, padded, lens, seg_chunks=counts, **kw)
        plain = ks.byte_scan_plain(flat, padded, lens, n_real, starts, counts)
        assert torch.equal(one, single.cpu()) and torch.equal(one, plain.cpu()), n_real
        read, rounded = ks.segment_layout(starts, counts, G)
        assert one_base == [int(o) + s - r for o, s, r in
                            zip(np.cumsum([0] + rounded[:-1]), starts, read)]
        mine, theirs = bits(got), bits(one)
        for s, n, b, ob in zip(starts, counts, base, one_base):
            np.testing.assert_array_equal(mine[:, b : b + n], theirs[:, ob : ob + n])


def test_two_threads_call_the_plan_at_once(dev):
    """Two query threads scanning at once, each with its own ranges and
    needles, 100 calls each: every answer equals the one the main thread
    got alone (each thread waits on its own event)."""
    mesh = mesh_of("4 shards on one card", dev)
    stream = random_stream(mesh.devices, 65_536, 8)
    cases = [(main_path_ranges(65_536, 4), [BLOCK] * 3, packed_of(EIGHT[:8])),
             ([100, 3 * 65_536 + 7], [40_000, 9_000], packed_of(EIGHT[2:5]))]

    def run(case):
        starts, counts, (padded, lens) = case
        return pm.sharded_scan_segments(mesh, stream, starts, padded, lens,
                                        n_real=len(lens), seg_chunks=counts)

    want = [run(c) for c in cases]
    barrier = threading.Barrier(2)
    got: list = [[], []]

    def worker(i):
        barrier.wait()
        for _ in range(100):
            got[i].append(run(cases[i]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for i in range(2):
        assert len(got[i]) == 100
        assert all(torch.equal(w, want[i][0]) and b == want[i][1] for w, b in got[i]), i


def test_the_callers_current_device_is_unchanged(dev):
    """Each plan call sets the device of each card it launches on, and
    gives the caller back the device it had: on one card and, where
    several are visible, from each card's thread state over a mesh of
    distinct cards."""
    n = min(torch.cuda.device_count(), 4)
    meshes = [mesh_of("4 shards on one card", dev)]
    if n >= 2:
        meshes.append(mesh_of("distinct cards", dev))
    streams = [random_stream(m.devices, 4096, 2) for m in meshes]
    padded, lens = packed_of(EIGHT[:3])
    try:
        for current in range(n):
            torch.cuda.set_device(current)
            for mesh, stream in zip(meshes, streams):
                pm.sharded_scan_segments(mesh, stream, [4000], padded, lens, n_real=3,
                                         seg_chunks=[200])
                assert torch.cuda.current_device() == current
                pm.sharded_scan_all_rows(mesh, stream, padded, lens, n_real=3)
                assert torch.cuda.current_device() == current
    finally:
        torch.cuda.set_device(dev)


def test_pageable_output_is_refused_by_the_plan(dev):
    """A plan into memory that is not page-locked raises before anything
    is launched: its words stay as they were."""
    stream = torch.zeros((64, 128), dtype=torch.int32, device=dev)
    padded, lens = packed(1)
    out = torch.full((1, 2), 7, dtype=torch.int32)
    ks.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError"):
        ks.byte_scan_plan_into(out, [(0, [(stream, 0, 64)])], padded, lens, n_real=1)
    torch.cuda.synchronize()
    assert (out == 7).all() and ks.launch_counts() == {"stream": 0, "segments": 0}


def test_a_failure_part_way_waits_for_the_cards_that_launched(dev):
    """A plan whose second launch names a card index the record takes but
    no machine has: the call raises that error only once the first launch
    (8 needles over a refscale stream, over a millisecond of device time)
    has finished, so its words are all there when the call returns, the
    caller's current device is kept, and the next call runs."""
    mesh = mesh_of("4 shards on one card", dev)
    stream = random_stream(mesh.devices, REFSCALE_SHARD, 4)
    padded, lens = packed_of(EIGHT)
    want = pm.sharded_scan_all_rows(mesh, stream, padded, lens, n_real=8)
    needle_bytes, real_lens = ks._check(stream[0], padded, lens, 8)
    out = torch.full(tuple(want.shape), 0x5A5A5A5A, dtype=torch.int32).pin_memory()
    plan = [(0, [(s, 0, REFSCALE_SHARD) for s in stream]), (0, [(stream[0], 0, 32)])]
    records = ks.plan_records(plan, {dev: torch.cuda.current_stream(dev).cuda_stream})
    records[1].device = 63  # below csrc/scan.cu's MAX_DEVICES (64)
    records[1].stream = None
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="cudaError 101"):  # cudaErrorInvalidDevice
        ks.plan_call(needle_bytes, real_lens, records, out)
    assert torch.equal(out, want)
    assert torch.cuda.current_device() == dev.index
    # The error is not left as the thread's last error, which the next
    # launch's check would report: the next plan call runs.
    assert torch.equal(pm.sharded_scan_all_rows(mesh, stream, padded, lens, n_real=8), want)


def test_a_record_size_mismatch_is_refused_at_bind(dev, monkeypatch):
    """A ``PlanLaunch`` mirror of another size than the library's record
    is refused when the library is bound, before any launch."""
    ks.library()

    class Padded(ctypes.Structure):
        _fields_ = ks.PlanLaunch._fields_ + [("extra", ctypes.c_int64)]

    monkeypatch.setattr(ks, "PlanLaunch", Padded)
    monkeypatch.setattr(ks, "_lib", None)
    with pytest.raises(RuntimeError, match="plan record is 128 bytes"):
        ks.library()

"""Block-axis sharding over several devices (K3): the mesh, its maintenance
helpers and the five sharded kernel wrappers.

The JAX package shards the superbank's block axis (``P(None, "blocks")``)
and the serving stream's chunk axis (``P("blocks", None)``) over a 1-D
``jax.sharding.Mesh``, runs the probe or scan kernel on each shard inside
``shard_map``, and lets XLA all-gather the packed bitmaps over ICI. Here a
:class:`Mesh` is an ordered tuple of torch devices along the one axis
``BLOCK_AXIS``, and a sharded array is a tuple of tensors, one per mesh
position: shard i of a bank ``[R, C]`` holds logical columns
``[i*C/n, (i+1)*C/n)`` on ``mesh.devices[i]``; shard i of a stream
``[G, 128]`` holds logical rows ``[i*G/n, (i+1)*G/n)``. A device may repeat
in a mesh built by hand (several shards on one card); every shard is still
its own tensor. With ``mesh=None`` every helper works on one plain tensor,
the single-device layout.

The sharded wrappers group the shards by card (``card_layout``) and make
one launch a card over all of its shards (``csrc/probe.cu`` in the
epilogue's mode with a table of shard pointers, or ``csrc/scan.cu`` in
segment mode with a range a shard), every card's launch issued before any
is waited for. The sparse scan (``sharded_scan_segments``) reads just the
requested chunk ranges: each is cut into pieces that lie in one shard
(``segment_pieces``), and only the cards that hold a piece launch, one
segment-mode launch over up to 4 of a card's pieces, each read in place.
Each launch stores its words straight into one joined bitmap, a
page-locked host buffer taken per call from torch's pinned allocator, at
the word offset of its first shard or piece. Every wrapper hands all its
launches to one foreign call that issues every card's launches and waits
for them (``kernels/probe.py::probe_plan_into``,
``kernels/scan.py::byte_scan_plan_into``). Both scans also take
``mesh=None`` with one plain tensor: the single-device calls, one launch
through the same entry. That bitmap is
bit-for-bit the unsharded kernel's output because every shard is a
contiguous range whose width is a multiple of 32
(128·n columns, 512·n chunks); the sparse scan's is the single-device
sparse layout, each range's requested chunks one run of it. The probe
arrays and needles are host arrays that travel in each launch's
parameters, so nothing is copied to the cards first. The mesh is one
process driving every device, so no ``torch.distributed`` collective is
needed: the survivor total that the reference ``psum``s is one popcount
of the joined words. On CPU shards the same layout runs the plain versions
shard by shard (or piece by piece) into the same slices of the joined
output (``kernels/probe.py``, ``kernels/scan.py``).

The maintenance helpers keep both axes sharded through growth, inserts and
compaction, which the reference left to XLA's implicit re-split: a column
(or row) moves to another shard when the capacity changes, and an insert's
or a pin's range may straddle a shard boundary, so every copy walks the
intersections of the source and destination layouts. ``pad`` and ``take``
allocate new shard tensors; ``update`` writes in place (the callers write
only slack past ``used``, the snapshot rule of ``bloom/bank.py``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..kernels.probe import MAX_SHARDS, probe_plan
from ..kernels.scan import CHUNK_BYTES, MAX_SEGMENTS, TILE_CHUNKS, byte_scan_plan_into

BLOCK_AXIS = "blocks"
LANE = 128  # bank columns per shard unit (the JAX package's lane tile)

Sharded = Union[torch.Tensor, tuple]  # one tensor (mesh None) or one per shard


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of torch devices along ``BLOCK_AXIS``."""

    devices: tuple

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict:
        return {BLOCK_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> list:
        return list(dict.fromkeys(self.devices))


def visible_devices(device) -> int:
    """Devices of ``device``'s type this process can see (the CPU counts as
    one)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh over the block axis (the data-parallel dimension).

    On ``cuda``: the first ``n_devices`` cards (every visible card when
    None); fewer visible raises. On ``cpu``: ``n_devices`` shards on the
    CPU, which stand in for the JAX tests' virtual CPU devices."""
    dev = torch.device(device)
    if dev.type == "cuda":
        n_visible = visible_devices(dev)
        want = n_visible if n_devices is None else n_devices
        if want < 1 or want > n_visible:
            raise RuntimeError(
                f"mesh_devices={want} but only {n_visible} device(s) visible"
            )
        return Mesh(tuple(torch.device("cuda", i) for i in range(want)))
    if dev.type != "cpu":
        raise ValueError(f"no mesh on {dev.type} devices")
    return Mesh((torch.device("cpu"),) * (n_devices or 1))


def mesh_for(mesh_devices: Optional[int], device) -> Optional[Mesh]:
    """The engine's rule for ``mesh_devices`` on ``device`` (the JAX
    package's): None is every visible device of the type when there is
    more than one, n > 1 is an n-device mesh, 1 (or one visible) is no
    mesh. More cards than are visible raises (``default_mesh``): a mesh
    never shrinks."""
    want = visible_devices(device) if mesh_devices is None else mesh_devices
    return default_mesh(want, device) if want > 1 else None


def pad_columns_for_mesh(c: int, mesh: Mesh) -> int:
    """Columns must split evenly into 128-column shards."""
    unit = LANE * mesh.shape[BLOCK_AXIS]
    return ((c + unit - 1) // unit) * unit


# -- layouts and copies ------------------------------------------------------


def _shards(x: Sharded) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _width(shards: tuple, axis: int) -> int:
    return int(shards[0].shape[axis])


def logical_size(x: Sharded, axis: int) -> int:
    """The logical length of ``x`` along its sharded ``axis``."""
    shards = _shards(x)
    return _width(shards, axis) * len(shards)


def _copy_range(src: tuple, dst: tuple, axis: int, src_start: int,
                dst_start: int, n: int) -> None:
    """Copy logical ``src[src_start : src_start+n]`` to ``dst[dst_start :
    dst_start+n]`` along ``axis``, one slice copy per intersection of the
    two layouts (``copy_`` moves between devices)."""
    sw, dw = _width(src, axis), _width(dst, axis)
    pos = 0
    while pos < n:
        s, d = src_start + pos, dst_start + pos
        si, di = s // sw, d // dw
        k = min(n - pos, (si + 1) * sw - s, (di + 1) * dw - d)
        s0, d0 = s - si * sw, d - di * dw
        dst[di].narrow(axis, d0, k).copy_(src[si].narrow(axis, s0, k))
        pos += k


def _runs(idx: np.ndarray) -> list[tuple[int, int, int]]:
    """Consecutive runs of ``idx`` -> [(source start, length, destination
    start)]."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    if idx.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) != 1) + 1
    starts = np.concatenate([[0], breaks])
    ends = np.concatenate([breaks, [idx.size]])
    return [(int(idx[a]), int(b - a), int(a)) for a, b in zip(starts, ends)]


def _zeros(mesh: Optional[Mesh], shape: tuple, axis: int, dtype, device) -> Sharded:
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    n = mesh.size
    if shape[axis] % n:
        raise ValueError(f"{shape[axis]} does not split into {n} shards")
    local = list(shape)
    local[axis] //= n
    return tuple(torch.zeros(local, dtype=dtype, device=d) for d in mesh.devices)


def _pad(mesh, x: Sharded, new_size: int, axis: int) -> Sharded:
    src = _shards(x)
    shape = list(src[0].shape)
    shape[axis] = new_size
    out = _zeros(mesh, tuple(shape), axis, src[0].dtype, src[0].device)
    _copy_range(src, _shards(out), axis, 0, 0, logical_size(x, axis))
    return out


def _update(x: Sharded, chunk, start: int, axis: int) -> Sharded:
    """Write ``chunk`` (a tensor on any device, or a numpy array) at
    logical ``start`` in place; returns ``x``."""
    if isinstance(chunk, np.ndarray):
        if not chunk.flags.writeable:  # torch cannot wrap read-only memory
            chunk = chunk.copy()
        chunk = torch.from_numpy(np.ascontiguousarray(chunk))
    n = int(chunk.shape[axis])
    if start < 0 or start + n > logical_size(x, axis):
        raise ValueError(f"update [{start}, {start + n}) outside {logical_size(x, axis)}")
    _copy_range((chunk,), _shards(x), axis, 0, start, n)
    return x


def _take(mesh, x: Sharded, idx: np.ndarray, new_size: int, axis: int) -> Sharded:
    src = _shards(x)
    shape = list(src[0].shape)
    shape[axis] = new_size
    out = _zeros(mesh, tuple(shape), axis, src[0].dtype, src[0].device)
    for s, n, d in _runs(idx):
        _copy_range(src, _shards(out), axis, s, d, n)
    return out


# --- Sharding-preserving superbank maintenance ops --------------------------
#
# Bank layout int32[rows, C], block axis (columns) sharded. None are on the
# query hot path: they run once per flush, merge or growth.


def sharded_zeros(mesh: Optional[Mesh], rows: int, cols: int, device=None) -> Sharded:
    """int32[rows, cols] of zeros (``device`` only when ``mesh`` is None)."""
    return _zeros(mesh, (rows, cols), 1, torch.int32, device)


def sharded_pad_columns(mesh: Optional[Mesh], bank: Sharded, new_cols: int) -> Sharded:
    return _pad(mesh, bank, new_cols, 1)


def sharded_update_columns(mesh: Optional[Mesh], bank: Sharded, chunk, start: int) -> Sharded:
    return _update(bank, chunk, start, 1)


def sharded_take_columns(mesh: Optional[Mesh], bank: Sharded, idx, new_cols: int) -> Sharded:
    return _take(mesh, bank, idx, new_cols, 1)


def shard_bank(mesh: Mesh, bank2d) -> tuple:
    """Place a bank ``[rows, C]`` (a host uint32/int32 array or a tensor on
    any device) onto the mesh, block axis sharded; pads C to 128 columns
    per shard."""
    if isinstance(bank2d, np.ndarray):
        bank2d = torch.from_numpy(
            np.ascontiguousarray(bank2d, dtype=np.uint32).view(np.int32)
        )
    rows, c = bank2d.shape
    out = sharded_zeros(mesh, rows, pad_columns_for_mesh(c, mesh))
    return sharded_update_columns(mesh, out, bank2d, 0)


def unpack_bitmap(packed: np.ndarray, num_cols: int) -> np.ndarray:
    """uint32[..., C/32] -> bool[..., num_cols]."""
    bits = np.unpackbits(
        np.ascontiguousarray(packed).view(np.uint8), axis=-1, bitorder="little"
    )
    return bits[..., :num_cols].astype(bool)


# --- Row-axis variants (serving row cache) -----------------------------------
#
# Stream layout int32[rows, 128] (packed 512-byte chunks), chunk axis (rows)
# sharded.


def sharded_zeros_rows(mesh: Optional[Mesh], rows: int, cols: int = CHUNK_BYTES // 4,
                       dtype=torch.int32, device=None) -> Sharded:
    return _zeros(mesh, (rows, cols), 0, dtype, device)


def sharded_pad_rows(mesh: Optional[Mesh], mat: Sharded, new_rows: int) -> Sharded:
    return _pad(mesh, mat, new_rows, 0)


def sharded_update_rows(mesh: Optional[Mesh], mat: Sharded, chunk, start: int) -> Sharded:
    """In place, where the reference's donated variant aliased: callers
    write only rows no published segment covers (rowcache.py)."""
    return _update(mat, chunk, start, 0)


def sharded_take_rows(mesh: Optional[Mesh], mat: Sharded, idx, new_rows: int) -> Sharded:
    return _take(mesh, mat, idx, new_rows, 0)


# --- The K3 wrappers ---------------------------------------------------------

_count_lock = threading.Lock()
_launches = {
    "sharded_probe_packed": 0,
    "sharded_query_step": 0,
    "sharded_probe_clauses": 0,
    "sharded_scan_all_rows": 0,
    "sharded_scan_segments": 0,
}


def launch_counts() -> dict[str, int]:
    """Sharded calls that launched their kernel on CUDA shards since the
    last reset (each card's launch also counts in its kernel module)."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def _count(name: str, shards: tuple) -> None:
    if any(s.device.type == "cuda" for s in shards):
        with _count_lock:
            _launches[name] += 1


@dataclasses.dataclass(frozen=True)
class CardShards:
    """One device's part of a sharded call: its shards (mesh positions, in
    mesh order), each shard's first word in the joined output, and the
    launches that cover them (runs of consecutive positions, at most the
    kernel's table capacity each)."""

    device: torch.device
    shards: tuple
    offsets: tuple
    launches: tuple


def card_layout(x: Sharded, axis: int, capacity: int) -> list[CardShards]:
    """Group ``x``'s shards by the device they lie on, in the order the
    devices first appear (``Mesh.distinct_devices`` for shards placed on a
    mesh). Shard i's words start at ``i * width/32`` of the joined output
    (``width``: a shard's length along ``axis``, a multiple of 32); a
    launch covers up to ``capacity`` shards that are neighbours in the mesh,
    so its words are one run of the output."""
    shards = _shards(x)
    width = _width(shards, axis)
    if width % 32:
        raise ValueError(f"a shard's width {width} is not a multiple of 32")
    groups: dict = {}
    for i, s in enumerate(shards):
        groups.setdefault(s.device, []).append(i)
    out = []
    for dev, positions in groups.items():
        runs: list[list[int]] = []
        for i in positions:
            if runs and runs[-1][-1] == i - 1 and len(runs[-1]) < capacity:
                runs[-1].append(i)
            else:
                runs.append([i])
        out.append(CardShards(dev, tuple(positions), tuple(i * (width // 32) for i in positions),
                              tuple(tuple(r) for r in runs)))
    return out


def probe_launches(bank2d: Sharded) -> list:
    """The probe wrappers' plan for ``probe_plan_into``: every launch of
    ``card_layout``, card by card, as (its first shard's word offset, its
    shards)."""
    shards = _shards(bank2d)
    return [(card.offsets[card.shards.index(run[0])], [shards[i] for i in run])
            for card in card_layout(shards, 1, MAX_SHARDS) for run in card.launches]


# Each probe epilogue's sharded wrapper, the name its calls count under.
PROBE_WRAPPERS = {"pack": "sharded_probe_packed", "reduce_and": "sharded_query_step",
                  "clauses": "sharded_probe_clauses"}


def sharded_probe(mesh: Mesh, bank2d: Sharded, row_idx, shift, T: int, K: int, epilogue: str,
                  **extra) -> torch.Tensor:
    """The probe with an epilogue of ``kernels.probe.EPILOGUE_MODES`` (its
    arguments in ``extra`` as ``probe_plan_into`` takes them) on every
    shard -> the joined int32[T or 1 or M, C/32] bitmap on the host: every
    launch of ``probe_launches`` in one ``probe_plan`` call, into
    page-locked host memory on cards, counted under the epilogue's wrapper
    (``PROBE_WRAPPERS``). The three wrappers below are this call in the
    reference's signatures."""
    out = probe_plan(probe_launches(bank2d), logical_size(bank2d, 1) // 32, row_idx, shift, T,
                     K, epilogue, **extra)
    _count(PROBE_WRAPPERS[epilogue], _shards(bank2d))
    return out


def sharded_probe_packed(mesh: Mesh, bank2d: Sharded, row_idx, shift, T: int,
                         K: int) -> torch.Tensor:
    """Probe every shard's blocks -> packed int32[T, C/32] on the host."""
    return sharded_probe(mesh, bank2d, row_idx, shift, T, K, "pack")


def sharded_query_step(mesh: Mesh, bank2d: Sharded, row_idx, shift, and_bits: int,
                       T: int, K: int) -> tuple[torch.Tensor, int]:
    """The flat-AND query step: probe, AND over the terms in ``and_bits``
    (terms outside it count as true) and the survivor total.

    Returns (packed survivors int32[C/32] on the host, total survivors):
    the total is one popcount of the joined words, the reference's
    ``psum``."""
    out = sharded_probe(mesh, bank2d, row_idx, shift, T, K, "reduce_and", and_bits=and_bits)
    total = int.from_bytes(out.numpy().tobytes(), "little").bit_count()
    return out[0], total


def sharded_probe_clauses(mesh: Mesh, bank2d: Sharded, row_idx, shift,
                          clause_bits: Sequence[int], member_bits: Sequence[int],
                          T: int, K: int) -> torch.Tensor:
    """Probe and the fused CNF epilogue on every shard -> packed
    int32[M, C/32] on the host (bit masks as in ``probe_clauses_pack``)."""
    return sharded_probe(mesh, bank2d, row_idx, shift, T, K, "clauses",
                         clause_bits=clause_bits, member_bits=member_bits)


def sharded_scan_all_rows(mesh: Optional[Mesh], rows32: Sharded, needles: np.ndarray,
                          lens: np.ndarray, *, n_real: int) -> torch.Tensor:
    """Scan every resident chunk on its own shard -> packed
    int32[n_real, G/32] over logical chunks, on the host.

    The dense stream mode only (480 payload bytes a chunk, what the row
    cache scans): chunk overlap bytes are duplicated into each chunk at
    pack time, so shard boundaries need no halo exchange. A card's shards
    are one launch of up to 4 whole-shard ranges (``MAX_SEGMENTS``; a
    card's one shard is a dense-mode launch), counted as dense
    (``stream``) launches; needles travel as kernel arguments from the
    host. All the launches are one ``byte_scan_plan_into`` call. With
    ``mesh`` None, ``rows32`` is one stream tensor (the single-device row
    cache's dense scan): one dense-mode launch over the whole stream into
    page-locked memory, counted as a ``stream`` launch of the kernel; only
    a mesh's calls count in ``launch_counts()``."""
    shards = _shards(rows32)
    rows = shards[0].shape[0]
    plan = [(card.offsets[card.shards.index(run[0])], [(shards[i], 0, rows) for i in run])
            for card in card_layout(rows32, 0, MAX_SEGMENTS) for run in card.launches]
    out = _scan_plan(shards, logical_size(rows32, 0) // TILE_CHUNKS, plan, needles, lens,
                     n_real, "stream")
    if mesh is not None:
        _count("sharded_scan_all_rows", shards)
    return out


def _scan_plan(shards: tuple, words: int, plan: list, needles: np.ndarray, lens: np.ndarray,
               n_real: int, count_as: str) -> torch.Tensor:
    """``plan``'s launches into a new int32[n_real, words] bitmap,
    page-locked on cards."""
    out = torch.empty((n_real, words), dtype=torch.int32,
                      pin_memory=shards[0].device.type == "cuda")
    byte_scan_plan_into(out, plan, needles, lens, n_real=n_real, count_as=count_as)
    return out


# --- The sparse sharded scan --------------------------------------------------


def segment_pieces(starts: Sequence[int], counts: Sequence[int], shard_rows: int,
                   n_shards: int) -> tuple[list[tuple[int, int, int]], list[int]]:
    """Requested chunk ranges ``[starts[r], starts[r] + counts[r])`` of a
    stream sharded into ``n_shards`` shards of ``shard_rows`` rows ->
    (pieces, range_base).

    A piece ``(shard, first row in the shard, rows)`` is what one range of
    a segment-mode launch reads: its rows are a multiple of 32 and lie in
    one shard. Pieces are laid end to end in the output in order, and
    range r's requested chunks are one run of it from logical output chunk
    ``range_base[r]`` on. A range inside one shard is one piece of its
    count rounded up to 32, clamped into the shard where that would cross
    the shard's end (as ``segment_layout`` clamps into the stream). A range
    that crosses boundaries is cut there: a first piece that ends at the
    first boundary and starts as far before it as rounding up asks, then a
    piece from the first row of every later shard it touches (whole
    shards in the middle), each rounded up to 32; so every piece starts on
    an output word and the requested chunks stay adjacent."""
    if shard_rows <= 0 or shard_rows % TILE_CHUNKS or n_shards < 1:
        raise ValueError(f"{n_shards} shards of {shard_rows} rows: want a positive multiple "
                         f"of {TILE_CHUNKS} rows a shard")
    total = shard_rows * n_shards
    pieces: list[tuple[int, int, int]] = []
    range_base: list[int] = []
    at = 0  # logical output chunk of the next piece
    for s, n in zip(starts, counts):
        s, n = int(s), int(n)
        if n <= 0 or s < 0 or s + n > total:
            raise ValueError(f"range [{s}, {s + n}) outside a {total}-chunk stream")
        first, last = s // shard_rows, (s + n - 1) // shard_rows
        if first == last:
            rows = -(-n // TILE_CHUNKS) * TILE_CHUNKS
            read = min(s - first * shard_rows, shard_rows - rows)
            range_base.append(at + s - first * shard_rows - read)
            pieces.append((first, read, rows))
            at += rows
            continue
        head = (first + 1) * shard_rows - s  # requested rows before the boundary
        rows = -(-head // TILE_CHUNKS) * TILE_CHUNKS
        range_base.append(at + rows - head)
        pieces.append((first, shard_rows - rows, rows))
        at += rows
        for i in range(first + 1, last + 1):
            rows = -(-min(s + n - i * shard_rows, shard_rows) // TILE_CHUNKS) * TILE_CHUNKS
            pieces.append((i, 0, rows))
            at += rows
    return pieces, range_base


def piece_launches(pieces: Sequence[tuple[int, int, int]], devices: Sequence,
                   capacity: int) -> list[tuple]:
    """Group ``segment_pieces``'s pieces, shard i on ``devices[i]``, into
    launches: one launch takes up to ``capacity`` pieces that follow one
    another in the output and lie on one device -> ``[(device, [(first
    word, piece indices), ...]), ...]``, devices in the order of their
    first piece. A card whose shards are neighbours in the mesh makes
    ceil(its pieces / capacity) launches; only cards that hold a piece
    launch."""
    plan: dict = {}
    word, prev = 0, None
    for i, (shard, _, rows) in enumerate(pieces):
        dev = devices[shard]
        launches = plan.setdefault(dev, [])
        if dev == prev and len(launches[-1][1]) < capacity:
            launches[-1][1].append(i)
        else:
            launches.append((word, [i]))
        prev = dev
        word += rows // TILE_CHUNKS
    return list(plan.items())


def sharded_scan_segments(mesh: Optional[Mesh], rows32: Sharded, seg_starts: Sequence[int],
                          needles: np.ndarray, lens: np.ndarray, *, n_real: int,
                          seg_chunks: Sequence[int]) -> tuple[torch.Tensor, list[int]]:
    """Scan just the requested chunk ranges (``seg_starts``, ``seg_chunks``
    chunks each) of a sharded stream, each read in place on the card that
    holds it -> (packed int32[n_real, total/32] on the host, range_base).

    The single-device sparse layout: the ranges' pieces
    (``segment_pieces``) laid end to end, range r's requested chunks at
    logical output chunk ``range_base[r]`` on; the chunks added by rounding
    are scanned and ignored by callers. One segment-mode launch covers up
    to ``MAX_SEGMENTS`` pieces of one card (``piece_launches``), only cards
    that hold a piece launch, and all the launches are one
    ``byte_scan_plan_into`` call. With ``mesh`` None, ``rows32`` is one
    stream tensor (the single-device row cache): one shard, whose pieces
    are ``segment_layout``'s ranges, one launch; only a mesh's calls count
    in ``launch_counts()``."""
    shards = _shards(rows32)
    plan, words, range_base = segment_plan(shards, seg_starts, seg_chunks)
    out = _scan_plan(shards, words, plan, needles, lens, n_real, "segments")
    if mesh is not None:
        _count("sharded_scan_segments", shards)
    return out, range_base


def segment_plan(shards: tuple, seg_starts: Sequence[int],
                 seg_chunks: Sequence[int]) -> tuple[list, int, list[int]]:
    """The sparse scan's launches over the stream ``shards`` -> (the plan
    of ``byte_scan_plan_into``: ``piece_launches``' launches in order, each
    piece a range of its shard; the output's words; ``range_base``)."""
    counts = list(seg_chunks)
    if len(counts) != len(seg_starts):
        raise ValueError(f"{len(seg_starts)} starts and {len(counts)} chunk counts")
    pieces, range_base = segment_pieces(seg_starts, counts, shards[0].shape[0], len(shards))
    plan = [(word, [(shards[pieces[i][0]], pieces[i][1], pieces[i][2]) for i in idx])
            for _, launches in piece_launches(pieces, [s.device for s in shards], MAX_SEGMENTS)
            for word, idx in launches]
    return plan, sum(rows for _, _, rows in pieces) // TILE_CHUNKS, range_base

"""Block-axis sharding over several devices (K3): the mesh, its maintenance
helpers and the four sharded kernel wrappers.

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

The sharded wrappers have no kernel body of their own. Each launches the
port's existing kernel (``csrc/probe.cu`` in the epilogue's mode, or
``csrc/scan.cu`` in dense mode) on every shard, on that shard's device and
its current stream, before it copies anything back (the probe arrays and
the needles are host arrays that travel in each launch's parameters, so
nothing is copied to the cards first); then it copies each
shard's packed bitmap to the host and joins them along the word axis in
shard order. That join is bit-for-bit the unsharded kernel's output because
every shard is a contiguous range whose width is a multiple of 32 (128·n
columns, 512·n chunks). The mesh is one process driving every device, so no
``torch.distributed`` collective is needed: the survivor total that the
reference ``psum``s is the sum of the per-shard counts. Which kernel or plain
version runs follows each shard tensor's device, as the unsharded wrappers'
rule has it (``kernels/probe.py``, ``kernels/scan.py``).

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

from ..kernels.probe import probe_and_pack, probe_clauses_pack, probe_reduce_and_pack
from ..kernels.scan import CHUNK_BYTES, byte_scan_stream

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
}


def launch_counts() -> dict[str, int]:
    """Sharded calls that launched their kernel on CUDA shards since the
    last reset (each shard's launch also counts in its kernel module)."""
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


def _to_host(parts: list) -> list:
    """Each shard's bitmap (every shard launched first) to the host. The
    copies from every card are queued before any is waited for, into
    page-locked buffers so each runs as a DMA on its card's current stream.
    With one blocking copy to pageable memory per shard, a sharded scan
    over four H100 cards (0.9 MB of bitmap a shard) took 53 ms, its shard
    launches 0.82 ms."""
    host = []
    for p in parts:
        if p.device.type == "cuda":
            h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            h.copy_(p, non_blocking=True)
            p = h
        host.append(p)
    for dev in dict.fromkeys(p.device for p in parts if p.device.type == "cuda"):
        torch.cuda.current_stream(dev).synchronize()
    return host


def _join(parts: list) -> torch.Tensor:
    """The shards' bitmaps joined on the host along the word axis, in
    shard order."""
    return torch.cat(_to_host(parts), dim=-1)


def _probe_shards(bank: Sharded, row_idx, shift, launch) -> list:
    """Launch on every shard with the same host probe arrays, which travel
    in each launch's parameters (no copy to any card)."""
    return [launch(s, row_idx, shift) for s in _shards(bank)]


def sharded_probe_packed(mesh: Mesh, bank2d: Sharded, row_idx, shift, T: int,
                         K: int) -> torch.Tensor:
    """Probe every shard's blocks -> packed int32[T, C/32] on the host."""
    parts = _probe_shards(
        bank2d, row_idx, shift, lambda b, r, s: probe_and_pack(b, r, s, T, K)
    )
    _count("sharded_probe_packed", _shards(bank2d))
    return _join(parts)


def sharded_query_step(mesh: Mesh, bank2d: Sharded, row_idx, shift, and_bits: int,
                       T: int, K: int) -> tuple[torch.Tensor, int]:
    """The flat-AND query step: probe, AND over the terms in ``and_bits``
    (terms outside it count as true) and the survivor total.

    Returns (packed survivors int32[C/32] on the host, total survivors):
    the total is the sum of the per-shard popcounts, the reference's
    ``psum``."""
    parts = _probe_shards(
        bank2d, row_idx, shift,
        lambda b, r, s: probe_reduce_and_pack(b, r, s, T, K, and_bits)[0],
    )
    _count("sharded_query_step", _shards(bank2d))
    host = _to_host(parts)
    total = sum(
        int(np.unpackbits(p.numpy().view(np.uint8)).sum()) for p in host
    )
    return torch.cat(host), total


def sharded_probe_clauses(mesh: Mesh, bank2d: Sharded, row_idx, shift,
                          clause_bits: Sequence[int], member_bits: Sequence[int],
                          T: int, K: int) -> torch.Tensor:
    """Probe and the fused CNF epilogue on every shard -> packed
    int32[M, C/32] on the host (bit masks as in ``probe_clauses_pack``)."""
    parts = _probe_shards(
        bank2d, row_idx, shift,
        lambda b, r, s: probe_clauses_pack(b, r, s, T, K, clause_bits, member_bits),
    )
    _count("sharded_probe_clauses", _shards(bank2d))
    return _join(parts)


def sharded_scan_all_rows(mesh: Mesh, rows32: Sharded, needles: np.ndarray,
                          lens: np.ndarray, *, n_real: int,
                          max_words: int) -> torch.Tensor:
    """Scan every resident chunk on its own shard -> packed
    int32[n_real, G/32] over logical chunks, on the host.

    The dense stream mode only (480 payload bytes a chunk, what the row
    cache scans): chunk overlap bytes are duplicated into each chunk at
    pack time, so shard boundaries need no halo exchange. Needles travel
    as kernel arguments from the host."""
    shards = _shards(rows32)
    parts = [
        byte_scan_stream(s, needles, lens, n_real=n_real, max_words=max_words)
        for s in shards
    ]
    _count("sharded_scan_all_rows", shards)
    return _join(parts)

import importlib

from .mesh import (
    BLOCK_AXIS,
    default_mesh,
    pad_columns_for_mesh,
    shard_bank,
    sharded_probe_packed,
    sharded_query_step,
    unpack_bitmap,
)

# The scatter/gather layer imports the engine, which imports the mesh (via
# bloom/bank.py and rowcache.py): it loads on first use so that importing
# the mesh never runs into a half-initialized engine module.
_LAZY = {
    "QueryPeer": ".distributed",
    "ScatterGatherCoordinator": ".distributed",
    "QueryServer": ".remote",
    "RemoteQueryPeer": ".remote",
    "CapacityScatterCoordinator": ".discovery",
    "Heartbeat": ".discovery",
    "PeerInfo": ".discovery",
    "PeerRegistry": ".discovery",
    "assign_files_by_capacity": ".discovery",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BLOCK_AXIS",
    "default_mesh",
    "pad_columns_for_mesh",
    "shard_bank",
    "sharded_probe_packed",
    "sharded_query_step",
    "unpack_bitmap",
    "QueryPeer",
    "ScatterGatherCoordinator",
    "QueryServer",
    "RemoteQueryPeer",
    "CapacityScatterCoordinator",
    "Heartbeat",
    "PeerInfo",
    "PeerRegistry",
    "assign_files_by_capacity",
]

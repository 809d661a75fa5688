"""Entry points on PyTorch: the single-device probe step and the
multi-device dry run.

The twins of the JAX package's ``__graft_entry__.py``: ``entry`` returns
the probe-and-pack forward step (the query hot path's kernel, K1 with its
pack epilogue) with example inputs, and ``dryrun_multichip`` runs the
engine's query path over an n-shard mesh in serving mode and then the
fused flat-AND ``sharded_query_step`` directly. Both run on ``device``:
"cuda" (the default) launches the CUDA kernels and raises without a card,
"cpu" runs their plain versions over CPU shards.
"""

from __future__ import annotations

import numpy as np
import torch


def _example_probe_inputs(device, num_blocks: int = 1024, t: int = 4):
    """Synthetic bank + probe batch at the default block bloom params: the
    reference's draws from the same seed (its bank has the 8-row padding,
    which no probe reads, so the port drops it). The bank goes to
    ``device``; the probe arrays stay host tensors, as the kernel takes them
    in its launch parameters."""
    from .bloom import BloomParams

    params = BloomParams(10_000, 0.001)
    w = params.num_words
    rows8 = -(-3 * w // 8) * 8
    rng = np.random.default_rng(0)
    bank = rng.integers(0, 2**32, size=(rows8, num_blocks), dtype=np.uint32)[: 3 * w]
    row_idx = rng.integers(0, 3 * w, size=t * params.k).astype(np.int32)
    shift = rng.integers(0, 32, size=t * params.k).astype(np.int32)
    bank = torch.from_numpy(np.ascontiguousarray(bank).view(np.int32)).to(device)
    return params, bank, torch.from_numpy(row_idx), torch.from_numpy(shift), t


def entry(device="cuda"):
    """(fn, example_args): the probe-and-pack forward step on ``device``."""
    from .kernels.probe import probe_and_pack

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry on 'cuda' but no CUDA device is visible")
    params, bank2d, row_idx, shift, t = _example_probe_inputs(device)

    def forward(bank2d, row_idx, shift):
        return probe_and_pack(bank2d, row_idx, shift, t, params.k)

    return forward, (bank2d, row_idx, shift)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the ENGINE's query path over an n-shard mesh, kernels included.

    The engine's device probe backend shards every superbank's block axis
    over the mesh and the serving row cache shards its stream; an ordinary
    ``engine.query_sync`` probes and scans every shard, then the fused
    flat-AND ``sharded_query_step`` is exercised directly as well. On
    "cuda" the mesh is the first ``n_devices`` cards (fewer raise)."""
    import tempfile

    from . import BloomSearchEngine, BloomSearchEngineConfig, FileSystemDataStore
    from . import new_query
    from .parallel.mesh import default_mesh

    mesh = default_mesh(n_devices, device)  # raises when too few cards

    # --- 1. The engine path: ingest -> flush -> sharded device query -------
    with tempfile.TemporaryDirectory() as tmp:
        store = FileSystemDataStore(tmp)
        config = BloomSearchEngineConfig(
            row_data_compression="none",
            probe_backend="device",
            device=str(device),
            mesh_devices=n_devices,
            row_cache_bytes=64 << 20,  # serving mode: mesh-sharded stream
        )
        engine = BloomSearchEngine(config, store, store)
        backend = engine._device_backend
        assert backend is not None and backend.mesh == mesh, backend.mesh
        assert engine._row_cache is not None
        engine.start()
        try:
            all_rows = []
            for f in range(3):
                rows = [
                    {"n": f * 8 + i, "svc": f"svc{f}", "msg": f"w{f}_{i} shared"}
                    for i in range(8)
                ]
                all_rows.extend(rows)
                engine.ingest_rows(rows, timeout=30)
                engine.flush(timeout=30)

            got = engine.query_sync(new_query().token("w1_3").build(), timeout=30)
            assert got == [r for r in all_rows if "w1_3" in r["msg"]], got
            got = engine.query_sync(new_query().field_token("svc", "svc2").build(), timeout=30)
            assert sorted(r["n"] for r in got) == [
                r["n"] for r in all_rows if r["svc"] == "svc2"
            ]
            # Repeat a needle query: the second pass scans the pinned rows
            # on every shard of the mesh-sharded stream.
            engine.drain_background_pins(timeout=30)
            got = engine.query_sync(new_query().token("w1_3").build(), timeout=30)
            assert got == [r for r in all_rows if "w1_3" in r["msg"]], got
            # The engine superbanks must be sharded over every mesh device.
            assert backend._superbanks, "device probe path not exercised"
            for sb in backend._superbanks.values():
                assert tuple(s.device for s in sb.bank2d) == mesh.devices, sb.bank2d
                assert all(s.shape[1] == sb.capacity // n_devices for s in sb.bank2d)
            # ... and so must the serving row cache's stream matrix.
            rc = engine._row_cache
            assert rc._blocks, "serving row cache not exercised"
            assert rc.mesh == mesh and rc._bucket.matrix is not None
            assert tuple(s.device for s in rc._bucket.matrix) == mesh.devices
            assert rc.stats()["scan_launches"] > 0
        finally:
            engine.stop(timeout=30)

    # --- 2. The fused flat-AND step (probe + reduce + survivor total) ------
    from . import BloomFilters, BloomParams
    from .bloom.probe import compile_bloom_terms, probe_bank_host, stack_filter_bank
    from .parallel import shard_bank, sharded_query_step, unpack_bitmap

    params = BloomParams(200, 0.01)
    num_blocks = 16 * n_devices
    triples = []
    for i in range(num_blocks):
        triple = BloomFilters.from_params(params)
        triple.field.add_keys([f"field{i}"])
        triple.token.add_keys(["shared", f"tok{i}"])
        triple.field_token.add_keys([f"field{i}::tok{i}"])
        triples.append(triple)
    bank = stack_filter_bank(triples)  # [3, W, B]
    bank2d = shard_bank(mesh, bank.reshape(3 * params.num_words, num_blocks))

    query = new_query().token("shared").field_token("field5", "tok5").build()
    terms = compile_bloom_terms(query.bloom)
    word_idx, bit_idx = terms.positions_for(params.m_bits, params.k)
    rows = (terms.ks_idx[:, None].astype(np.int32) * params.num_words + word_idx).reshape(-1)
    t = len(terms)

    packed, total = sharded_query_step(
        mesh, bank2d, rows, bit_idx.reshape(-1).astype(np.int32), (1 << t) - 1, t, params.k
    )
    survivors = unpack_bitmap(packed.numpy()[None, :], num_blocks)[0]
    expected = probe_bank_host(bank, terms, params.m_bits, params.k).all(axis=0)
    assert (survivors == expected).all(), "sharded probe != host semantics"
    assert int(total) == int(expected.sum())
    assert survivors[5], "field5::tok5 block must survive its own query"

"""The tools slice's kernel and harnesses against the JAX package.

K1f: the port's plain floor version against the TPU floor kernel of
``scripts/exp_kernel_floor.py``, which the script defines inside ``main()``;
``tpu_floor_kernel`` repeats its lines 127-174 verbatim, with
``interpret=True`` added so it runs on the CPU. Inputs come from numpy
seeds; every comparison is bit-identical. The timer and the floor tool run
on ``device="cpu"`` (the plain versions); the build-timing tool needs a
card and must refuse without one.
"""

import math
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from bloomsearch_tpu.bloom.pallas_kernels import ROW_GROUP  # noqa: E402
from bloomsearch_tpu_torch.kernels import probe as tk  # noqa: E402
from bloomsearch_tpu_torch.kernels import scan as ks  # noqa: E402
from bloomsearch_tpu_torch.tools import exp_compile_cache, gen_bench_datasets, timing  # noqa: E402
from bloomsearch_tpu_torch.tools import exp_mesh_join, exp_probe_variants  # noqa: E402
from bloomsearch_tpu_torch.tools import exp_kernel_floor as floor  # noqa: E402


def tpu_floor_kernel(T: int, k: int, c_tile: int):
    """``make_dma_kernel(c_tile)`` of ``scripts/exp_kernel_floor.py:127-174``
    with the script's ``T`` and ``k``; the call runs in interpret mode."""

    def make_dma_kernel(c_tile: int):
        def kernel(idx_ref, shift_ref, group_ref, out_ref):
            t = pl.program_id(1)
            j = pl.program_id(2)
            row0 = group_ref[0, :].astype(jnp.int32)

            @pl.when(j == 0)
            def _():
                out_ref[t, :] = row0

            @pl.when(j > 0)
            def _():
                out_ref[t, :] = out_ref[t, :] | row0

        def call(bank, fr, sh):
            R, C = bank.shape
            ct = min(c_tile, C)
            if C % ct:
                ct = C
            grid_spec = pltpu.PrefetchScalarGridSpec(
                num_scalar_prefetch=2,
                grid=(C // ct, T, k),
                in_specs=[
                    pl.BlockSpec(
                        (ROW_GROUP, ct),
                        lambda c, t, j, idx_ref, shift_ref: (
                            idx_ref[t * k + j] // ROW_GROUP,
                            c,
                        ),
                        memory_space=pltpu.VMEM,
                    ),
                ],
                out_specs=pl.BlockSpec(
                    (T, ct),
                    lambda c, t, j, idx_ref, shift_ref: (0, c),
                    memory_space=pltpu.VMEM,
                ),
            )
            return pl.pallas_call(
                kernel,
                grid_spec=grid_spec,
                out_shape=jax.ShapeDtypeStruct((T, C), jnp.int32),
                cost_estimate=pl.CostEstimate(
                    flops=T * k * C,
                    bytes_accessed=T * k * C * 4 * ROW_GROUP + T * C * 4,
                    transcendentals=0,
                ),
                interpret=True,
            )(fr, sh, bank)

        return call

    return make_dma_kernel(c_tile)


def floor_case(seed: int, R: int, C: int, T: int, K: int):
    """uint32[R, C] words over the whole range (bit 31 set in about half),
    T*K probe rows in [0, R) with both ends of an 8-row group (8g and
    8g + 7) among them, and random shifts."""
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 2**32, size=(R, C), dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, R, size=T * K).astype(np.int32)
    groups = rng.integers(0, R // 8, size=T * K)
    rows[0::3] = 8 * groups[0::3]
    rows[1::3] = 8 * groups[1::3] + 7
    shifts = rng.integers(0, 32, size=T * K).astype(np.int32)
    return bank, rows, shifts


def port(bank, rows, shifts):
    return (torch.from_numpy(bank.view(np.int32).copy()), torch.from_numpy(rows),
            torch.from_numpy(shifts))


@pytest.mark.parametrize("R", [64, 13_480])
@pytest.mark.parametrize("C", [256, 512])
def test_floor_plain_matches_the_tpu_floor_kernel(R, C):
    T, K = 4, 10
    bank, rows, shifts = floor_case(R + C, R, C, T, K)
    want = np.asarray(tpu_floor_kernel(T, K, 128)(
        jnp.asarray(bank), jnp.asarray(rows), jnp.asarray(shifts)))
    got = tk.probe_floor_plain(port(bank, rows, shifts)[0], torch.from_numpy(rows), T, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any(), "no word with bit 31 set reached the output"
    # The wrapper on CPU tensors is the plain version.
    np.testing.assert_array_equal(tk.probe_floor(*port(bank, rows, shifts), T, K).numpy(), want)


def test_floor_reads_row_zero_of_the_group_and_nothing_outside_the_bank():
    bank = np.arange(16 * 64, dtype=np.uint32).reshape(16, 64) | np.uint32(1 << 31)
    rows = np.array([7, 8, 15, -1, 16, 3], dtype=np.int32)
    b, r, s = port(bank, rows, np.zeros(6, np.int32))
    got = tk.probe_floor(b, r, s, 3, 2).numpy().view(np.uint32)
    np.testing.assert_array_equal(got[0], bank[0] | bank[8])
    np.testing.assert_array_equal(got[1], bank[8])  # rows -1 and 16 read 0
    np.testing.assert_array_equal(got[2], bank[0])


def test_probe_floor_writes_a_reused_output():
    T, K = 2, 3
    bank, rows, shifts = floor_case(5, 32, 128, T, K)
    b, r, s = port(bank, rows, shifts)
    out = torch.full((T, 128), 7, dtype=torch.int32)
    first = tk.probe_floor(b, r, s, T, K, out=out)
    assert first is out
    np.testing.assert_array_equal(out.numpy(), tk.probe_floor_plain(b, r, T, K).numpy())
    r2 = torch.flip(r, [0]).contiguous()
    assert tk.probe_floor(b, r2, s, T, K, out=out) is out
    np.testing.assert_array_equal(out.numpy(), tk.probe_floor_plain(b, r2, T, K).numpy())
    for bad in (torch.empty((T, 64), dtype=torch.int32), torch.empty((T, 128)),
                torch.empty((128, T), dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            tk.probe_floor(b, r, s, T, K, out=bad)


def test_chain_timer_on_the_cpu():
    calls = []
    ms = timing.chain_ms(calls.append, 5, "cpu", reps=3)
    assert calls == list(range(5)) * 3 and math.isfinite(ms) and ms > 0
    slope = timing.chain_slope(lambda i: sum(range(2000)), "cpu", 2, 20, reps=3)
    assert slope["large_ms"] > slope["small_ms"] > 0
    assert math.isfinite(slope["per_launch_ms"]) and slope["per_launch_ms"] > 0


def test_floor_tool_on_the_cpu():
    out = floor.measure("cpu", num_blocks=256, n_small=2, n_large=16, reps=3, log=lambda m: None)
    assert (out["rows"], out["k"], out["T"]) == (13_480, 10, 4)
    for key in ("stream_gbps", "floor_ms", "floor_gbps", "floor_probes_per_sec", "probe_ms",
                "probe_probes_per_sec", "floor_bound_ms", "probe_over_floor"):
        assert math.isfinite(out[key]) and out[key] > 0, key
    from bloomsearch_tpu_torch import bench

    t1 = bench.kernel_record(out)
    assert t1["bloom_probes_per_sec_per_chip"] == out["probe_probes_per_sec"]
    assert t1["kernel_shape"] == {"rows": 13_480, "C": 256, "T": 4, "k": 10}
    # K1f's bound at the bench shape (C = 32,768): 5,767,488 bytes over 3.35 TB/s.
    assert floor.floor_bound_ms(4, 10, 32_768) == pytest.approx(5_767_488 / 3.35e12 * 1e3)


def test_a_captured_launch_counts_when_replayed_not_when_captured(monkeypatch):
    """A launch into a capturing stream runs nothing and counts nothing:
    the capture notes it and every replay counts it."""
    key = ("floor", 128, 2, 2, 0)
    tk.reset_launch_counts()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="CapturedLaunches"):
        tk._count(*key)
    noted: dict = {}
    monkeypatch.setattr(tk, "_capture", noted)
    tk._count(*key)
    tk._count(*key)
    assert noted == {key: 2} and tk.launch_counts()["floor"] == 0
    chain = tk.CapturedLaunches.__new__(tk.CapturedLaunches)
    chain.graph, chain.launches = types.SimpleNamespace(replay=lambda: None), noted
    chain.replay()
    chain.replay()
    assert tk.launch_counts()["floor"] == 4 and tk.launch_shapes() == {key: 4}


@pytest.mark.parametrize("argv, want", [
    ([], [("refscale", None), ("xlscale", None)]),
    (["xxlscale", "--target-mb", "64"], [("xxlscale", 64)]),
])
def test_dataset_generator_takes_names(monkeypatch, argv, want):
    made = []
    monkeypatch.setattr(gen_bench_datasets.bench, "ensure_dataset",
                        lambda name, target_mb, log: made.append((name, target_mb)) or "cache")
    gen_bench_datasets.main(argv)
    assert made == want


def test_tools_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_compile_cache.measure(log=lambda m: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        floor.main([])


def test_probe_variants_rewrite_one_define_each():
    """Each variant of csrc/probe.cu differs from the source in one #define
    (the least warps a block, or the small parameter struct's capacity),
    and the tool has no CPU form."""
    with open(tk.SOURCE) as fh:
        source = fh.read().splitlines()
    variants = exp_probe_variants.variant_sources()
    assert len(variants) == len(exp_probe_variants.BLOCK_WARPS) + 1
    for name, text in variants.items():
        changed = [(a, b) for a, b in zip(source, text.splitlines()) if a != b]
        if name == "block_warps=4":
            assert changed == []
            continue
        assert len(changed) == 1, name
        want = "#define CAP_SMALL CAP_MAX" if "struct" in name else \
            f"#define BLOCK_WARPS {name.split('=')[1]}"
        assert changed[0][1].startswith(want), name
    with pytest.raises(RuntimeError):
        exp_probe_variants.measure("cpu", log=lambda m: None)


@pytest.mark.parametrize("label", ["K3-a pack, T = 4", "K3-b reduce, T = 1",
                                   "K3-c clauses, T = 4, 2 clauses, 1 member",
                                   "K3-d scan, n_real = 1", "K3-d scan, n_real = 8",
                                   "K3-e segments, 3 ranges, n_real = 3"])
def test_mesh_join_cases_agree_on_a_cpu_mesh(label):
    """The mesh-join tool's cases on a 4-shard CPU mesh: the package's
    wrapper, one launch a card into a wider output (``into``) and the
    per-shard form's single-device calls joined give the same words; the
    sparse case's call, the dense sharded call and the single-device
    segment call agree at every requested chunk, planted hits included;
    the tool itself has no CPU form."""
    from bloomsearch_tpu_torch.parallel import mesh as pm

    mesh = pm.default_mesh(4, "cpu")
    bank, stream = exp_mesh_join.mesh_state(mesh.devices, 3, 60, 128, 512)
    rng = np.random.default_rng(3)
    if label.startswith("K3-e"):
        needles = np.zeros((3, 32), np.int32)
        needles[0, :1], needles[1, :2], needles[2, :4] = [0x61], [0x61, 0x62], [1, 2, 3, 4]
        full = torch.cat(list(stream))
        case = exp_mesh_join.sparse_case(mesh, stream, full, rng,
                                         (needles, np.array([1, 2, 4], np.int32)))
        assert case.label == label
        pieces, _ = pm.segment_pieces(case.starts, case.counts, 512, 4)
        assert [i for i, _, _ in pieces] == [0, 1, 1, 3]  # across boundary 1, inside 1, at the end
        got = exp_mesh_join.check_sparse(case)
        want = [exp_mesh_join.requested_bits(
            ks.byte_scan_stream(full, case.needles, case.lens, n_real=3),
            case.starts, case.counts)[r] for r in range(3)]
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert all(b[0].any() and not b[2].all() for b in got)
        with pytest.raises(RuntimeError):
            exp_mesh_join.measure("cpu", log=lambda m: None)
        return
    case = next(c for c in exp_mesh_join.make_cases(mesh, bank, stream, rng, 60)
                if c.label == label)
    want = case.wrapper()
    assert torch.equal(want, torch.cat([case.single(s) for s in case.shards], dim=-1))
    words = want.shape[1]
    out = torch.full((case.out_rows, words + 3), 7, dtype=torch.int32)
    for card in pm.card_layout(case.shards, case.axis, case.capacity):
        for run in card.launches:
            case.into(out, 3 + card.offsets[card.shards.index(run[0])],
                      [case.shards[i] for i in run])
    assert torch.equal(out[:, 3:], want) and (out[:, :3] == 7).all()
    with pytest.raises(RuntimeError):
        exp_mesh_join.measure("cpu", log=lambda m: None)


@pytest.mark.cuda
def test_cuda_floor_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    dev = torch.device("cuda")
    tk.reset_launch_counts()
    for R, C in ((64, 256), (13_480, 512)):
        bank, rows, shifts = floor_case(R, R, C, 4, 10)
        cpu = port(bank, rows, shifts)
        got = tk.probe_floor(cpu[0].to(dev), rows, shifts, 4, 10)  # host probe arrays
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), tk.probe_floor_plain(cpu[0], cpu[1], 4, 10).numpy())
    assert tk.launch_counts()["floor"] == 2


@pytest.mark.cuda
def test_cuda_chain_counts_the_launches_its_replays_run():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    dev = torch.device("cuda")
    bank, rows, shifts = port(*floor_case(3, 64, 256, 4, 10))
    bank = bank.to(dev)  # the probe arrays stay host tensors
    out = torch.empty((4, 256), dtype=torch.int32, device=dev)
    tk.reset_launch_counts()
    timing.chain_ms(lambda i: tk.probe_floor(bank, rows, shifts, 4, 10, out=out), 5, dev, reps=2)
    # One warm launch, then the chain of 5 replayed once to settle and twice timed.
    assert tk.launch_counts()["floor"] == 1 + 3 * 5

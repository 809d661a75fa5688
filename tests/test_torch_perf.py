"""The port's ``perf`` harness and bench helpers against the JAX package's,
on the same inputs: the same seed generates the same rows, a needle query
reports the same results and candidate rows, ``inspect`` prints the same
lines, and the bench's needle timing returns the same keys and rows. The
port's engines run on ``device="cpu"`` (the kernels' plain versions)."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
from bloomsearch_tpu import perf as jperf  # noqa: E402
from bloomsearch_tpu_torch import bench as tbench  # noqa: E402
from bloomsearch_tpu_torch import perf as tperf  # noqa: E402

import bench as jbench  # noqa: E402  (the JAX package's bench.py, at the repo root)


def perf_args(directory, **kw) -> SimpleNamespace:
    base = dict(dir=str(directory), compression="snappy", concurrency=8,
                probe_backend="host", layout="classic", block_items=None,
                target_mb=1, seed=3, device="cpu", blocks=True)
    return SimpleNamespace(**{**base, **kw})


def all_rows(pkg, engine) -> list[str]:
    """Every row: each carries the partition key "part"."""
    rows = engine.query_sync(pkg.new_query().field("part").build(), timeout=60)
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


def needle_queries(pkg):
    return {
        "token": pkg.new_query().token(jperf.NEEDLE_TOKEN).build(),
        "field": pkg.new_query().field(jperf.NEEDLE_FIELD).build(),
        "field:token": pkg.new_query().field_token(
            jperf.NEEDLE_FT_FIELD, jperf.NEEDLE_FT_TOKEN).build(),
    }


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """One dataset from each package's ``cmd_generate`` with one seed."""
    root = tmp_path_factory.mktemp("perf")
    jperf.cmd_generate(perf_args(root / "jax"))
    tperf.cmd_generate(perf_args(root / "port"))
    return root / "jax", root / "port"


def test_cmd_generate_writes_the_same_rows(generated):
    counts = []
    for directory in generated:
        rows = []
        for pkg, perf in ((bs, jperf), (bt, tperf)):
            engine, _ = perf._engine(perf_args(directory))
            try:
                rows.append(all_rows(pkg, engine))
            finally:
                engine.stop(timeout=60)
        assert rows[0] == rows[1]
        counts.append(rows[0])
    assert counts[0] == counts[1] and len(counts[0]) > 5_000
    assert sum(jperf.NEEDLE_TOKEN in r for r in counts[0]) >= 1


def test_run_one_query_reports_the_same_results(generated):
    for directory in generated:
        jengine, jstore = jperf._engine(perf_args(directory))
        tengine, tstore = tperf._engine(perf_args(directory, probe_backend="device"))
        try:
            for label, query in needle_queries(bs).items():
                want = jperf._run_one_query(jengine, jstore, label, query)
                got = tperf._run_one_query(tengine, tstore, label, needle_queries(bt)[label])
                assert set(got) == set(want)
                for key in ("results", "candidate_rows", "candidate_bytes",
                            "blocks_skipped_by_bloom", "blocks_processed"):
                    assert got[key] == want[key], (label, key)
                assert got["results"] >= 1
        finally:
            jengine.stop(timeout=60)
            tengine.stop(timeout=60)


def test_cmd_inspect_prints_the_same_lines(generated, capsys):
    for directory in generated:
        jperf.cmd_inspect(perf_args(directory))
        want = capsys.readouterr().out
        tperf.cmd_inspect(perf_args(directory))
        got = capsys.readouterr().out
        assert got == want and "total: " in got and "block@" in got


def test_timed_needle_queries_match_the_jax_bench(tmp_path):
    tperf.generate_fast(str(tmp_path), 1, seed=0, compression="snappy", log=lambda m: None)
    store_j = bs.FileSystemDataStore(str(tmp_path))
    store_t = bt.FileSystemDataStore(str(tmp_path))
    jengine = bs.BloomSearchEngine(bs.BloomSearchEngineConfig(probe_backend="host"),
                                   store_j, store_j)
    tengine = bt.BloomSearchEngine(
        bt.BloomSearchEngineConfig(probe_backend="device", device="cpu"), store_t, store_t)
    for engine in (jengine, tengine):
        engine.start()
    try:
        want = jbench._timed_needle_queries(jengine, store_j, reps=1)
        got = tbench._timed_needle_queries(tengine, store_t, reps=1)
    finally:
        jengine.stop(timeout=60)
        tengine.stop(timeout=60)
    assert set(got) == set(want)
    assert got["rows"] == want["rows"] > 0
    assert (want["backend"], got["backend"]) == ("host", "device")


def test_bench_failures_find_every_failed_phase():
    assert tbench.failures({"ingest_rows_per_sec": 1, "merge_results_exact": True}) == []
    bad = tbench.failures({
        "e2e_error": "boom", "merge_results_exact": False,
        "e2e_refscale_qps_curve": {"16": {"qps": 1.0}, "32": "error:timeout"},
        "e2e_refscale_during_warmup": [[0.0, 12.5], [10.0, "error:RuntimeError()"]],
    })
    assert len(bad) == 4


def test_bench_dataset_caches_are_the_ports_own():
    path = tbench.dataset_cache("refscale", 1600, 0)
    assert path.startswith(os.path.expanduser("~/.cache/bloomsearch-torch-refscale/"))
    assert path.endswith("-1600mb-seed0")

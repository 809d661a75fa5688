"""The reference's oracle fuzz on the port, in step with the JAX engine.

Each case of ``tests/test_oracle_fuzz.py`` (its seeds, stores, backends and
serialized mix) runs at both bloom layouts (the reference draws one a
seed). One plan (``bloomsearch_tpu_torch.tools.oracle_fuzz``) drives the
port's engine on the CPU and the JAX engine with the same operations; every
query's rows must equal the oracle's on both (the minmax subset rule where
a minmax prefilter prunes by block) and be the same row multiset on both,
and the oracle computed with the port's tokenizer must equal the one the
reference's test computes with the JAX package's. The port's device and
serving cases run on a 4-shard CPU mesh, the JAX engine's on the
conftest's 8 virtual devices, as the reference's do. One case the
reference lacks runs on ``serving``: rows longer than a 480-byte stream
chunk, non-ASCII tokens and a field token over the 32-byte needle limit.
"""

import random

import pytest
import torch

torch.set_num_threads(1)

import bloomsearch_tpu as bs  # noqa: E402
import bloomsearch_tpu_torch as bt  # noqa: E402
import test_oracle_fuzz as ref  # noqa: E402
from bloomsearch_tpu_torch.tools import oracle_fuzz as of  # noqa: E402

LAYOUTS = ("classic", "blocked256")
REFERENCE_CASES = [
    (7, "fs", "host", 0.0), (23, "fs", "host", 0.0), (99, "fs", "host", 0.0),
    (7, "object", "host", 0.0), (42, "object", "host", 0.0),
    (13, "fs", "device", 0.0), (57, "object", "device", 0.0),
    (31, "fs", "serving", 0.0),
    (311, "fs", "host", 0.6), (313, "fs", "device", 0.6), (317, "fs", "serving", 0.6),
]


def port_settings(backend: str, store: str, layout: str) -> of.EpisodeSettings:
    extra = (("device", "cpu"),)
    if backend != "host":
        extra += (("mesh_devices", 4),)
    return of.EpisodeSettings(backend=backend, store=store, layout=layout, extra=extra)


def jax_settings(backend: str, store: str, layout: str) -> of.EpisodeSettings:
    return of.EpisodeSettings(backend=backend, store=store, layout=layout)


def both_oracles_agree(spec, query_of, rows_of, all_rows):
    """The oracle with the JAX package's semantics (the reference test's
    ``oracle_results``) equals the port's, with and without prefilters."""
    jq, pq = query_of["jax"], query_of["port"]
    for apply in (True, False):
        mine = of.oracle_ids(all_rows, pq, apply_prefilter=apply)
        theirs = sorted(r["id"] for r in ref.oracle_results(all_rows, jq, apply_prefilter=apply))
        assert mine == theirs, (spec, apply)


def run_in_step(tmp_path, episode, backend, store, layout, escapes=None) -> dict:
    port = of.open_engine(bt, episode, port_settings(backend, store, layout),
                          str(tmp_path / "port"))
    jax_engine = of.open_engine(bs, episode, jax_settings(backend, store, layout),
                                str(tmp_path / "jax"))
    serving = backend == "serving"
    targets = [of.Target("port", bt, port, serving), of.Target("jax", bs, jax_engine, serving)]
    try:
        if escapes is None:
            counts = of.run_episode(targets, episode, on_query=both_oracles_agree)
        else:
            with of.EscapeCounter(port) as counter:
                def on_query(spec, query_of, rows_of, all_rows):
                    both_oracles_agree(spec, query_of, rows_of, all_rows)
                    counter.after_query(rows_of["port"])

                counts = of.run_episode(targets, episode, on_query=on_query)
            escapes.update(flag_only=counter.flag_only, accepted=counter.accepted)
        stats = port.stats()
        if backend != "host":
            # The port probed on its device backend, in the episode's layout.
            assert stats["device"]["probe_launches"] > 0
            assert all(k.endswith("," + layout) for k in stats["device"]["superbanks"])
        if serving:
            assert stats["row_cache"]["scan_launches"] > 0
        return counts
    finally:
        port.stop(timeout=of.TIMEOUT)
        jax_engine.stop(timeout=of.TIMEOUT)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed,store,backend,serialized_frac", REFERENCE_CASES)
def test_port_and_jax_match_the_oracle(tmp_path, seed, store, backend, serialized_frac, layout):
    episode = of.plan_episode(seed, serialized_frac)
    counts = run_in_step(tmp_path, episode, backend, store, layout)
    assert counts["queries"] >= 8


@pytest.mark.parametrize("layout", LAYOUTS)
def test_long_rows_non_ascii_and_long_needles_on_serving(tmp_path, layout):
    episode = of.plan_episode(1601, serialized_frac=0.6, variant="long")
    rows = [r for op in episode.ops if op[0] in ("rows", "serialized")
            for r in (op[1] if op[0] == "rows" else op[3])]
    assert max(len(str(r)) for r in rows) > 2 * 480
    escapes: dict = {}
    counts = run_in_step(tmp_path, episode, "serving", "fs", layout, escapes)
    assert counts["queries"] >= 8
    # Rows found only through the always-candidate flags: the escape path ran.
    assert escapes["accepted"] > 0, escapes


@pytest.mark.parametrize("seed", [7, 13, 31, 311, 317])
def test_plan_draws_as_the_reference(seed):
    """The plan's generators consume the random stream as the reference's:
    the same rows, serializations and queries from the same seed."""
    mine, theirs = random.Random(seed), random.Random(seed)
    for i in range(40):
        row = of.random_row(mine, i)
        assert row == ref.random_row(theirs, i)
        assert of.weird_json(mine, row) == ref._weird_json(theirs, row)
        spec = of.random_query(mine)
        assert repr(of.build_query(bs, spec)) == repr(ref.random_query(theirs))
    assert mine.getstate() == theirs.getstate()

"""The port's Superbank and DeviceProbeBackend against the JAX package's.

Both run on the CPU: the JAX backend with ``mesh_devices=1`` (conftest gives
JAX eight virtual devices), the port's with ``device="cpu"`` (the kernels'
plain versions). Every comparison is exact: identical bank words, segment
placements, capacities and probe bitmaps.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bloomsearch_tpu as bs  # noqa: E402
from bloomsearch_tpu.bloom import BloomParams  # noqa: E402
from bloomsearch_tpu.bloom import bank as jbank  # noqa: E402
from bloomsearch_tpu.bloom.probe import (  # noqa: E402
    compile_bloom_terms,
    compile_cnf_clauses,
    stack_filter_bank,
)
from bloomsearch_tpu.file_format import BloomFilters  # noqa: E402
from bloomsearch_tpu_torch.bloom import bank as tbank  # noqa: E402

PARAMS = BloomParams(1000, 0.01)
MK = (PARAMS.m_bits, PARAMS.k, "classic")
CPU = torch.device("cpu")


def make_bank(per_block_keys):
    """Host bank uint32[3, W, B] from per-block (field, token, ft) key lists."""
    triples = []
    for field_keys, token_keys, ft_keys in per_block_keys:
        t = BloomFilters.from_params(PARAMS)
        t.field.add_keys(field_keys)
        t.token.add_keys(token_keys)
        t.field_token.add_keys(ft_keys)
        triples.append(t)
    return stack_filter_bank(triples)


def tagged(tag, n):
    return make_bank([([f"{tag}{i}"], [f"t{tag}{i}", "shared"], []) for i in range(n)])


def make_terms(*exprs):
    query = bs.new_query()
    for kind, *args in exprs:
        getattr(query, kind)(*args)
    q = query.build()
    return q.bloom, compile_bloom_terms(q.bloom)


def port_words(sb) -> np.ndarray:
    return sb.bank2d.numpy().view(np.uint32)


def ref_words(sb) -> np.ndarray:
    return np.asarray(sb.bank2d)[: 3 * sb.num_words]


def assert_same_state(ref, port):
    assert port.segments == ref.segments
    assert (port.capacity, port.used, port.dead) == (ref.capacity, ref.used, ref.dead)
    np.testing.assert_array_equal(port_words(port), ref_words(ref))


def assert_same_stats(ref, port):
    """Identical but for the platform and the bytes of the 8 padding rows
    per superbank that only the TPU layout carries."""
    want, got = ref.stats(), port.stats()
    for name, sb in port._superbanks.items():
        assert got["superbanks"][f"m={name[0]},k={name[1]},{name[2]}"]["bytes"] == (
            sb.num_rows * sb.capacity * 4
        )
    for stats in (want, got):
        stats.pop("platform")
        stats.pop("superbank_bytes")
        for entry in stats["superbanks"].values():
            entry.pop("bytes")
    assert got == want


def backends(**kw):
    return (
        jbank.DeviceProbeBackend(mesh_devices=1, **kw),
        tbank.DeviceProbeBackend(device="cpu", **kw),
    )


def probe_both(pair, requests, terms, **kw):
    ref, port = pair
    want = ref.probe_groups(requests, terms, **kw)
    got = port.probe_groups(requests, terms, **kw)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    return got


class TestSuperbank:
    def test_insert_grow_remove_compact(self):
        ref = jbank.Superbank(PARAMS.m_bits, PARAMS.k, "classic", jnp, jax)
        port = tbank.Superbank(PARAMS.m_bits, PARAMS.k, "classic", CPU)
        steps = [("insert", b"a", tagged("a", 3)), ("insert", b"b", tagged("b", 130)),
                 ("insert", b"c", tagged("c", 5)), ("remove", b"b", None),
                 ("compact", None, None), ("insert", b"d", tagged("d", 200)),
                 ("remove", b"a", None), ("compact", None, None),
                 ("remove", b"c", None), ("remove", b"d", None), ("compact", None, None)]
        for op, key, bank in steps:
            if op == "insert":
                assert port.insert(key, bank) == ref.insert(key, bank)
            elif op == "remove":
                port.remove(key)
                ref.remove(key)
            else:
                port.maybe_compact()
                ref.maybe_compact()
            assert_same_state(ref, port)

    def test_growth_and_compaction_never_rewrite_a_snapshot(self):
        port = tbank.Superbank(PARAMS.m_bits, PARAMS.k, "classic", CPU)
        port.insert(b"a", tagged("a", 100))
        snap = port.bank2d
        before = snap.clone()
        port.insert(b"b", tagged("b", 100))  # grows: new tensor
        assert port.bank2d is not snap
        port.remove(b"a")
        port.maybe_compact(force=True)  # compacts: new tensor
        torch.testing.assert_close(snap, before, rtol=0, atol=0)

    def test_superbank_from_reference(self):
        ref = jbank.Superbank(PARAMS.m_bits, PARAMS.k, "classic", jnp, jax)
        for key, tag, n in ((b"x", "x", 4), (b"y", "y", 7), (b"z", "z", 2)):
            ref.insert(key, tagged(tag, n))
        ref.remove(b"y")
        port = tbank.superbank_from_reference(
            np.asarray(ref.bank2d), ref.segments, ref.m_bits, ref.k, ref.layout, CPU
        )
        assert_same_state(ref, port)
        # Both packages probe the same resident state to the same bitmap.
        _, terms = make_terms(("token", "tz1"), ("token", "shared"))
        word_idx, bit_idx = terms.positions_for(PARAMS.m_bits, PARAMS.k)
        rows = (terms.ks_idx[:, None].astype(np.int32) * ref.num_words + word_idx).reshape(-1)
        shifts = bit_idx.reshape(-1).astype(np.int32)
        pair = backends()
        want = pair[0]._probe_superbank_batched(
            ref.bank2d, ref.capacity, ref.k, rows, shifts, len(terms), False
        )
        got = pair[1]._probe_superbank_batched(
            port.bank2d, port.capacity, port.k, rows, shifts, len(terms), False
        )
        np.testing.assert_array_equal(got, want)
        start, n = ref.segments[b"z"]
        assert got[:, start : start + n].all(axis=0).tolist() == [False, True]


class TestProbeGroups:
    @pytest.mark.parametrize("mode", ["plain", "reduce_and", "clauses"])
    def test_modes_match_reference(self, mode):
        pair = backends()
        banks = {b"F1": tagged("p", 6), b"F2": tagged("q", 9)}
        requests = [(p, 0, MK, (lambda b=b: b)) for p, b in banks.items()]
        if mode == "clauses":
            expr, terms = make_terms(("match", bs.or_(bs.token("tp1"), bs.token("tq4"))))
            kw = {"clause_mask": compile_cnf_clauses(expr.expression, terms)}
        else:
            _, terms = make_terms(("token", "shared"), ("field", "q3"))
            kw = {"reduce_and": mode == "reduce_and"}
        got = probe_both(pair, requests, terms, **kw)
        assert any(m.any() for m in got.values())
        assert_same_stats(*pair)

    def test_more_than_16_terms_split(self):
        pair = backends()
        tokens = [f"t{i}" for i in range(20)]
        bank = make_bank([([], tokens, []), ([], tokens[:19], []), ([], tokens[1:], [])])
        _, terms = make_terms(*[("token", t) for t in tokens])
        got = probe_both(pair, [(b"F", 0, MK, lambda: bank)], terms, reduce_and=True)
        assert got[(b"F", 0)].tolist() == [[True, False, False]]
        assert pair[1].launches == 2

    def test_more_than_16_clauses_evaluate_on_host(self):
        pair = backends()
        pool = [f"p{i}" for i in range(6)]
        bank = make_bank([([], pool[:4], []), ([], pool[2:], []), ([], [], [])])
        tree = bs.and_(*[bs.or_(*[bs.token(t) for t in c]) for c in itertools.combinations(pool, 3)])
        expr, terms = make_terms(("match", tree))
        mask = compile_cnf_clauses(expr.expression, terms)
        assert mask.shape[0] > 16
        got = probe_both(pair, [(b"F", 0, MK, lambda: bank)], terms, clause_mask=mask)
        assert got[(b"F", 0)].shape == (1, 3)

    def test_combined_launches_under_threads(self):
        """Concurrent probes coalesce (fewer launches than queries) and every
        query still gets exactly the reference's slice."""
        ref, port = backends()
        bank = make_bank([([f"fld{i}"], [f"tok{i}", "shared"], []) for i in range(40)])
        req = [(b"F", 0, MK, lambda: bank)]
        for b in (ref, port):
            b.probe_groups(req, make_terms(("token", "shared"))[1])
        before = port.launches
        orig = port._launch_combined

        def slow_launch(*args):
            time.sleep(0.03)  # let requests pile up behind the leader
            return orig(*args)

        port._launch_combined = slow_launch
        results, errors = {}, []

        def one_query(qi):
            try:
                _, terms = make_terms(("token", f"tok{qi}"), ("token", "shared"))
                kw = {"reduce_and": qi % 3 == 0}
                if qi % 3 == 1:
                    expr, terms = make_terms(("match", bs.or_(bs.token(f"tok{qi}"), bs.token("none"))))
                    kw = {"clause_mask": compile_cnf_clauses(expr.expression, terms)}
                results[qi] = (port.probe_groups(req, terms, **kw)[(b"F", 0)], terms, kw)
            except Exception as exc:  # pragma: no cover - reported below
                errors.append(exc)

        threads = [threading.Thread(target=one_query, args=(qi,)) for qi in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        assert port.launches - before < 20
        for qi, (got, terms, kw) in results.items():
            want = ref.probe_groups(req, terms, **kw)[(b"F", 0)]
            np.testing.assert_array_equal(got, want, err_msg=f"query {qi}")


class TestResidency:
    def test_lru_eviction_under_cache_bytes(self):
        """Same budget, same probes: the same segments are evicted, the same
        dead columns compact away, and reloads happen in both."""
        pair = backends(cache_bytes=1_700_000)
        banks = {t: tagged(t, 100) for t in "abc"}
        loads = {id(b): {t: 0 for t in "abc"} for b in pair}
        _, terms = make_terms(("token", "ta0"))
        for backend in pair:
            def loader_for(t, counts=loads[id(backend)]):
                def load():
                    counts[t] += 1
                    return banks[t]
                return load

            for t in "abcbca":
                backend.probe_groups([(t.encode(), 0, MK, loader_for(t))], terms)
        ref, port = pair
        assert loads[id(port)] == loads[id(ref)]
        assert_same_stats(ref, port)
        assert_same_state(ref._superbanks[MK], port._superbanks[MK])
        for t in "abc":
            seg = port.segment_key(t.encode(), 0)
            assert port.is_resident(MK, seg) == ref.is_resident(MK, seg)

    def test_invalidate_and_release(self):
        pair = backends()
        _, terms = make_terms(("token", "shared"))
        for b in pair:
            b.probe_groups([(b"A", 0, MK, lambda: tagged("a", 3))], terms)
            b.probe_groups([(b"B", 0, MK, lambda: tagged("b", 4))], terms)
            b.invalidate(b"A")
        ref, port = pair
        assert_same_state(ref._superbanks[MK], port._superbanks[MK])
        assert port.total_bytes() > 0
        port.release()
        assert port.total_bytes() == 0
        assert not port.is_resident(MK, port.segment_key(b"B", 0))
        with pytest.raises(tbank.BackendReleasedError):
            port.probe_groups([(b"B", 0, MK, lambda: tagged("b", 4))], terms)

    def test_precompile_launches_each_epilogue_per_bank(self):
        _, port = backends()
        port.probe_groups([(b"A", 0, MK, lambda: tagged("a", 3))], make_terms(("token", "x"))[1])
        assert port.precompile_probe_programs() == 3


def test_cuda_without_card_raises_and_mesh_is_a_later_slice():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbank.DeviceProbeBackend(device="cuda")
    with pytest.raises(NotImplementedError):
        tbank.DeviceProbeBackend(device="cpu", mesh_devices=2)

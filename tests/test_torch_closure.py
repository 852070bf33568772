"""Port closures against the reference closures and the Hellings oracle.

Every ported closure runs on the CPU on the same inputs as the reference
closures (the reference's bitpacked closures through its jnp bitmm
oracle, ``use_kernel=False``, as tests/test_closure_vs_baseline.py runs
them) and must agree bit for bit: the all-pairs state ``T``, and the
masked closures' full ``(T, M, overflowed)`` triple.  Each reference
result is computed once per input, in a module-scoped fixture.  On the ten
tiny random inputs the reference runs with ``jax.disable_jit()``: the same
functions op by op, which there costs a fraction of one compile per
grammar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import closure as jc
from repro.core import matrices as jm
from repro_torch.baselines.hellings import hellings_cfpq
from repro_torch.core import closure as tc
from repro_torch.core import matrices as tm
from repro_torch.core.semantics import closure_engines, evaluate_relational
from torch_helpers import CASES, NAMED_CASES, case

ALLPAIRS = ("dense_closure", "frontier_closure", "bitpacked_closure")
MASKED = ("masked_closure", "masked_frontier_closure", "masked_bitpacked_closure")
#: row capacity small enough that these inputs overflow
SMALL_CAP = 4
OVERFLOW_CASES = ("skos:q1", "worst6")
#: skos padded to foaf's size: padding is exact, and the reference's jitted
#: closures of one grammar then compile once for both graphs
PAD_TO = {"skos:q1": 384, "skos:q2": 384}


def _jax_kw(name):
    return {"use_kernel": False} if "bitpacked" in name else {}


def _sources(n_nodes: int, n: int) -> np.ndarray:
    src = np.zeros(n, bool)
    rng = np.random.default_rng(n_nodes)
    src[rng.choice(n_nodes, size=min(3, n_nodes), replace=False)] = True
    return src


def _reference(name: str) -> dict:
    """Every reference result the tests of one input compare against:
    ``out[fn]`` for the all-pairs closures, ``out[fn, cap]`` for the
    masked ones."""
    jg, jgr, tg, tgr, start = case(name)
    tables = jm.ProductionTables.from_grammar(jgr)
    T0 = jm.init_matrix(jg, jgr, pad_to=PAD_TO.get(name))
    n = T0.shape[-1]
    src = _sources(jg.n_nodes, n)
    out = {"case": (jg, jgr, tg, tgr, start), "T0": np.asarray(T0), "src": src}
    for fn in ALLPAIRS:
        out[fn] = np.asarray(getattr(jc, fn)(T0, tables, **_jax_kw(fn)))
    for fn in MASKED:
        for cap in (n, SMALL_CAP) if name in OVERFLOW_CASES else (n,):
            T, M, ovf = getattr(jc, fn)(
                T0, tables, jnp.asarray(src), row_capacity=cap, **_jax_kw(fn)
            )
            out[fn, cap] = (np.asarray(T), np.asarray(M), bool(ovf))
    return out


@pytest.fixture(scope="module", params=CASES)
def ref(request):
    if request.param in NAMED_CASES:
        return _reference(request.param)
    with jax.disable_jit():
        return _reference(request.param)


def _port_inputs(ref):
    _, _, tg, tgr, _ = ref["case"]
    T0 = tm.init_matrix(tg, tgr, pad_to=ref["T0"].shape[-1], device="cpu")
    np.testing.assert_array_equal(tm.to_reference(T0), ref["T0"])
    return T0, tm.ProductionTables.from_grammar(tgr)


@pytest.mark.parametrize("fn", ALLPAIRS)
def test_allpairs_closure_matches_reference(ref, fn):
    T0, tables = _port_inputs(ref)
    got = getattr(tc, fn)(T0, tables)
    np.testing.assert_array_equal(tm.to_reference(got), ref[fn])
    np.testing.assert_array_equal(tm.to_reference(T0), ref["T0"])  # untouched


@pytest.mark.parametrize("fn", MASKED)
def test_masked_closure_matches_reference(ref, fn):
    T0, tables = _port_inputs(ref)
    n = T0.shape[-1]
    caps = [key[1] for key in ref if isinstance(key, tuple) and key[0] == fn]
    for cap in caps:
        T, M, ovf = ref[fn, cap]
        gT, gM, govf = getattr(tc, fn)(
            T0, tables, torch.from_numpy(ref["src"]), row_capacity=cap
        )
        np.testing.assert_array_equal(tm.to_reference(gT), T)
        np.testing.assert_array_equal(tm.to_reference(gM), M)
        assert govf == ovf
        if cap < n and ovf:
            assert int(M.sum()) > cap  # the overflow case really overflowed


def test_closures_match_hellings(ref):
    _, _, tg, tgr, start = ref["case"]
    want = hellings_cfpq(tg, tgr)
    T0, tables = _port_inputs(ref)
    for name, fn in closure_engines().items():
        got = tm.relations_from_matrix(fn(T0, tables), tgr, tg.n_nodes)
        assert got == want, name
    rel = evaluate_relational(tg, tgr, start, engine="bitpacked", device="cpu")
    nullable = {(m, m) for m in range(tg.n_nodes)} if start in tgr.nullable else set()
    assert rel == want[start] | nullable


@pytest.mark.parametrize("fn", MASKED)
@pytest.mark.parametrize("name", OVERFLOW_CASES)
def test_masked_warm_start_from_reference_state(fn, name):
    """Re-enter the port's masked closure from an overflowed reference
    ``(T, M)`` (carried across with ``from_reference``): it reaches the
    reference's own warm-restart fixpoint."""
    jg, jgr, tg, tgr, _ = case(name)
    tables = jm.ProductionTables.from_grammar(jgr)
    T0 = jm.init_matrix(jg, jgr, pad_to=PAD_TO.get(name))
    n = T0.shape[-1]
    src = jnp.asarray(_sources(jg.n_nodes, n))
    T1, M1, ovf = getattr(jc, fn)(T0, tables, src, row_capacity=SMALL_CAP, **_jax_kw(fn))
    assert bool(ovf)
    want = getattr(jc, fn)(T1, tables, M1, row_capacity=n, **_jax_kw(fn))
    got = getattr(tc, fn)(
        tm.from_reference(T1, device="cpu"),
        tm.ProductionTables.from_grammar(tgr),
        tm.from_reference(M1, device="cpu"),
        row_capacity=n,
    )
    np.testing.assert_array_equal(tm.to_reference(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(tm.to_reference(got[1]), np.asarray(want[1]))
    assert got[2] is False and not bool(want[2])
    # rows under the mask equal the all-pairs closure
    full = np.asarray(jc.dense_closure(T0, tables))
    rows = tm.to_reference(got[1])
    np.testing.assert_array_equal(tm.to_reference(got[0])[:, rows], full[:, rows])

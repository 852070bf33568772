"""The port's delta repair against the reference, bit for bit.

* ``bitmm_or_ref`` (the plain version of the fused ``bitmm_or`` kernel)
  against the reference's Pallas ``bitmm_or_pallas`` in interpret mode and
  its jnp oracle, and the ``ops.bitmm_or`` dispatch;
* ``reverse_reachable_mask``, ``masked_repair_closure`` and
  ``masked_bitpacked_repair_closure`` against their JAX counterparts on the
  same ``(T, tables, src_mask, frozen_mask, R, C)``, overflow included;
* ``plan_repair`` / ``reverse_reach_rows`` / ``repair_state`` against the
  reference's;
* ``QueryEngine.apply_delta`` and logged edits against the JAX engine,
  mirroring tests/test_delta.py: the same edits on the same graph give the
  same pairs, cache statuses, ``DeltaStats``, repaired state and mask.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerance is exact everywhere: bit equality of states and words, set
equality of pairs.  Each reference run is made once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import closure as jclosure
from repro.core import grammar as jgrammar
from repro.core import graph as jgraph
from repro.core import matrices as jm
from repro.delta import repair as jrepair
from repro.delta.txn import StaleSnapshotError as JStale
from repro.engine import CompiledClosureCache as JPlans
from repro.engine import EngineConfig as JConfig
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro.kernels import ref as jref
from repro.kernels.bitmm import bitmm_or_pallas
from repro_torch.baselines.hellings import hellings_cfpq
from repro_torch.core import closure as tclosure
from repro_torch.core import grammar as tgrammar
from repro_torch.core import graph as tgraph
from repro_torch.core import matrices as tm
from repro_torch.delta import repair as trepair
from repro_torch.delta.txn import StaleSnapshotError
from repro_torch.engine import DeltaStats, EngineConfig, Query, QueryEngine
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitmm import bitmm_or_cuda
from torch_helpers import case

BACKENDS = ("dense", "frontier", "bitpacked", "auto")

# ---------------------------------------------------------------------- #
# bitmm_or: plain version and dispatch
# ---------------------------------------------------------------------- #

_jpack = jax.jit(jm.pack_bits)
_jbitmm_or_ref = jax.jit(jref.bitmm_or_ref)


def _both(bits):
    """(reference uint32 words, port int32 words) of the same bits."""
    return _jpack(jnp.asarray(bits)), tm.pack_bits(torch.from_numpy(bits))


def _acc_bits(rng, shape, density):
    bits = rng.random(shape) < density
    bits[..., 31::32] |= rng.random(bits[..., 31::32].shape) < 0.5  # bit 31
    return bits


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
@pytest.mark.parametrize("B", [1, 6])
@pytest.mark.parametrize("n", [128, 256])
def test_bitmm_or_ref_matches_reference(n, B, density):
    rng = np.random.default_rng(1000 * n + 10 * B + int(100 * density))
    jl, tl = _both(rng.random((B, n, n)) < density)
    jr, tr = _both(rng.random((B, n, n)) < density)
    ja, ta = _both(_acc_bits(rng, (B, n, n), density))
    got = tm.to_reference(ref.bitmm_or_ref(tl, tr, ta))
    pallas = bitmm_or_pallas(jl, jr, ja, ti=64, tw=n // 32, tk=n, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got, np.asarray(_jbitmm_or_ref(jl, jr, ja)))
    acc = tm.to_reference(ta)
    assert ((got & acc) == acc).all()  # monotone: every acc bit survives
    if density == 0.0:
        np.testing.assert_array_equal(got, acc)


@pytest.mark.parametrize(
    "B,m,k,w", [(2, 40, 64, 3), (3, 100, 256, 40), (1, 1, 32, 1), (6, 128, 512, 16)]
)
def test_bitmm_or_ref_rectangular(B, m, k, w):
    """Rectangular shapes (the repair's R-row active block against the full
    state): equal to the port's ``bitmm_ref | acc`` and to a numpy Boolean
    product OR the acc bits."""
    rng = np.random.default_rng(m * k + w)
    lhs, rhs = rng.random((B, m, k)) < 0.1, rng.random((B, k, 32 * w)) < 0.1
    acc = _acc_bits(rng, (B, m, 32 * w), 0.1)
    tl, tr, ta = (tm.pack_bits(torch.from_numpy(x)) for x in (lhs, rhs, acc))
    got = ref.bitmm_or_ref(tl, tr, ta)
    assert got.shape == (B, m, w) and got.dtype == torch.int32
    assert torch.equal(got, ref.bitmm_ref(tl, tr) | ta)
    prod = (lhs.astype(np.float32) @ rhs.astype(np.float32)) > 0
    np.testing.assert_array_equal(tm.unpack_bits(got, 32 * w).numpy(), prod | acc)


def test_bitmm_or_ref_keeps_bit_31_of_acc():
    """acc words with only bit 31 set (negative int32) come back set, with
    the product's bits ORed in beside them."""
    rng = np.random.default_rng(31)
    lhs = tm.pack_bits(torch.from_numpy(rng.random((2, 64, 128)) < 0.2))
    rhs = tm.pack_bits(torch.from_numpy(rng.random((2, 128, 128)) < 0.2))
    acc = torch.full((2, 64, 4), torch.iinfo(torch.int32).min, dtype=torch.int32)
    got = ref.bitmm_or_ref(lhs, rhs, acc)
    assert bool(((got & acc) == acc).all()) and bool((got < 0).all())
    want = ref.bitmm_ref(lhs, rhs) | acc
    np.testing.assert_array_equal(tm.to_reference(got), tm.to_reference(want))
    with pytest.raises(ValueError, match="acc is"):
        ref.bitmm_or_ref(lhs, rhs, acc[:, :10])


def test_ops_bitmm_or_on_cpu_takes_plain_version_without_launching():
    rng = np.random.default_rng(8)
    lhs = tm.pack_bits(torch.from_numpy(rng.random((3, 96, 128)) < 0.2))
    rhs = tm.pack_bits(torch.from_numpy(rng.random((3, 128, 128)) < 0.2))
    acc = tm.pack_bits(torch.from_numpy(_acc_bits(rng, (3, 96, 128), 0.2)))
    before = (ops.launches, ops.or_launches)
    assert torch.equal(ops.bitmm_or(lhs, rhs, acc), ref.bitmm_or_ref(lhs, rhs, acc))
    assert (ops.launches, ops.or_launches) == before


def test_ops_bitmm_or_off_cpu_never_takes_plain_version():
    lhs = torch.empty((1, 64, 4), dtype=torch.int32, device="meta")
    rhs = torch.empty((1, 128, 4), dtype=torch.int32, device="meta")
    acc = torch.empty((1, 64, 4), dtype=torch.int32, device="meta")
    before = ops.or_launches
    with pytest.raises(ValueError, match="not CUDA"):  # one operand off the CPU
        ops.bitmm_or(lhs.new_zeros(lhs.shape, device="cpu"),
                     rhs.new_zeros(rhs.shape, device="cpu"), acc)
    # meta operands (the dry run's): an empty output, no launch
    out = ops.bitmm_or(lhs, rhs, acc)
    assert out.is_meta and out.shape == acc.shape
    assert ops.or_launches == before


def test_bitmm_or_cuda_rejects_cpu_tensors():
    lhs = torch.zeros((1, 4, 2), dtype=torch.int32)
    rhs = torch.zeros((1, 64, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="not CUDA"):
        bitmm_or_cuda(lhs, rhs, torch.zeros((1, 4, 2), dtype=torch.int32))


# ---------------------------------------------------------------------- #
# reverse sweep and repair closures
# ---------------------------------------------------------------------- #


def test_reverse_reachable_mask_matches_reference():
    rng = np.random.default_rng(3)
    n = 60
    adj = rng.random((n, n)) < 0.03
    jsweep = jax.jit(jclosure.reverse_reachable_mask)
    for seeds in [(0,), (5, 17), tuple(rng.integers(0, n, size=6).tolist()), ()]:
        m = np.zeros(n, dtype=bool)
        m[list(seeds)] = True
        want = np.asarray(jsweep(jnp.asarray(adj), jnp.asarray(m)))
        got = tclosure.reverse_reachable_mask(torch.from_numpy(adj), torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), want)
        assert set(seeds) <= set(np.nonzero(want)[0].tolist())


#: (graph case, dense (R, C) or bitpacked R): no overflow, overflow on R,
#: overflow on the context C (dense only).  In "mixed" the nonterminal
#: that heads the binary productions also has base entries (``S -> c``),
#: so the packed step's acc carries entries no product derives.
REPAIR_CASES = ("skos:q1", "foaf:q1", "mixed")
MIXED_GRAMMAR = "S -> a S b | S S | c"
DENSE_CAPS = {"fits": (128, None), "overflow R": (2, None), "overflow C": (64, 16)}
PACKED_CAPS = {"fits": 128, "overflow R": 2}


@pytest.fixture(scope="module", params=REPAIR_CASES)
def repair_input(request):
    """A cached state of the case: frozen rows hold exact closure rows,
    the rest base rows; seeds are a few non-frozen rows."""
    if request.param == "mixed":
        jg = jgraph.random_labeled_graph(40, 100, ["a", "b", "c"], seed=11)
        jgr = jgrammar.Grammar.from_text(MIXED_GRAMMAR).to_cnf()
        tgr = tgrammar.Grammar.from_text(MIXED_GRAMMAR).to_cnf()
        heads = {a for a, _, _ in jgr.binary_prods}
        assert heads & {a for v in jgr.term_prods.values() for a in v}
    else:
        jg, jgr, _, tgr, _ = case(request.param)
    tables = jm.ProductionTables.from_grammar(jgr)
    T0 = np.asarray(jm.init_matrix(jg, jgr))
    full = np.asarray(jclosure.dense_closure(jnp.asarray(T0), tables))
    n = T0.shape[-1]
    rng = np.random.default_rng(5)
    frozen = np.zeros(n, dtype=bool)
    frozen[rng.choice(jg.n_nodes, size=jg.n_nodes // 2, replace=False)] = True
    src = np.zeros(n, dtype=bool)
    src[rng.choice(np.nonzero(~frozen[: jg.n_nodes])[0], size=3, replace=False)] = True
    T = np.where(frozen[None, :, None], full, T0)
    return request.param, T, tables, tm.ProductionTables.from_grammar(tgr), src, frozen, full


def _assert_repair_contract(got, T_in, frozen, full):
    T, M, overflow = got
    np.testing.assert_array_equal(T[:, frozen, :], T_in[:, frozen, :])
    assert not (M & frozen).any()
    if not overflow:
        np.testing.assert_array_equal(T[:, M, :], full[:, M, :])


@pytest.mark.parametrize("caps", sorted(DENSE_CAPS))
def test_masked_repair_closure_matches_reference(repair_input, caps):
    name, T, jtables, ttables, src, frozen, full = repair_input
    R, C = DENSE_CAPS[caps]
    want = jclosure.masked_repair_closure(
        jnp.asarray(T), jtables, jnp.asarray(src), jnp.asarray(frozen),
        row_capacity=R, ctx_capacity=C,
    )
    got = tclosure.masked_repair_closure(
        torch.from_numpy(T), ttables, torch.from_numpy(src),
        torch.from_numpy(frozen), row_capacity=R, ctx_capacity=C,
    )
    want = tuple(np.asarray(x) for x in want)
    got = tuple(x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert bool(got[2]) == (caps != "fits"), (name, caps)
    _assert_repair_contract(got, T, frozen, full)


@pytest.mark.parametrize("caps", sorted(PACKED_CAPS))
def test_masked_bitpacked_repair_closure_matches_reference(repair_input, caps):
    name, T, jtables, ttables, src, frozen, full = repair_input
    R = PACKED_CAPS[caps]
    want = jclosure.masked_bitpacked_repair_closure(
        jnp.asarray(T), jtables, jnp.asarray(src), jnp.asarray(frozen),
        row_capacity=R,
    )
    before = ops.or_launches
    got = tclosure.masked_bitpacked_repair_closure(
        torch.from_numpy(T), ttables, torch.from_numpy(src),
        torch.from_numpy(frozen), row_capacity=R,
    )
    assert ops.or_launches == before  # CPU tensors: the plain version
    want = tuple(np.asarray(x) for x in want)
    got = tuple(x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert bool(got[2]) == (caps != "fits"), (name, caps)
    _assert_repair_contract(got, T, frozen, full)


def test_repair_closures_without_productions_return_every_row():
    T = torch.from_numpy(np.random.default_rng(0).random((1, 128, 128)) < 0.1)
    tables = tm.ProductionTables((), (), (), 1)
    none = torch.zeros(128, dtype=torch.bool)
    for fn in (tclosure.masked_repair_closure, tclosure.masked_bitpacked_repair_closure):
        out, M, overflow = fn(T, tables, none, none)
        assert torch.equal(out, T) and bool(M.all()) and not overflow


# ---------------------------------------------------------------------- #
# planning and state repair (delta/repair.py)
# ---------------------------------------------------------------------- #

INSERT = [(1, "subClassOf", 4), (8, "type", 3), (0, "type", 5)]


def _edited(pkg):
    """An ontology graph, its edits since version 0, and the edit itself."""
    graph = pkg.ontology_graph(30, 60, seed=2)
    victims = [graph.edges[3], graph.edges[11]]
    graph.delete_edges(victims)
    graph.insert_edges(INSERT)
    return graph, graph.delta_since(0)


def test_plan_repair_and_reverse_reach_match_reference():
    jg, jdelta = _edited(jgraph)
    tg, tdelta = _edited(tgraph)
    assert (sorted(tdelta.inserted), sorted(tdelta.deleted)) == (
        sorted(jdelta.inserted), sorted(jdelta.deleted)
    )
    want, got = jrepair.plan_repair(jg, jdelta, 128), trepair.plan_repair(tg, tdelta, 128)
    for field in ("evict", "affected", "ins_sources"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.touches_anything and want.touches_anything
    for seeds in [(0,), (4, 17), (), (200,)]:
        np.testing.assert_array_equal(
            trepair.reverse_reach_rows(tg.n_nodes, tg.edges, seeds, pad_to=128),
            jrepair.reverse_reach_rows(jg.n_nodes, jg.edges, seeds, pad_to=128),
        )


@pytest.mark.parametrize("kind", ["dense", "bitpacked"])
def test_repair_state_matches_reference(kind):
    """One cached all-pairs state repaired by both packages' ``repair_state``
    after the same deletes and inserts: same host state, mask and stats;
    the port's host copy equals its device state (only written rows were
    copied back); rows under the mask equal a scratch closure."""
    jg, jdelta = _edited(jgraph)
    tg, tdelta = _edited(tgraph)
    jgr = jgrammar.query1_grammar().to_cnf()
    tgr = tgrammar.query1_grammar().to_cnf()
    jt, tt = jm.ProductionTables.from_grammar(jgr), tm.ProductionTables.from_grammar(tgr)
    pre = jgraph.ontology_graph(30, 60, seed=2)  # the graph before the edits
    n = 128
    cached = np.asarray(jclosure.dense_closure(jm.init_matrix(pre, jgr), jt))
    mask = np.zeros(n, dtype=bool)
    mask[: pre.n_nodes] = True
    jfn = {"dense": jclosure.masked_repair_closure,
           "bitpacked": jclosure.masked_bitpacked_repair_closure}[kind]
    tfn = {"dense": tclosure.masked_repair_closure,
           "bitpacked": tclosure.masked_bitpacked_repair_closure}[kind]

    def jrun(T, seed, frozen):
        T, M, _ = jfn(T, jt, jnp.asarray(seed), jnp.asarray(frozen), row_capacity=n)
        return T, np.asarray(M), 1

    def trun(T, seed, frozen):
        T, M, _ = tfn(T, tt, torch.from_numpy(seed), torch.from_numpy(frozen),
                      row_capacity=n)
        return T, M.numpy(), 1

    want = jrepair.repair_state(
        cached, jnp.asarray(cached), mask, jrepair.plan_repair(jg, jdelta, n),
        lambda idx: jm.init_matrix_rows(jg, jgr, idx, pad_to=n), jrun,
    )
    host = np.array(cached, copy=True)
    got = trepair.repair_state(
        host, torch.from_numpy(np.array(cached, copy=True)), mask,
        trepair.plan_repair(tg, tdelta, n),
        lambda idx: tm.init_matrix_rows(tg, tgr, idx, pad_to=n), trun,
    )
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0], got[1].numpy())
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3].as_dict() == want[3].as_dict()
    assert got[3].rows_evicted > 0 and got[3].rows_repaired > 0
    scratch = tclosure.dense_closure(tm.init_matrix(tg, tgr, pad_to=n, device="cpu"), tt)
    M = got[2]
    np.testing.assert_array_equal(got[0][:, M, :], scratch.numpy()[:, M, :])


def test_delta_stats_keys_match_reference():
    a = DeltaStats(rows_repaired=3, rows_evicted=1, repair_iters=2)
    a.merge(DeltaStats(rows_repaired=1, repair_iters=1))
    b = jrepair.DeltaStats(rows_repaired=3, rows_evicted=1, repair_iters=2)
    b.merge(jrepair.DeltaStats(rows_repaired=1, repair_iters=1))
    assert a.as_dict() == b.as_dict()
    assert trepair.placement_of(torch.zeros(1)) == "local"


# ---------------------------------------------------------------------- #
# the engine against the JAX engine (mirrors tests/test_delta.py)
# ---------------------------------------------------------------------- #


class _Side:
    """One package's constructors, so a scenario runs unchanged on both."""

    def __init__(self, graph, grammar, engine, config, query, stale, **config_kw):
        self.graph, self.grammar = graph, grammar
        self._engine, self._config, self.Query = engine, config, query
        self.Stale, self._kw = stale, config_kw
        self.plans = JPlans() if engine is JEngine else None

    def engine(self, graph, backend="auto"):
        kw = {"plans": self.plans} if self.plans is not None else {}
        return self._engine(graph, config=self._config(engine=backend, **self._kw), **kw)

    def q1(self):
        return self.grammar.query1_grammar().to_cnf()


# the JAX engines of this module share one plan cache: compiles, not data
JAX = _Side(jgraph, jgrammar, JEngine, JConfig, JQuery, JStale)
PORT = _Side(tgraph, tgrammar, QueryEngine, EngineConfig, Query, StaleSnapshotError,
             device="cpu")


def _res(r):
    s = r.stats
    return (r.pairs, s["cache"], s["rows_repaired"], s["rows_evicted"],
            s["repair_iters"], s["epoch"])


def _state(eng):
    (st,) = eng._states.values()
    return np.array(st.T_host, copy=True), np.array(st.mask, copy=True)


def sc_insert(side, backend):
    """test_delta.py::test_insert_repair_matches_scratch"""
    g, graph = side.q1(), side.graph.ontology_graph(30, 60, seed=1)
    eng = side.engine(graph, backend)
    q = side.Query(g, "S", sources=(0, 3, 7))
    out = [_res(eng.query(q))]
    st = eng.apply_delta(insert=[(0, "type", 5), (5, "subClassOf", 3), (9, "type_r", 2)])
    out += [st.as_dict(), _res(eng.query(q))]
    return out, _state(eng), graph


def sc_delete(side, backend):
    """test_delta.py::test_delete_evicts_and_recomputes"""
    g, graph = side.q1(), side.graph.ontology_graph(30, 60, seed=1)
    eng = side.engine(graph, backend)
    q = side.Query(g, "S", sources=(0, 3, 7))
    out = [_res(eng.query(q))]
    st = eng.apply_delta(delete=[graph.edges[0]])
    out += [st.as_dict(), _res(eng.query(q))]
    return out, _state(eng), graph


def sc_contract(side, backend):
    """test_delta.py::test_repair_contract_rows_bit_identical_to_scratch"""
    g, graph = side.q1(), side.graph.ontology_graph(30, 60, seed=2)
    eng = side.engine(graph, backend)
    out = [_res(eng.query(side.Query(g, "S", sources=(0, 5))))]
    st = eng.apply_delta(
        insert=[(1, "subClassOf", 4), (8, "type", 3)], delete=[graph.edges[3]]
    )
    out.append(st.as_dict())
    return out, _state(eng), graph


#: per-backend seeds of the interleaving (the reference's own for its three)
INTERLEAVE_SEEDS = {"bitpacked": 0, "dense": 2, "frontier": 3, "auto": 7}


def sc_interleave(side, backend):
    """test_delta.py::test_differential_random_interleaving"""
    rng = np.random.default_rng(INTERLEAVE_SEEDS[backend])
    g = side.grammar.Grammar.from_text("S -> a S b | a b").to_cnf()
    n = 24
    graph = side.graph.random_labeled_graph(n, 50, ["a", "b"], seed=7)
    graph.edges[:] = sorted(set(graph.edges))
    eng = side.engine(graph, backend)
    out = []

    def random_edge():
        return (int(rng.integers(0, n)), ["a", "b"][int(rng.integers(0, 2))],
                int(rng.integers(0, n)))

    for _ in range(12):
        op = rng.random()
        if op < 0.35 and graph.edges:
            victim = graph.edges[int(rng.integers(0, len(graph.edges)))]
            out.append(eng.apply_delta(delete=[victim]).as_dict())
        elif op < 0.7:
            out.append(eng.apply_delta(insert=[random_edge() for _ in range(2)]).as_dict())
        sources = tuple(sorted(set(int(s) for s in rng.integers(0, n, size=3))))
        out.append((sources, _res(eng.query(side.Query(g, "S", sources=sources)))))
    return out, _state(eng), (graph, g)


SCENARIOS = {"insert": sc_insert, "delete": sc_delete, "contract": sc_contract,
             "interleave": sc_interleave}
_REFERENCE: dict = {}


def _compare(name, backend):
    """Run a scenario on both engines; assert every record and the final
    state and mask equal.  Returns the port's run."""
    key = (name, backend)
    if key not in _REFERENCE:
        _REFERENCE[key] = SCENARIOS[name](JAX, backend)
    want_out, (want_T, want_M), _ = _REFERENCE[key]
    got_out, (got_T, got_M), extra = SCENARIOS[name](PORT, backend)
    assert got_out == want_out
    np.testing.assert_array_equal(got_M, want_M)
    np.testing.assert_array_equal(got_T, want_T)
    return got_out, got_T, got_M, extra


def _oracle(graph, g, sources):
    rel = hellings_cfpq(graph, g)["S"]
    return {(i, j) for i, j in rel if i in sources}


@pytest.mark.parametrize("backend", BACKENDS)
def test_insert_repair_matches_reference(backend):
    out, _, _, graph = _compare("insert", backend)
    st, after = out[1], out[2]
    assert st["rows_repaired"] > 0 and st["repair_iters"] >= 1
    assert after[1] == "hit"  # repaired eagerly, not dropped
    assert after[0] == _oracle(graph, PORT.q1(), (0, 3, 7))


@pytest.mark.parametrize("backend", BACKENDS)
def test_delete_evicts_like_reference(backend):
    out, _, _, graph = _compare("delete", backend)
    st, after = out[1], out[2]
    assert st["rows_evicted"] > 0
    assert after[1] in ("warm", "hit")
    assert after[0] == _oracle(graph, PORT.q1(), (0, 3, 7))


@pytest.mark.parametrize("backend", BACKENDS)
def test_repair_contract_rows_match_reference_and_scratch(backend):
    _, T, M, graph = _compare("contract", backend)
    g = PORT.q1()
    tables = tm.ProductionTables.from_grammar(g)
    scratch = tclosure.dense_closure(
        tm.init_matrix(graph, g, pad_to=T.shape[-1], device="cpu"), tables
    ).numpy()
    assert M.any()
    np.testing.assert_array_equal(T[:, M, :], scratch[:, M, :])


@pytest.mark.parametrize("backend", BACKENDS)
def test_random_interleaving_matches_reference(backend):
    out, _, _, (graph, g) = _compare("interleave", backend)
    # the last query against Hellings on the final graph
    sources, last = out[-1]
    assert last[0] == _oracle(graph, g, sources)


def test_compact_log_truncates_and_errors_like_reference():
    def run(pkg):
        g = pkg.Graph(5, [(0, "a", 1)])
        g.insert_edges([(1, "a", 2)])
        g.insert_edges([(2, "a", 3)])
        g.delete_edges([(0, "a", 1)])
        out = [g.compact_log(2), g.delta_since(2), bool(g.delta_since(3))]
        for call in (lambda: g.delta_since(0), lambda: g.delta_since(1),
                     lambda: g.compact_log(99)):
            with pytest.raises(ValueError) as err:
                call()
            out.append(str(err.value))
        out.append(g.compact_log(1))
        d = out[1]
        out[1] = (sorted(d.inserted), sorted(d.deleted))
        return out

    assert run(tgraph) == run(jgraph)


def _tiny(side):
    graph = side.graph.Graph(3, [(0, "a", 1)])
    return graph, side.grammar.Grammar.from_text("S -> a").to_cnf()


def sc_noop_tail(side):
    """test_delta.py::test_compaction_of_noop_tail_resyncs_without_drop_or_crash"""
    graph, g = _tiny(side)
    eng = side.engine(graph)
    q = side.Query(g, "S", sources=(0,))
    out = [_res(eng.query(q))]
    graph.insert_edges([(1, "a", 2)])
    graph.delete_edges([(1, "a", 2)])
    graph.compact_log(graph.version)
    out.append(_res(eng.query(q)))
    out.append(eng.apply_delta(insert=[(0, "a", 2)]).as_dict())
    out.append(_res(eng.query(q)))
    return out


def sc_compacted_drop(side):
    """test_delta.py::test_engine_falls_back_to_full_drop_after_compaction"""
    graph, g = _tiny(side)
    eng = side.engine(graph)
    q = side.Query(g, "S", sources=(0,))
    out = [_res(eng.query(q))]
    graph.insert_edges([(0, "a", 2)])
    graph.compact_log(graph.version)
    out.append(_res(eng.query(q)))
    return out


def test_compaction_of_noop_tail_resyncs_like_reference():
    got = sc_noop_tail(PORT)
    assert got == sc_noop_tail(JAX)
    assert got[1][1] == "hit" and got[3][0] == {(0, 1), (0, 2)}


def test_falls_back_to_full_drop_after_compaction_like_reference():
    got = sc_compacted_drop(PORT)
    assert got == sc_compacted_drop(JAX)
    assert got[1][1] == "miss" and got[1][0] == {(0, 1), (0, 2)}


def sc_snapshots(side):
    """test_delta.py::test_apply_delta_never_serves_stale_rows_under_snapshot"""
    g, graph = side.q1(), side.graph.ontology_graph(30, 60, seed=4)
    eng = side.engine(graph, "dense")
    q = side.Query(g, "S", sources=(0, 2))
    out = [_res(eng.query(q))]
    snap = eng.snapshot()
    out.append(eng.apply_delta(insert=[(0, "type", 9)]).as_dict())
    with pytest.raises(side.Stale):
        eng.query(q, snapshot=snap)
    out.append(_res(eng.query(q, snapshot=eng.snapshot())))
    snap1 = eng.snapshot()
    graph.insert_edges([(1, "type", 9)])  # logged, ingested at the next batch
    with pytest.raises(side.Stale):
        eng.query(q, snapshot=snap1)
    out.append(_res(eng.query(q)))
    return out, graph


def test_apply_delta_never_serves_stale_rows_like_reference():
    got, graph = sc_snapshots(PORT)
    assert got == sc_snapshots(JAX)[0]
    assert [r[5] for r in (got[0], got[2], got[3])] == [0, 1, 2]
    assert got[3][0] == _oracle(graph, PORT.q1(), (0, 2))


def sc_out_of_band(side):
    """test_delta.py::test_out_of_band_edit_still_invalidates_and_advances_epoch"""
    graph, g = _tiny(side)
    eng = side.engine(graph)
    snap = eng.snapshot()
    q = side.Query(g, "S", sources=(0,))
    out = [_res(eng.query(q))]
    graph.edges.append((0, "a", 2))  # bypasses the log
    out.append(_res(eng.query(q)))
    with pytest.raises(side.Stale):
        eng.query(q, snapshot=snap)
    return out


def test_out_of_band_edit_invalidates_like_reference():
    got = sc_out_of_band(PORT)
    assert got == sc_out_of_band(JAX)
    assert got[1][1] == "miss" and got[1][0] == {(0, 1), (0, 2)}


def sc_concurrent_out_of_band(side):
    """test_delta.py::test_out_of_band_edit_concurrent_with_logged_edit_not_masked"""
    graph = side.graph.Graph(8, [(0, "a", 1)])
    g = side.grammar.Grammar.from_text("S -> a | b").to_cnf()
    eng = side.engine(graph)
    out = [_res(eng.query(side.Query(g, "S", sources=(5,))))]
    graph.edges.append((5, "a", 6))  # out-of-band
    graph.insert_edges([(6, "b", 7)])  # logged, same window
    out.append(_res(eng.query(side.Query(g, "S", sources=(5, 6)))))
    return out


def test_out_of_band_edit_with_logged_edit_not_masked_like_reference():
    got = sc_concurrent_out_of_band(PORT)
    assert got == sc_concurrent_out_of_band(JAX)
    assert got[1][1] == "miss" and got[1][0] == {(5, 6), (6, 7)}


def sc_stats(side):
    """test_delta.py::test_delta_stats_surfaced_in_query_results"""
    g, graph = side.q1(), side.graph.ontology_graph(30, 60, seed=5)
    eng = side.engine(graph, "dense")
    q = side.Query(g, "S", sources=(0,))
    eng.query(q)
    eng.apply_delta(insert=[(0, "type", 3)])
    eng.apply_delta(delete=[graph.edges[0]])
    s = eng.query(q).stats
    return {k: s[k] for k in DeltaStats().as_dict()} | {"epoch": s["epoch"]}


def test_delta_stats_surfaced_like_reference():
    got = sc_stats(PORT)
    assert got == sc_stats(JAX)
    assert got["rows_repaired"] > 0 and got["rows_evicted"] > 0
    assert got["repair_iters"] >= 1 and got["epoch"] == 2


def sc_noop(side):
    """test_delta.py::test_noop_delta_does_not_advance_epoch_or_drop_cache"""
    g, graph = side.q1(), side.graph.ontology_graph(30, 60, seed=6)
    eng = side.engine(graph, "dense")
    q = side.Query(g, "S", sources=(0,))
    eng.query(q)
    st = eng.apply_delta(insert=[graph.edges[0]])  # already present
    return st.as_dict(), eng.clock.epoch, _res(eng.query(q))


def test_noop_delta_keeps_epoch_and_cache_like_reference():
    got = sc_noop(PORT)
    assert got == sc_noop(JAX)
    assert got[0]["rows_repaired"] == 0 and got[1] == 0 and got[2][1] == "hit"


def test_repair_runs_under_a_delta_span_with_host_copy():
    """The repair's spans nest as the reference's do (delta.repair over
    planner/closure.execute with ``repair=True``), and the port's copy back
    to the host is its own span; the delta counters reach the metrics."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    tracer, registry = Tracer(), MetricsRegistry()
    graph = tgraph.ontology_graph(30, 60, seed=1)
    eng = QueryEngine(graph, config=EngineConfig(engine="bitpacked", device="cpu"),
                      tracer=tracer, metrics=registry)
    eng.query(Query(PORT.q1(), "S", sources=(0, 3)))
    st = eng.apply_delta(insert=[(0, "type", 5)])
    names = [s.name for s in tracer.spans]
    assert "delta.repair" in names and "delta.host_copy" in names
    repairs = [s for s in tracer.spans
               if s.name == "closure.execute" and s.attrs.get("repair")]
    assert repairs and all(s.attrs["engine"] == "bitpacked" for s in repairs)
    assert eng.metrics.delta_rows_repaired.value == st.rows_repaired > 0
    assert eng.metrics.delta_epoch.value == 1

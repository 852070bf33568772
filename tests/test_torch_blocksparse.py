"""The port's block-sparse backend against the reference's, bit for bit.

Mirrors tests/test_blocksparse.py: every case runs through
``repro.core.blocksparse`` and ``repro_torch.core.blocksparse`` on the same
inputs (built with numpy from a seed), and the closed state, the mask, the
overflow flag, the ``iter_hook`` events and the slot coordinates must be
equal — the Gauss–Seidel chunk order, the two-phase slot allocation and
the overflow rule included.  Where the reference's test checks against the
dense closure or the Hellings baseline, so does this one.  The tile entry
of the TPU kernel: the port's ``tile_contract_ref`` against the
reference's ``_contract_chunk`` and ``tile_bitmm_ref`` against the Pallas
``tile_bitmm`` (interpret mode, at most 16 pairs).  Each reference result
is computed once, through the module-scoped ``reference`` fixture.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import blocksparse as jbs
from repro.core import closure as jclosure
from repro.core import grammar as jgrammar
from repro.core import graph as jgraph
from repro.core import matrices as jm
from repro.engine import EngineConfig as JConfig
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro.engine.service import grammar_key as jgrammar_key
from repro.kernels import ops as jops
from repro_torch.baselines.hellings import hellings_cfpq
from repro_torch.core import blocksparse as tbs
from repro_torch.core import grammar as tgrammar
from repro_torch.core import graph as tgraph
from repro_torch.core import matrices as tm
from repro_torch.core.semantics import evaluate_relational
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.engine.service import grammar_key
from repro_torch.kernels import ops, ref
from repro_torch.obs.metrics import MetricsRegistry
from helpers import SPARSE_FAMILIES, random_cnf, random_graph, sparse_graph
from torch_helpers import port_grammar, port_graph

CPU = torch.device("cpu")


def _events():
    """An ``iter_hook`` that records its events as plain tuples."""
    out = []

    def hook(it, rows, changed, overflow):
        out.append((int(it), int(rows), int(changed), bool(overflow)))

    hook.events = out
    return hook


def _jrun(fn, T0, *masks, **kw):
    hook = _events()
    T, M, ov = fn(T0, *masks, iter_hook=hook, **kw)
    return np.asarray(T), np.asarray(M), bool(ov), hook.events


def _trun(fn, T0, *masks, **kw):
    hook = _events()
    T, M, ov = fn(T0, *masks, iter_hook=hook, **kw)
    return T.numpy(), M.numpy(), bool(ov), hook.events


def _assert_same(got, want):
    (Tg, Mg, og, eg), (Tw, Mw, ow, ew) = got, want
    np.testing.assert_array_equal(Tg, Tw)
    np.testing.assert_array_equal(Mg, Mw)
    assert og == ow
    assert eg == ew


class Case:
    """One graph and grammar in both packages' objects, with their base
    tensors and production tables."""

    def __init__(self, graph, g):
        self.jgraph, self.jg = graph, g
        self.tgraph, self.tg = port_graph(graph), port_grammar(g)
        self.jtables = jm.ProductionTables.from_grammar(g)
        self.ttables = tm.ProductionTables.from_grammar(self.tg)
        self.jT0 = jm.init_matrix(graph, g)
        self.tT0 = tm.init_matrix(self.tgraph, self.tg, device=CPU)
        self.n = self.tT0.shape[-1]
        np.testing.assert_array_equal(np.asarray(self.jT0), self.tT0.numpy())

    def masked(self, mask, **kw):
        """(port, reference) results of the masked closure from ``mask``."""
        return (
            _trun(tbs.masked_blocksparse_closure, self.tT0, self.ttables,
                  torch.from_numpy(mask), **kw),
            _jrun(jbs.masked_blocksparse_closure, self.jT0, self.jtables,
                  mask, **kw),
        )


def _random_case(seed, n_nodes, n_edges):
    rng = np.random.default_rng(seed)
    g = random_cnf(rng)
    graph = random_graph(
        rng, n_nodes=int(rng.integers(*n_nodes)), n_edges=int(rng.integers(*n_edges))
    )
    return Case(graph, g)


def _anbn():
    return jgrammar.Grammar.from_text("S -> a S b | a b").to_cnf()


@pytest.fixture(scope="module")
def reference():
    """Memoized reference results, keyed by what the test computes."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


# ---------------------------------------------------------------------- #
# Fixed-seed differential: port vs reference vs dense vs Hellings
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_seed_differential(tile, seed):
    """All-pairs: the port's state, mask, overflow flag and iteration
    events equal the reference's; the state equals the dense closure and
    the relation equals Hellings."""
    c = _random_case(seed, (5, 14), (8, 32))
    ones = np.ones(c.n, dtype=bool)
    got, want = c.masked(ones, row_capacity=c.n, tile=tile)
    _assert_same(got, want)
    assert not got[2] and got[1].all()
    dense = np.asarray(jclosure.dense_closure(c.jT0, c.jtables))
    np.testing.assert_array_equal(got[0], dense)
    rel = tm.relations_from_matrix(torch.from_numpy(got[0]), c.tg, c.tgraph.n_nodes)
    assert rel == hellings_cfpq(c.tgraph, c.tg)


@pytest.mark.parametrize("family", SPARSE_FAMILIES)
def test_sparse_families_differential(family):
    rng = np.random.default_rng(5)
    c = Case(sparse_graph(family, rng, 40, density=1.5), _anbn())
    got, want = c.masked(np.ones(c.n, dtype=bool), row_capacity=c.n, tile=32)
    _assert_same(got, want)
    assert not got[2]


@pytest.mark.parametrize("round_", [0, 1, 2])
def test_masked_rows_exact_under_sparse_mask(round_):
    """A restricted seed (rows 0-2): the port equals the reference, and its
    rows under M equal the all-pairs closure."""
    rng = np.random.default_rng(9 + round_)
    g = random_cnf(rng)
    c = Case(random_graph(rng, n_nodes=12, n_edges=30), g)
    seed = np.zeros(c.n, dtype=bool)
    seed[:3] = True
    got, want = c.masked(seed, row_capacity=c.n, tile=32)
    _assert_same(got, want)
    full = np.asarray(jclosure.dense_closure(c.jT0, c.jtables))
    M = got[1]
    np.testing.assert_array_equal(got[0][:, M, :], full[:, M, :])


# ---------------------------------------------------------------------- #
# Warm-restart / block-growth boundaries
# ---------------------------------------------------------------------- #


def _ladder(fn, T0, tables, seed, cap, tile, to_host):
    """The engine-style doubling ladder from block capacity ``cap``; every
    rung's (T, M, overflow) on the host, as a list."""
    n = T0.shape[-1]
    T, M, overflow = T0, seed, True
    rungs = []
    while overflow:
        assert len(rungs) < 30, "ladder did not terminate"
        T, M, overflow = fn(T, tables, M, row_capacity=cap, tile=tile)
        rungs.append((to_host(T), to_host(M), bool(overflow)))
        cap = min(n, max(2 * cap, 2))
    return rungs


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("cap_kind", ["one", "B-1", "B", "n"])
def test_capacity_boundary_ladder(tile, cap_kind):
    """Block capacities at the growth boundaries R in {1, B-1, B, n}: every
    rung of the port's ladder (partial state, mask, overflow) equals the
    reference's, and the last lands on the exact closure."""
    g = _anbn()
    c = Case(jgraph.random_labeled_graph(20, 46, ["a", "b"], seed=13), g)
    cap = {"one": 1, "B-1": tile - 1, "B": tile, "n": c.n}[cap_kind]
    seed = np.zeros(c.n, dtype=bool)
    seed[: c.tgraph.n_nodes] = True
    got = _ladder(tbs.masked_blocksparse_closure, c.tT0, c.ttables,
                  torch.from_numpy(seed), cap, tile, lambda x: x.numpy())
    want = _ladder(jbs.masked_blocksparse_closure, c.jT0, c.jtables, seed,
                   cap, tile, np.asarray)
    assert len(got) == len(want)
    for (Tg, Mg, og), (Tw, Mw, ow) in zip(got, want):
        np.testing.assert_array_equal(Tg, Tw)
        np.testing.assert_array_equal(Mg, Mw)
        assert og == ow
    if cap_kind == "n":
        assert len(got) == 1  # unbounded: one call reaches the fixpoint
    T, M, _ = got[-1]
    full = np.asarray(jclosure.dense_closure(c.jT0, c.jtables))
    np.testing.assert_array_equal(T[:, M, :], full[:, M, :])
    assert M[: c.tgraph.n_nodes].all()


def test_overflow_returns_monotone_partial_state():
    """At capacity 1 the port returns the reference's partial state: a
    superset of the input, a mask holding the seed, overflow set."""
    c = Case(jgraph.random_labeled_graph(24, 60, ["a", "b"], seed=2), _anbn())
    seed = np.zeros(c.n, dtype=bool)
    seed[: c.tgraph.n_nodes] = True
    got, want = c.masked(seed, row_capacity=1, tile=32)
    _assert_same(got, want)
    T1, M1, ov, _ = got
    assert ov
    assert (c.tT0.numpy() <= T1).all()
    assert (seed <= M1).all()


# ---------------------------------------------------------------------- #
# State construction / validation / gauges
# ---------------------------------------------------------------------- #


def _same_state(got: tbs.BlockSparseState, want: jbs.BlockSparseState):
    assert got.coords == want.coords
    assert got.index == want.index
    assert (got.n, got.tile, got.grid, got.n_nonterms) == (
        want.n, want.tile, want.grid, want.n_nonterms
    )
    assert tuple(got.tiles.shape) == tuple(want.tiles.shape)
    np.testing.assert_array_equal(
        tm.to_reference(got.tiles), np.asarray(want.tiles)
    )
    assert got.nbytes() == want.nbytes()


@pytest.mark.parametrize("round_", [0, 1, 2])
def test_from_graph_matches_init_matrix(round_):
    """``from_graph`` gives the reference's slots, coordinates and words;
    its dense form is the base tensor; ``from_dense`` of that tensor is the
    same state."""
    rng = np.random.default_rng(17 + round_)
    g = random_cnf(rng)
    c = Case(random_graph(rng, n_nodes=13, n_edges=28), g)
    state = tbs.BlockSparseState.from_graph(c.tgraph, c.tg, tile=32, device=CPU)
    _same_state(state, jbs.BlockSparseState.from_graph(c.jgraph, c.jg, tile=32))
    np.testing.assert_array_equal(state.to_dense().numpy(), c.tT0.numpy())
    assert state.nbytes() == state.occupied * 32 * 1 * 4
    assert state.occupied == tbs.occupied_block_count(c.tT0, 32)
    _same_state(tbs.BlockSparseState.from_dense(c.tT0, 32),
                jbs.BlockSparseState.from_dense(c.jT0, 32))


def test_standalone_state_closure_never_densifies(monkeypatch, reference):
    """The million-node entry point: the closure on the compacted state
    equals the reference's slot for slot and the dense all-pairs closure,
    without the dense tensor ever being built."""
    rng = np.random.default_rng(23)
    g = _anbn()
    graph = sparse_graph("community", rng, 48, density=1.0)
    c = Case(graph, g)
    want = reference(
        "standalone", lambda: jbs.blocksparse_closure_state(graph, g, tile=32)
    )

    def no_dense(*_, **__):
        raise AssertionError("the standalone closure built a dense tensor")

    monkeypatch.setattr(tbs.BlockSparseState, "to_dense", no_dense)
    monkeypatch.setattr(tbs.BlockSparseState, "from_dense", no_dense)
    monkeypatch.setattr(tm, "init_matrix", no_dense)
    state = tbs.blocksparse_closure_state(c.tgraph, c.tg, tile=32, device=CPU)
    monkeypatch.undo()
    _same_state(state, want)
    full = np.asarray(jclosure.dense_closure(c.jT0, c.jtables))
    np.testing.assert_array_equal(state.to_dense().numpy(), full)
    assert state.occupied == tbs.occupied_block_count(full, 32)
    a = c.tg.index_of("S")
    assert state.pairs_for(a, 0, nonterm_rows=True) == want.pairs_for(
        a, 0, nonterm_rows=True
    )


@pytest.mark.parametrize("sources", [(0, 1), (40,)])
def test_standalone_state_from_sources_matches_reference(sources):
    rng = np.random.default_rng(29)
    g = _anbn()
    graph = sparse_graph("chain", rng, 100)
    want = jbs.blocksparse_closure_state(graph, g, tile=32, sources=sources)
    got = tbs.blocksparse_closure_state(
        port_graph(graph), port_grammar(g), tile=32, sources=sources, device=CPU
    )
    _same_state(got, want)


def test_tile_validation():
    tg = tgrammar.Grammar.from_text("S -> a").to_cnf()
    graph = tgraph.Graph(3, [(0, "a", 1)])
    tables = tm.ProductionTables.from_grammar(tg)
    T0 = tm.init_matrix(graph, tg, device=CPU)  # padded n is a multiple of 128
    ones = torch.ones(T0.shape[-1], dtype=torch.bool)
    with pytest.raises(ValueError, match="not a multiple of tile 96"):
        tbs.masked_blocksparse_closure(T0, tables, ones, tile=96)
    with pytest.raises(ValueError, match="not a multiple of tile 96"):
        tbs.masked_blocksparse_repair_closure(T0, tables, ones, ~ones, tile=96)
    with pytest.raises(ValueError, match="multiple of 32"):
        tbs.BlockSparseState(T0.shape[-1], 1, tile=48, device=CPU)
    with pytest.raises(ValueError, match="multiple of 32"):
        EngineConfig(engine="blocksparse", tile=31)
    with pytest.raises(ValueError, match="multiple of 32"):
        JConfig(engine="blocksparse", tile=31)


def test_zero_production_grammar_passthrough():
    tg = tgrammar.Grammar.from_text("S -> a").to_cnf()
    graph = tgraph.Graph(4, [(0, "a", 1), (1, "a", 2)])
    tables = tm.ProductionTables.from_grammar(tg)
    T0 = tm.init_matrix(graph, tg, device=CPU)
    zeros = torch.zeros(T0.shape[-1], dtype=torch.bool)
    for fn, masks in ((tbs.masked_blocksparse_closure, (zeros,)),
                      (tbs.masked_blocksparse_repair_closure, (zeros, zeros))):
        T, M, ov = fn(T0, tables, *masks)
        assert torch.equal(T, T0) and bool(M.all()) and ov is False


def test_occupied_blocks_of_edges_counts_base_grid():
    edges = [(0, "a", 1), (0, "a", 200), (150, "b", 299)]
    assert tbs.occupied_blocks_of_edges(300, edges, 128) == 3
    graph = jgraph.paper_table_graph("pizza").repeat(16)
    for tile in (32, 64, 128):
        assert tbs.occupied_blocks_of_edges(
            graph.n_nodes, graph.edges, tile
        ) == jbs.occupied_blocks_of_edges(graph.n_nodes, graph.edges, tile)


def test_blocksparse_occupied_block_gauge_set(reference):
    """The engine's gauge after a blocksparse-served closure equals the
    reference engine's."""
    from repro.obs.metrics import MetricsRegistry as JRegistry

    g = _anbn()

    def gauge(reg):
        return reg.collect()["blocksparse_occupied_blocks"]["series"][0]["value"]

    def run_reference():
        reg = JRegistry()
        graph = jgraph.random_labeled_graph(16, 36, ["a", "b"], seed=6)
        eng = JEngine(graph, config=JConfig(engine="blocksparse"), metrics=reg)
        eng.query(JQuery(g, "S", sources=(0, 1)))
        return gauge(reg)

    want = reference("gauge", run_reference)
    reg = MetricsRegistry()
    graph = tgraph.random_labeled_graph(16, 36, ["a", "b"], seed=6)
    eng = QueryEngine(graph, config=EngineConfig(engine="blocksparse", device="cpu"),
                      metrics=reg)
    eng.query(Query(port_grammar(g), "S", sources=(0, 1)))
    assert gauge(reg) == want > 0


# ---------------------------------------------------------------------- #
# The tile entry: plain versions vs the reference's step and Pallas tiles
# ---------------------------------------------------------------------- #


def _u32(rng, shape, density):
    bits = rng.random((*shape[:-1], shape[-1] * 32)) < density
    return np.asarray(jm.pack_bits(jnp.asarray(bits)))


@pytest.mark.parametrize("B", [32, 64, 128])
@pytest.mark.parametrize("p, n_out", [(1, 1), (7, 3), (64, 16)])
def test_tile_contract_ref_matches_reference_contract_chunk(B, p, n_out):
    """Repeated output segments, pad pairs (segment ``n_out``), outputs with
    and without a slot: the port's step — through the plain version and
    through ``ops.tile_contract_chunk`` on the CPU — equals the reference's
    ``_contract_chunk`` with ``use_kernel=False``."""
    rng = np.random.default_rng(B * 100 + p)
    S = 16
    tiles = _u32(rng, (S, B, B // 32), 0.1)
    l_idx = rng.integers(0, S, p).astype(np.int32)
    r_idx = rng.integers(0, S, p).astype(np.int32)
    seg = rng.integers(0, n_out + 1, p).astype(np.int32)
    out_slot = rng.integers(0, S, n_out).astype(np.int32)
    out_exists = rng.random(n_out) < 0.5
    want = [np.asarray(x) for x in jbs._contract_chunk(
        jnp.asarray(tiles), jnp.asarray(l_idx), jnp.asarray(r_idx),
        jnp.asarray(seg), jnp.asarray(out_slot), jnp.asarray(out_exists),
        n_out, False,
    )]
    t = [torch.from_numpy(x) for x in (l_idx, r_idx, seg, out_slot)]
    ttiles = tm.from_reference(tiles, device=CPU)
    for use_kernel in (False, True):
        new, flags = tbs._contract_chunk(
            ttiles, *t, torch.from_numpy(out_exists), n_out, use_kernel
        )
        np.testing.assert_array_equal(tm.to_reference(new), want[0])
        # flags: changed [0, n_out), nonzero [n_out, 2 n_out), fault last
        assert flags.shape == (2 * n_out + 1,)
        np.testing.assert_array_equal(flags[:n_out].numpy() != 0, want[1])
        np.testing.assert_array_equal(flags[n_out:-1].numpy() != 0, want[2])
        assert flags[-1] == 0  # no pair out of range
    packed = ref.tile_contract_ref(ttiles, *t[:3], n_out)
    old = np.where(out_exists[:, None, None], tiles[out_slot], 0)
    np.testing.assert_array_equal(tm.to_reference(packed) | old, want[0])


@pytest.mark.parametrize("p, B", [(1, 32), (3, 32), (2, 64), (2, 128)])
def test_tile_bitmm_ref_matches_pallas_tile_bitmm(p, B):
    """At most 16 pairs: the reference runs the Pallas tile program in
    interpret mode; the port's plain version and its CPU ``tile_bitmm``
    must match it bit for bit (every bit pattern, bit 31 included)."""
    rng = np.random.default_rng(31 + p + B)
    lhs = rng.integers(0, 2**32, size=(p, B, B // 32), dtype=np.uint32)
    rhs = rng.integers(0, 2**32, size=(p, B, B // 32), dtype=np.uint32)
    want = np.asarray(jops.tile_bitmm(jnp.asarray(lhs), jnp.asarray(rhs)))
    tl, tr = tm.from_reference(lhs, device=CPU), tm.from_reference(rhs, device=CPU)
    np.testing.assert_array_equal(tm.to_reference(ref.tile_bitmm_ref(tl, tr)), want)
    before = ops.tile_launches
    np.testing.assert_array_equal(tm.to_reference(ops.tile_bitmm(tl, tr)), want)
    assert ops.tile_launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("which, value", [
    ("seg", -1), ("seg", 9), ("l_idx", -1), ("l_idx", 16), ("r_idx", -1),
    ("r_idx", 16),
])
def test_tile_contract_flags_and_skips_a_pair_out_of_range(which, value):
    """A pair naming a segment outside [0, n_out] or a slot outside the
    store is skipped and raises the fault flag; the other pairs, pads
    included, are contracted as usual (the kernel does the same on the
    card)."""
    rng = np.random.default_rng(7)
    S, p, n_out = 16, 12, 8
    tiles = tm.from_reference(_u32(rng, (S, 64, 2), 0.2), device=CPU)
    idx = {"l_idx": torch.from_numpy(rng.integers(0, S, p).astype(np.int32)),
           "r_idx": torch.from_numpy(rng.integers(0, S, p).astype(np.int32)),
           "seg": torch.from_numpy(rng.integers(0, n_out, p).astype(np.int32))}
    idx["seg"][-2:] = n_out  # pad pairs
    out_slot = torch.from_numpy(rng.integers(0, S, n_out).astype(np.int32))
    exists = torch.from_numpy((rng.random(n_out) < 0.5).astype(np.int32))
    old = torch.where(exists.bool()[:, None, None], tiles[out_slot.long()], 0)
    _, flags = ops.tile_contract_chunk(tiles, *idx.values(), out_slot, exists, n_out)
    assert flags[-1] == 0
    idx[which][3] = value
    ok = torch.arange(p) != 3
    want = old | ref.tile_contract_ref(
        tiles, *(t[ok] for t in idx.values()), n_out)
    got, flags = ops.tile_contract_chunk(tiles, *idx.values(), out_slot, exists, n_out)
    assert flags[-1] == 1
    assert torch.equal(got, want)


def test_fixpoint_raises_on_a_pair_out_of_range(monkeypatch):
    """The fixpoint reads the kernel path's fault flag at its chunk sync
    and raises, rather than closing over a skipped pair."""
    c = _random_case(37, (10, 11), (24, 25))
    ones = torch.ones(c.n, dtype=torch.bool)
    operands = tbs._chunk_operands

    def bad_operands(state, chunk, device):
        out = operands(state, chunk, device)
        out[3][0] = state.tiles.shape[0]  # an lhs slot past the store
        return out

    monkeypatch.setattr(tbs, "_chunk_operands", bad_operands)
    with pytest.raises(RuntimeError, match="outside its range"):
        tbs.masked_blocksparse_closure(c.tT0, c.ttables, ones,
                                       row_capacity=c.n, tile=32)


def test_closure_use_kernel_path_matches_plain_path():
    c = _random_case(37, (10, 11), (24, 25))
    ones = np.ones(c.n, dtype=bool)
    got, want = c.masked(ones, row_capacity=c.n, tile=32, use_kernel=True)
    _assert_same(got, want)
    plain = _trun(tbs.masked_blocksparse_closure, c.tT0, c.ttables,
                  torch.from_numpy(ones), row_capacity=c.n, tile=32,
                  use_kernel=False)
    _assert_same(plain, got)


# ---------------------------------------------------------------------- #
# Delta repair
# ---------------------------------------------------------------------- #


def test_blocksparse_repair_mask_excludes_frozen_rows():
    """The repair wrapper equals the reference's: M never holds a frozen
    row, and frozen rows come back bit-identical."""
    rng = np.random.default_rng(43)
    g = random_cnf(rng)
    c = Case(random_graph(rng, n_nodes=12, n_edges=30), g)
    full = np.array(jclosure.dense_closure(c.jT0, c.jtables))
    frozen = np.zeros(c.n, dtype=bool)
    frozen[::2] = True
    seed = np.zeros(c.n, dtype=bool)
    seed[1:7:2] = True
    got = _trun(tbs.masked_blocksparse_repair_closure, torch.from_numpy(full),
                c.ttables, torch.from_numpy(seed), torch.from_numpy(frozen),
                row_capacity=c.n, tile=32)
    want = _jrun(jbs.masked_blocksparse_repair_closure, jnp.asarray(full),
                 c.jtables, seed, frozen, row_capacity=c.n, tile=32)
    _assert_same(got, want)
    assert not got[2]
    assert not (got[1] & frozen).any()
    np.testing.assert_array_equal(got[0][:, frozen, :], full[:, frozen, :])


def _engines(graph_fn):
    """A reference and a port engine pinned to blocksparse on one graph."""
    jg = graph_fn(jgraph)
    tg = graph_fn(tgraph)
    return (
        JEngine(jg, config=JConfig(engine="blocksparse")),
        QueryEngine(tg, config=EngineConfig(engine="blocksparse", device="cpu")),
    )


def _assert_same_engine_state(jeng, teng):
    for key, jst in jeng._states.items():
        st = teng._states[key]
        np.testing.assert_array_equal(st.T_host, np.asarray(jst.T_host))
        np.testing.assert_array_equal(st.mask, np.asarray(jst.mask))
        assert torch.equal(st.T.cpu(), torch.from_numpy(st.T_host))


def test_frozen_blocks_bit_identical_after_insert_repair():
    """Rows outside the insertion's ancestor set come back byte-for-byte
    identical, and the repaired state equals the reference engine's."""
    from repro_torch.delta.repair import plan_repair

    g = _anbn()
    tg = port_grammar(g)
    jeng, teng = _engines(
        lambda m: m.random_labeled_graph(20, 44, ["a", "b"], seed=19)
    )
    jeng.query(JQuery(g, "S"))
    teng.query(Query(tg, "S"))
    (state,) = teng._states.values()
    T_before, mask_before = state.T_host.copy(), state.mask.copy()
    v0 = teng.graph.version
    insert = [(2, "a", 11), (7, "b", 3)]
    assert jeng.apply_delta(insert=insert).as_dict() == \
        teng.apply_delta(insert=insert).as_dict()
    plan = plan_repair(teng.graph, teng.graph.delta_since(v0), teng.n)
    frozen = mask_before & ~plan.affected
    assert frozen.any()
    np.testing.assert_array_equal(state.T_host[:, frozen, :], T_before[:, frozen, :])
    _assert_same_engine_state(jeng, teng)
    r = teng.query(Query(tg, "S", sources=(0, 1, 2)))
    full = evaluate_relational(teng.graph, tg, "S", engine="dense", device="cpu")
    assert r.pairs == {(i, j) for (i, j) in full if i in (0, 1, 2)}


def test_blocksparse_delta_interleaving_matches_reference():
    """Random insert/delete interleavings on long-lived blocksparse engines
    of both packages: the same pairs, cache statuses, repair stats, states
    and masks at every step, and the pairs of a dense engine rebuilt per
    epoch."""
    rng = np.random.default_rng(41)
    g = _anbn()
    tg = port_grammar(g)
    n = 24

    def build(m):
        graph = m.random_labeled_graph(n, 50, ["a", "b"], seed=8)
        graph.edges[:] = sorted(set(graph.edges))
        return graph

    jeng, teng = _engines(build)
    for step in range(10):
        op = rng.random()
        if op < 0.35 and teng.graph.edges:
            victim = teng.graph.edges[int(rng.integers(0, len(teng.graph.edges)))]
            kw = {"delete": [victim]}
        elif op < 0.7:
            kw = {"insert": [(int(rng.integers(0, n)), "ab"[int(rng.integers(0, 2))],
                              int(rng.integers(0, n))) for _ in range(2)]}
        else:
            kw = None
        if kw is not None:
            assert jeng.apply_delta(**kw).as_dict() == teng.apply_delta(**kw).as_dict()
        sources = tuple(sorted({int(s) for s in rng.integers(0, n, size=3)}))
        want = jeng.query(JQuery(g, "S", sources=sources))
        got = teng.query(Query(tg, "S", sources=sources))
        assert (got.pairs, got.stats["cache"]) == (want.pairs, want.stats["cache"])
        _assert_same_engine_state(jeng, teng)
        oracle = QueryEngine(tgraph.Graph(n, list(teng.graph.edges)),
                             config=EngineConfig(engine="dense", device="cpu"))
        assert got.pairs == oracle.query(Query(tg, "S", sources=sources)).pairs


def test_blocksparse_full_drop_below_compaction_floor():
    tg = tgrammar.Grammar.from_text("S -> a").to_cnf()
    graph = tgraph.Graph(3, [(0, "a", 1)])
    eng = QueryEngine(graph, config=EngineConfig(engine="blocksparse", device="cpu"))
    assert eng.query(Query(tg, "S", sources=(0,))).pairs == {(0, 1)}
    graph.insert_edges([(0, "a", 2)])
    graph.compact_log(graph.version)  # the engine's version is now pre-floor
    r = eng.query(Query(tg, "S", sources=(0,)))
    assert r.stats["cache"] == "miss"
    assert r.pairs == {(0, 1), (0, 2)}


# ---------------------------------------------------------------------- #
# Engine dispatch, both semantics
# ---------------------------------------------------------------------- #


def test_engine_queries_and_apply_delta_match_reference():
    """Query 1 and Query 2 on three skos copies, pinned to blocksparse at
    tile 64: queries, an edit and all-pairs give the reference engine's
    pairs, cache statuses, plan-cache counters, repair stats and states."""
    grammars = {
        "q1": (jgrammar.query1_grammar().to_cnf(), tgrammar.query1_grammar().to_cnf()),
        "q2": (jgrammar.query2_grammar().to_cnf(), tgrammar.query2_grammar().to_cnf()),
    }
    jeng = JEngine(jgraph.paper_table_graph("skos").repeat(3),
                   config=JConfig(engine="blocksparse", tile=64))
    teng = QueryEngine(tgraph.paper_table_graph("skos").repeat(3),
                       config=EngineConfig(engine="blocksparse", tile=64, device="cpu"))
    steps = [[("q1", (0, 5))], [("q1", (130,))], [("q1", (260,)), ("q2", (1, 2))],
             "edit", [("q1", (252, 253))], [("q1", None), ("q2", None)]]
    before = ops.tile_launches
    for step in steps:
        if step == "edit":
            ins = [(252, "type_r", 377), (377, "type", 260)]
            assert jeng.apply_delta(insert=ins).as_dict() == \
                teng.apply_delta(insert=ins).as_dict()
            continue
        want = jeng.query_batch([JQuery(grammars[k][0], "S", sources=s) for k, s in step])
        got = teng.query_batch([Query(grammars[k][1], "S", sources=s) for k, s in step])
        for w, x in zip(want, got):
            assert (x.pairs, x.stats["cache"], x.stats["compile_misses"],
                    x.stats["compile_hits"], x.stats["engine"]) == \
                (w.pairs, w.stats["cache"], w.stats["compile_misses"],
                 w.stats["compile_hits"], w.stats["engine"])
    assert {grammar_key(t) for _, t in grammars.values()} == set(teng._states)
    assert {jgrammar_key(j) for j, _ in grammars.values()} == set(jeng._states)
    for (jg, tg) in grammars.values():
        jst, st = jeng._states[jgrammar_key(jg)], teng._states[grammar_key(tg)]
        np.testing.assert_array_equal(st.T_host, np.asarray(jst.T_host))
        np.testing.assert_array_equal(st.mask, np.asarray(jst.mask))
    assert ops.tile_launches == before  # on the CPU: the plain version


def test_single_path_served_through_blocksparse_pin():
    """A pinned blocksparse engine serves single-path queries through the
    dense alias: the reference engine's pairs and witness paths."""
    g = _anbn()
    jeng, teng = _engines(
        lambda m: m.random_labeled_graph(18, 40, ["a", "b"], seed=4)
    )
    want = jeng.query(JQuery(g, "S", sources=(0, 1, 2, 3), semantics="single_path"))
    got = teng.query(Query(port_grammar(g), "S", sources=(0, 1, 2, 3),
                           semantics="single_path"))
    assert got.pairs == want.pairs
    assert got.paths == want.paths
    assert got.stats["engine"] == want.stats["engine"] == "blocksparse"


def test_relational_dispatch_matches_dense():
    c = _random_case(21, (11, 12), (26, 27))
    start = c.tg.nonterms[0]
    eng = QueryEngine(c.tgraph, config=EngineConfig(engine="blocksparse", device="cpu"))
    pairs = eng.query(Query(c.tg, start)).pairs
    assert pairs == evaluate_relational(c.tgraph, c.tg, start, engine="dense",
                                        device="cpu")


# ---------------------------------------------------------------------- #
# auto: the port's features and decisions are the reference's
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("copies", [16, 64])
def test_auto_decisions_match_reference_planner(copies):
    """On pizza copies at full size (nothing is closed: only the planner
    features are built), the port's engine decides as the reference engine
    does for all-pairs, a 256-source batch and a 2048-row repair — and
    both route them to blocksparse, as the reference does."""
    jg = jgrammar.query1_grammar().to_cnf()
    tg = tgrammar.query1_grammar().to_cnf()
    jeng = JEngine(jgraph.paper_table_graph("pizza").repeat(copies))
    teng = QueryEngine(tgraph.paper_table_graph("pizza").repeat(copies),
                       config=EngineConfig(device="cpu"))
    jst = jeng._state_for(jgrammar_key(jg), jg)
    st = teng._state_for(grammar_key(tg), tg)
    n, nn = teng.n, teng.graph.n_nodes
    assert jeng.n == n
    allpairs = np.zeros(n, dtype=bool)
    allpairs[:nn] = True
    batch = np.zeros(n, dtype=bool)
    batch[np.random.default_rng(0).choice(nn, size=256, replace=False)] = True
    repair = np.zeros(n, dtype=bool)
    repair[:2048] = True
    cases = [(allpairs, allpairs, "miss", False), (batch, batch, "miss", False),
             (repair, repair, "warm", True)]
    for seed, new, cache, rep in cases:
        want = jeng._decide(jst, seed, new, "relational", cache, repair=rep)
        got = teng._decide(st, seed, new, "relational", cache, repair=rep)
        assert got.to_dict() == want.to_dict()
        assert got.engine == "blocksparse"

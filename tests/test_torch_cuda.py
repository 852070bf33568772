"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip on a machine without one.  This file imports only torch and the
port, so it also runs where JAX is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import matrices as tm
from repro_torch.core.grammar import query1_grammar
from repro_torch.core.graph import ontology_graph, paper_table_graph
from repro_torch.engine import EngineConfig, Query, QueryEngine
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _words(rng, shape, density):
    return tm.pack_bits(torch.from_numpy(rng.random(shape) < density))


def test_bitmm_kernel_matches_plain_version(card):
    rng = np.random.default_rng(21)
    for r, n, w, d in ((128, 512, 16, 0.3), (100, 256, 40, 0.05), (15, 64, 3, 0.5)):
        lhs = _words(rng, (3, r, n), d).to(card)
        rhs = _words(rng, (3, n, 32 * w), d).to(card)
        before = ops.launches
        got = ops.bitmm(lhs, rhs)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        assert torch.equal(got, ref.bitmm_ref(lhs, rhs))


def test_bitmm_kernel_rejects_what_it_does_not_take(card):
    lhs = torch.zeros((2, 64, 4), dtype=torch.int32, device=card)
    rhs = torch.zeros((2, 128, 4), dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="not int32"):
        ops.bitmm(lhs.long(), rhs)
    with pytest.raises(ValueError, match="do not contract"):
        ops.bitmm(lhs[:, :, :1].contiguous(), rhs)
    with pytest.raises(ValueError, match="not contiguous"):
        ops.bitmm(lhs.transpose(1, 2), rhs)
    with pytest.raises(ValueError, match="not CUDA"):
        ops.bitmm(lhs.cpu(), rhs)


@pytest.mark.parametrize("backend", ["dense", "frontier", "bitpacked", "auto"])
def test_engine_on_card_matches_engine_on_cpu(card, backend):
    graph = paper_table_graph("foaf").repeat(2)
    g = query1_grammar().to_cnf()
    batches = [[Query(g, "S", sources=(0, 7))], [Query(g, "S", sources=(400,))],
               [Query(g, "S")]]
    engines = {
        dev: QueryEngine(graph, config=EngineConfig(engine=backend, device=dev))
        for dev in ("cpu", "cuda")
    }
    for batch in batches:
        want = engines["cpu"].query_batch(batch)
        got = engines["cuda"].query_batch(batch)
        assert [r.pairs for r in got] == [r.pairs for r in want]
        assert [r.stats["cache"] for r in got] == [r.stats["cache"] for r in want]


def test_bitmm_or_kernel_matches_plain_version(card):
    rng = np.random.default_rng(22)
    for r, n, w, d in ((128, 512, 16, 0.3), (100, 256, 40, 0.05), (15, 64, 3, 0.5),
                       (70, 128, 4, 0.0)):
        lhs = _words(rng, (3, r, n), d).to(card)
        rhs = _words(rng, (3, n, 32 * w), d).to(card)
        acc = _words(rng, (3, r, 32 * w), 0.2).to(card)
        acc[:, ::2] |= torch.iinfo(torch.int32).min  # bit 31
        before = ops.or_launches
        got = ops.bitmm_or(lhs, rhs, acc)
        torch.cuda.synchronize()
        assert ops.or_launches == before + 1
        assert torch.equal(got, ref.bitmm_or_ref(lhs, rhs, acc))
        assert torch.equal(got & acc, acc)  # every acc bit survives
        zero = ops.bitmm_or(lhs, rhs, torch.zeros_like(acc))
        assert torch.equal(zero, ops.bitmm(lhs, rhs))
        ones = ops.bitmm_or(lhs, rhs, torch.full_like(acc, -1))
        assert bool((ones == -1).all())


def test_bitmm_or_kernel_rejects_what_it_does_not_take(card):
    lhs = torch.zeros((2, 64, 4), dtype=torch.int32, device=card)
    rhs = torch.zeros((2, 128, 4), dtype=torch.int32, device=card)
    acc = torch.zeros((2, 64, 4), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="acc is"):
        ops.bitmm_or(lhs, rhs, acc[:, :32].contiguous())
    with pytest.raises(TypeError, match="not int32"):
        ops.bitmm_or(lhs, rhs, acc.long())
    with pytest.raises(ValueError, match="not CUDA"):
        ops.bitmm_or(lhs, rhs, acc.cpu())


@pytest.mark.parametrize("backend", ["dense", "frontier", "bitpacked", "auto"])
def test_engine_repair_on_card_matches_engine_on_cpu(card, backend):
    """The same queries and edits on the card and on the CPU: the same
    pairs, cache statuses, repair stats, repaired state and mask."""
    g = query1_grammar().to_cnf()
    engines, graphs = {}, {}
    for dev in ("cpu", "cuda"):
        graphs[dev] = ontology_graph(30, 60, seed=1)
        engines[dev] = QueryEngine(
            graphs[dev], config=EngineConfig(engine=backend, device=dev)
        )
    q = Query(g, "S", sources=(0, 3, 7))
    inserts = [(0, "type", 5), (5, "subClassOf", 3), (9, "type_r", 2)]

    def run(dev):
        eng, graph = engines[dev], graphs[dev]
        out = [eng.query(q)]
        out.append(eng.apply_delta(insert=inserts))
        out.append(eng.query(q))
        out.append(eng.apply_delta(delete=[graph.edges[0]], insert=[(3, "type", 8)]))
        graph.insert_edges([(7, "subClassOf", 2)])  # logged, repaired at the next batch
        out.append(eng.query(Query(g, "S")))
        (state,) = eng._states.values()
        return out, state

    before = ops.or_launches
    want, want_state = run("cpu")
    got, got_state = run("cuda")
    torch.cuda.synchronize()
    for w, x in zip(want, got):
        if hasattr(w, "pairs"):
            assert (x.pairs, x.stats["cache"]) == (w.pairs, w.stats["cache"])
        else:
            assert x.as_dict() == w.as_dict()
    assert np.array_equal(got_state.mask, want_state.mask)
    assert np.array_equal(got_state.T_host, want_state.T_host)
    assert torch.equal(got_state.T.cpu(), want_state.T)
    if backend == "bitpacked":
        assert ops.or_launches > before

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
from repro_torch.core.graph import paper_table_graph
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

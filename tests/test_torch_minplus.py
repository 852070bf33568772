"""The port's min-plus product (``ops.minplus``) against the reference's
``repro.core.semantics._minplus`` (jnp), bit for bit, on the CPU.

* lhs mostly ``inf`` and fully finite, square and rectangular, K and C
  not multiples of 4 or 32, rows without a finite entry;
* the index form (``slab``, ``row``: repeated and unsorted rows) against
  the reference on an explicit gather of the rhs;
* the ``acc`` form against ``np.minimum`` of ``acc`` and the reference;
* an empty contraction (K = 0): inf, or ``acc``;
* the four single-path closures go through ``ops.minplus`` (a counter
  monkeypatched onto it).

On the CPU ``ops.minplus`` takes its plain version (``ref.minplus_ref``);
the CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py's ``minplus_checks``).  Inputs
are made with numpy from fixed seeds; tolerance is exact
(``torch.equal``).  Each reference result is computed once per module.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semantics as js
from repro_torch.core import matrices as tm
from repro_torch.core import semantics as ts
from repro_torch.kernels import ops, ref
from torch_helpers import case

#: (P, R, K, C, share of finite lhs entries): inf-heavy, fully finite,
#: rectangular with K and C off every multiple of 4 and 32, one output
#: column
SHAPES = {
    "sparse": (3, 40, 64, 96, 0.02),
    "finite": (2, 17, 33, 45, 1.0),
    "rectangular": (2, 7, 130, 257, 0.1),
    "k1": (1, 5, 1, 9, 0.5),
    "one column": (1, 3, 7, 1, 1.0),
}


def _lengths(rng, shape, finite):
    a = rng.integers(1, 30, size=shape).astype(np.float32)
    a[rng.random(shape) >= finite] = np.inf
    return a


def _operands(name):
    P, R, K, C, finite = SHAPES[name]
    rng = np.random.default_rng(sum(SHAPES[name][:4]))
    lhs = _lengths(rng, (P, R, K), finite)
    lhs[:, 0, :] = np.inf  # a row without a finite entry
    rhs = _lengths(rng, (P, K, C), 0.5)
    return lhs, rhs


@pytest.fixture(scope="module")
def reference():
    """The reference's product of every shape, computed once."""
    out = {}
    for name in SHAPES:
        lhs, rhs = _operands(name)
        out[name] = np.asarray(js._minplus(jnp.asarray(lhs), jnp.asarray(rhs)))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("name", SHAPES)
def test_minplus_matches_reference(reference, name):
    lhs, rhs = _operands(name)
    got = ops.minplus(_t(lhs), _t(rhs))
    assert torch.equal(got, _t(reference[name]))
    assert torch.isinf(got[:, 0]).all()  # the row without a finite entry


@pytest.mark.parametrize("name", SHAPES)
def test_minplus_index_form_matches_reference_on_a_gather(reference, name):
    """rhs rows named through ``slab`` and ``row`` of a larger base (rows
    repeated and out of order) equal the reference on the gathered rhs."""
    P, R, K, C, _ = SHAPES[name]
    lhs, _ = _operands(name)
    rng = np.random.default_rng(K * 7 + C)
    base = _lengths(rng, (P + 2, K + 5, C), 0.5)
    slab = rng.permutation(P + 2)[:P]
    row = rng.integers(0, K + 5, size=K)  # repeats, unsorted
    want = np.asarray(js._minplus(
        jnp.asarray(lhs), jnp.asarray(base[slab][:, row])))
    got = ops.minplus(_t(lhs), _t(base), _t(slab), _t(row))
    assert torch.equal(got, _t(want))
    # the identity indices are the plain form
    ident = ops.minplus(_t(lhs), _t(_operands(name)[1]),
                        torch.arange(P), torch.arange(K))
    assert torch.equal(ident, _t(reference[name]))


@pytest.mark.parametrize("name", SHAPES)
def test_minplus_acc_form_is_the_minimum_with_acc(reference, name):
    P, R, K, C, _ = SHAPES[name]
    lhs, rhs = _operands(name)
    acc = _lengths(np.random.default_rng(R), (P, R, C), 0.3)
    acc_t = _t(acc)
    got = ops.minplus(_t(lhs), _t(rhs), acc=acc_t)
    assert torch.equal(got, _t(np.minimum(acc, reference[name])))
    assert torch.equal(acc_t, _t(acc))  # acc is only read


def test_minplus_with_an_empty_contraction_is_acc_or_inf():
    """K = 0 (the reference's ``_minplus`` takes no empty contraction):
    the product is inf, and with acc it is acc."""
    lhs, rhs = torch.zeros((2, 3, 0)), torch.zeros((2, 0, 5))
    acc = _t(_lengths(np.random.default_rng(0), (2, 3, 5), 0.5))
    assert torch.isinf(ops.minplus(lhs, rhs)).all()
    assert torch.equal(ops.minplus(lhs, rhs, acc=acc), acc)
    base = torch.zeros((3, 4, 5))
    assert torch.equal(ops.minplus(lhs, base, torch.tensor([2, 0]),
                                   torch.zeros(0, dtype=torch.int64), acc), acc)


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_minplus_ref_does_not_depend_on_the_chunk(reference, chunk):
    lhs, rhs = _operands("rectangular")
    got = ref.minplus_ref(_t(lhs), _t(rhs), chunk=chunk)
    assert torch.equal(got, _t(reference["rectangular"]))


def test_minplus_on_the_cpu_launches_nothing():
    lhs, rhs = _operands("k1")
    before = ops.minplus_launches
    ops.minplus(_t(lhs), _t(rhs))
    assert ops.minplus_launches == before


CLOSURES = (
    "single_path_closure", "masked_single_path_closure",
    "masked_frontier_single_path_closure", "masked_single_path_repair_closure",
)


@pytest.mark.parametrize("fn", CLOSURES)
def test_every_single_path_closure_goes_through_ops_minplus(monkeypatch, fn):
    """The closures' only min-plus product is ``ops.minplus``: with a
    counting stand-in the closure still equals its run without one, and
    counted at least one product per iteration."""
    _, _, tg, tgr, _ = case("skos:q1")
    tables = tm.ProductionTables.from_grammar(tgr)
    T0 = tm.init_matrix(tg, tgr, device="cpu")
    L0 = ts.init_lengths(tg, tgr, device="cpu")
    n = T0.shape[-1]
    src = torch.zeros(n, dtype=torch.bool)
    src[[0, tg.n_nodes // 2]] = True

    def run():
        if fn == "single_path_closure":
            return ts.single_path_closure(T0, tables)
        if fn == "masked_single_path_repair_closure":
            frozen = torch.zeros(n, dtype=torch.bool)
            frozen[tg.n_nodes // 3] = True
            return ts.masked_single_path_repair_closure(
                L0, tables, src, frozen, row_capacity=n)
        return getattr(ts, fn)(L0, tables, src, row_capacity=n)

    want = run()
    calls = []
    inner = ops.minplus

    def counting(*args, **kwargs):
        calls.append(kwargs.get("acc") is not None)
        return inner(*args, **kwargs)

    monkeypatch.setattr(ops, "minplus", counting)
    got = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w
    assert calls
    if fn == "masked_frontier_single_path_closure":
        assert calls[1::2] == [True] * (len(calls) // 2)  # the second is min-accumulated

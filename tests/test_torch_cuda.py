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


@pytest.mark.parametrize(
    "backend", ["dense", "frontier", "bitpacked", "blocksparse", "auto"])
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


@pytest.mark.parametrize(
    "backend", ["dense", "frontier", "bitpacked", "blocksparse", "auto"])
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

    before, tile_before = ops.or_launches, ops.tile_launches
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
    if backend == "blocksparse":
        assert ops.tile_launches > tile_before


# ---------------------------------------------------------------------- #
# the two paths of the kernel (sparse row gather, staged dense tiles)
# ---------------------------------------------------------------------- #

INT_MAX = 2**31 - 1


def _tile_bits(rng, rows, k, n_bits):
    """A (rows, k) Boolean tile with exactly ``n_bits`` set bits."""
    flat = np.zeros(rows * k, dtype=bool)
    flat[rng.choice(rows * k, size=n_bits, replace=False)] = True
    return flat.reshape(rows, k)


def _path_case(rng, name, threshold):
    """(lhs bits (B, m, k), rhs words, acc words) of one named case."""
    B, m, k, w, d = 2, 100, 256, 40, 0.05
    if name.startswith("w="):
        w = int(name[2:])
    elif name == "ragged m=1":
        m = 1
    elif name == "ragged m=130":
        m = 130
    elif name == "tile_bitmm batch":
        B, m, k, w, d = 512, 128, 128, 4, 0.1
    lhs = rng.random((B, m, k)) < d
    lhs[..., 31::32] |= rng.random(lhs[..., 31::32].shape) < d  # bit 31
    if name == "all-empty tiles":
        lhs[:] = False
    elif name == "single set bit":
        lhs[:] = False
        lhs[1, 37, 31] = True  # bit 31 of word 0
    elif name == "threshold edges":
        # tiles with threshold + 1, threshold, 0 and 1 set bits: dense,
        # sparse, empty and sparse in one launch
        k = 32 * -(-(threshold + 2) // (64 * 32))
        B, m, w = 1, 256, 496
        lhs = np.zeros((B, m, k), dtype=bool)
        lhs[0, :64] = _tile_bits(rng, 64, k, threshold + 1)
        lhs[0, 64:128] = _tile_bits(rng, 64, k, threshold)
        lhs[0, 192:] = _tile_bits(rng, 64, k, 1)
    rhs = _words(rng, (B, k, 32 * w), 0.2)
    rhs[:, ::3] |= torch.iinfo(torch.int32).min
    acc = _words(rng, (B, m, 32 * w), 0.05)
    acc[:, ::2] |= torch.iinfo(torch.int32).min
    operands = tm.pack_bits(torch.from_numpy(lhs)), rhs, acc
    if name == "misaligned":
        operands = tuple(_misaligned(t) for t in operands)
    return operands


def _misaligned(t):
    """A contiguous copy of ``t`` one word past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _on_card(t, card):
    """``t`` on the card, keeping its offset from a 16-byte boundary."""
    if t.storage_offset() == 0:
        return t.to(card)
    buf = torch.empty(t.numel() + t.storage_offset(), dtype=t.dtype, device=card)
    out = buf[t.storage_offset():].view(t.shape)
    out.copy_(t)
    return out


PATH_CASES = ["all-empty tiles", "single set bit", "threshold edges",
              "w=1", "w=3", "w=5", "w=40", "w=496", "w=600", "w=601",
              "ragged m=1", "ragged m=130", "tile_bitmm batch", "misaligned"]


@pytest.mark.parametrize("name", PATH_CASES)
def test_both_paths_match_plain_version(card, name):
    """bitmm and bitmm_or word-equal to the plain versions through the
    compiled-in threshold and with each path forced: every case above,
    bit 31 in lhs, rhs and acc, acc all zeros and all ones."""
    from repro_torch.kernels.bitmm import bitmm_path_cuda, sparse_max_bits

    threshold = sparse_max_bits()
    lhs, rhs, acc = (_on_card(t, card) for t in _path_case(
        np.random.default_rng(PATH_CASES.index(name)), name, threshold))
    want = ref.bitmm_ref(lhs, rhs)
    want_or = ref.bitmm_or_ref(lhs, rhs, acc)
    assert torch.equal(ops.bitmm(lhs, rhs), want)
    assert torch.equal(ops.bitmm_or(lhs, rhs, acc), want_or)
    for t in (0, INT_MAX, threshold):
        assert torch.equal(bitmm_path_cuda(lhs, rhs, sparse_max_bits=t), want)
        assert torch.equal(
            bitmm_path_cuda(lhs, rhs, acc, sparse_max_bits=t), want_or)
        zero = bitmm_path_cuda(lhs, rhs, torch.zeros_like(acc), sparse_max_bits=t)
        assert torch.equal(zero, want)
        ones = bitmm_path_cuda(lhs, rhs, torch.full_like(acc, -1),
                               sparse_max_bits=t)
        assert bool((ones == -1).all())
    torch.cuda.synchronize()


def test_path_entry_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.bitmm import bitmm_path_cuda

    lhs = torch.zeros((2, 64, 4), dtype=torch.int32, device=card)
    rhs = torch.zeros((2, 128, 4), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="not an int32"):
        bitmm_path_cuda(lhs, rhs, sparse_max_bits=-1)
    with pytest.raises(ValueError, match="acc is"):
        bitmm_path_cuda(lhs, rhs, lhs[:, :32].contiguous(), sparse_max_bits=0)
    before = (ops.launches, ops.or_launches)
    bitmm_path_cuda(lhs, rhs, sparse_max_bits=0)
    assert (ops.launches, ops.or_launches) == before  # not a main-path launch


# ---------------------------------------------------------------------- #
# single-path semantics and the serving loop on the card
# ---------------------------------------------------------------------- #


def test_minplus_on_card_matches_cpu_at_every_chunk(card):
    from repro_torch.core.semantics import _minplus

    rng = np.random.default_rng(23)
    lhs = rng.integers(1, 20, size=(3, 50, 70)).astype(np.float32)
    rhs = rng.integers(1, 20, size=(3, 70, 90)).astype(np.float32)
    lhs[rng.random(lhs.shape) < 0.6] = np.inf
    rhs[rng.random(rhs.shape) < 0.6] = np.inf
    before = ops.minplus_launches
    got = _minplus(torch.from_numpy(lhs).to(card), torch.from_numpy(rhs).to(card))
    assert ops.minplus_launches == before + 1  # the kernel, never the plain loop
    for chunk in (1, 3, 64, None):
        want = _minplus(torch.from_numpy(lhs), torch.from_numpy(rhs), chunk=chunk)
        assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="the card runs the kernel"):
        _minplus(torch.from_numpy(lhs).to(card), torch.from_numpy(rhs).to(card),
                 chunk=3)


def _lengths(rng, shape, finite):
    a = rng.integers(1, 1000, size=shape).astype(np.float32)
    a[rng.random(shape) >= finite] = np.inf
    return torch.from_numpy(a)


@pytest.mark.parametrize("finite", [1e-3, 0.05, 1.0])
@pytest.mark.parametrize("P, R, K, C", [(3, 50, 70, 90), (2, 9, 1, 1030),
                                        (6, 33, 991, 2048)])
def test_minplus_kernel_matches_plain_version(card, finite, P, R, K, C):
    """Plain, index (a permuted slab, repeated unsorted rows of a larger
    base) and acc forms, rows without a finite entry, C off a multiple of
    4 and past one column tile: the kernel equals the plain version bit for
    bit, and each call counts one launch."""
    rng = np.random.default_rng(P * 100 + K)
    lhs = _lengths(rng, (P, R, K), finite)
    lhs[:, ::3] = float("inf")
    rhs = _lengths(rng, (P, K, C), 0.5)
    base = _lengths(rng, (P + 2, K + 7, C), 0.5)
    slab = torch.from_numpy(rng.permutation(P + 2)[:P])
    row = torch.from_numpy(rng.integers(0, K + 7, size=K))
    acc = _lengths(rng, (P, R, C), 0.2)
    for args, kwargs in (((lhs, rhs), {}), ((lhs, base, slab, row), {}),
                         ((lhs, base, slab, row), {"acc": acc})):
        want = ref.minplus_ref(*args, **kwargs)
        before = ops.minplus_launches
        got = ops.minplus(*(t.to(card) for t in args),
                          **{k: v.to(card) for k, v in kwargs.items()})
        torch.cuda.synchronize()
        assert ops.minplus_launches == before + 1
        assert torch.equal(got.cpu(), want)


#: the cases that reach each branch of the sparse-row design of the min-plus
#: and count kernels (csrc/sparse_rows.cuh), (P, R, K, C) by name: rows
#: whose list overflows a warp's 512 entries, K = 0, R off the 8-row block,
#: C off 4 and the 512-column tile, misaligned operands, acc at its
#: absorbing value (chip_smoke.py's SPARSE_ROW_CASES)
SPARSE_ROW_CASES = {
    "overflow rows among empty ones": (2, 45, 1500, 777),
    "lists of 512 and 513 entries": (1, 9, 1030, 516),
    "K = 0": (2, 9, 0, 100),
    "one row, one column": (1, 1, 7, 1),
    "misaligned lhs": (3, 13, 50, 1028),
    "misaligned operands": (2, 11, 51, 1024),
    "acc absorbing": (2, 17, 300, 600),
}


def _sparse_row_operands(rng, name, values, empty, top):
    """lhs, rhs (the gathered base), base, slab, row and acc of one
    SPARSE_ROW_CASES case on the CPU; ``values(shape, share)`` draws ring
    values taken at ``share`` (``empty`` elsewhere), ``top`` is the
    absorbing value."""
    P, R, K, C = SPARSE_ROW_CASES[name]
    lhs = values((P, R, K), 0.05)
    lhs[:, ::4] = empty
    if name == "overflow rows among empty ones":
        lhs[:] = empty
        lhs[:, [3, 17, 40]] = values((P, 3, K), 1.0)
        lhs[:, 5] = values((P, K), 0.5)
    elif name == "lists of 512 and 513 entries":
        lhs[:] = empty
        for i, m in enumerate((512, 513, 1024, K)):
            lhs[:, i, :m] = values((P, m), 1.0)
    base = values((P + 1, K + 3, C), 0.5)
    slab = torch.from_numpy(rng.permutation(P + 1)[:P])
    row = torch.from_numpy(rng.integers(0, K + 3, size=K))
    acc = values((P, R, C), 0.3)
    if name == "acc absorbing":
        acc[:, ::2] = top
    rhs = base[slab][:, row].contiguous()
    if name.startswith("misaligned"):
        lhs = _misaligned(lhs)
        if name == "misaligned operands":
            base, acc = _misaligned(base), _misaligned(acc)
    return lhs, rhs, base, slab, row, acc


def _held_on_card(kernel, plain, launches, card, lhs, rhs, base, slab, row, acc):
    """``kernel`` (``ops.minplus`` or ``ops.count_mm``) in its plain, index
    and acc forms on the card, operands at their offsets from a 16-byte
    boundary, equals ``plain`` on the CPU, one launch a call."""
    for args, kwargs in (((lhs, rhs), {}), ((lhs, base, slab, row), {}),
                         ((lhs, base, slab, row), {"acc": acc})):
        want = plain(*args, **kwargs)
        before = getattr(ops, launches)
        got = kernel(*(_on_card(t, card) for t in args),
                     **{k: _on_card(v, card) for k, v in kwargs.items()})
        torch.cuda.synchronize()
        assert getattr(ops, launches) == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", list(SPARSE_ROW_CASES))
def test_minplus_kernel_matches_plain_version_on_sparse_row_cases(card, name):
    rng = np.random.default_rng(len(name))
    inf = float("inf")
    operands = _sparse_row_operands(
        rng, name, lambda shape, d: _lengths(rng, shape, d), inf, inf)
    _held_on_card(ops.minplus, ref.minplus_ref, "minplus_launches", card, *operands)


def test_minplus_kernel_rejects_what_it_does_not_take(card):
    lhs = torch.ones((2, 4, 8), device=card)
    base = torch.ones((3, 8, 16), device=card)
    row = torch.arange(8, device=card)
    with pytest.raises(TypeError, match="not torch.float32"):
        ops.minplus(lhs.double(), base)
    with pytest.raises(TypeError, match="not torch.int64"):
        ops.minplus(lhs, base, row=row.int())
    with pytest.raises(ValueError, match="not contiguous"):
        ops.minplus(lhs.transpose(1, 2).contiguous().transpose(1, 2), base)
    with pytest.raises(ValueError, match="one device"):
        ops.minplus(lhs, base.cpu())
    with pytest.raises(ValueError, match="does not contract"):
        ops.minplus(lhs, base[:, :7].contiguous())
    with pytest.raises(ValueError, match="outside"):
        ops.minplus(lhs, base, row=row + 1)
    with pytest.raises(ValueError, match="outside"):
        ops.minplus(lhs, base, torch.tensor([0, 3], device=card))
    before = ops.minplus_launches
    assert ops.minplus(lhs[:, :0], base).shape == (2, 0, 16)  # empty: no launch
    assert ops.minplus_launches == before


@pytest.mark.parametrize("backend", ["dense", "frontier", "bitpacked", "auto"])
def test_single_path_on_card_matches_cpu(card, backend):
    """The same single-path batches and edit on the card and on the CPU:
    the same pairs, witnesses, cache statuses, length state and mask, and
    the host mirror equals the device state."""
    g = query1_grammar().to_cnf()
    engines, graphs = {}, {}
    for dev in ("cpu", "cuda"):
        graphs[dev] = paper_table_graph("skos").repeat(2)
        engines[dev] = QueryEngine(
            graphs[dev], config=EngineConfig(engine=backend, device=dev)
        )
    batches = [[Query(g, "S", sources=(0, 5), semantics="single_path")],
               [Query(g, "S", sources=(130,), semantics="single_path"),
                Query(g, "S", sources=(131,))]]

    def run(dev):
        eng = engines[dev]
        out = [eng.query_batch(b) for b in batches]
        out.append(eng.apply_delta(delete=[(1, "subClassOf_r", 0)],
                                   insert=[(3, "type_r", 200), (200, "type", 5)]))
        out.append(eng.query_batch(batches[0]))
        (state,) = eng._states.values()
        return out, state

    want, want_state = run("cpu")
    before = ops.minplus_launches
    got, got_state = run("cuda")
    assert ops.minplus_launches > before  # the closures ran the kernel
    for w, x in zip(want, got):
        if isinstance(w, list):
            assert [(r.pairs, r.paths, r.stats["cache"]) for r in x] == \
                [(r.pairs, r.paths, r.stats["cache"]) for r in w]
        else:
            assert x.as_dict() == w.as_dict()
    assert np.array_equal(got_state.sp_mask, want_state.sp_mask)
    assert np.array_equal(got_state.sp_L_host, want_state.sp_L_host)
    assert torch.equal(got_state.sp_L.cpu(), want_state.sp_L)


def test_server_on_card_serves_both_semantics_and_a_fenced_write(card):
    import asyncio

    from repro_torch.serve import CFPQServer, ServeConfig

    g = query1_grammar().to_cnf()
    queries = [Query(g, "S", sources=(s,), semantics=sem)
               for s in (0, 3, 130) for sem in ("relational", "single_path")]

    async def serve(dev):
        eng = QueryEngine(paper_table_graph("skos").repeat(2),
                          config=EngineConfig(engine="bitpacked", device=dev))
        async with CFPQServer(eng, ServeConfig(max_batch=3,
                                               batch_window_s=0.005)) as srv:
            first = await asyncio.gather(*[srv.submit(q) for q in queries])
            await srv.apply_delta(insert=[(3, "type_r", 200), (200, "type", 5)])
            second = await asyncio.gather(*[srv.submit(q) for q in queries])
        assert srv.stats.served == srv.stats.admitted == 2 * len(queries)
        return [(r.pairs, r.paths, r.stats["epoch"]) for r in first + second]

    before = ops.launches
    want = asyncio.run(asyncio.wait_for(serve("cpu"), 60))
    got = asyncio.run(asyncio.wait_for(serve("cuda"), 60))
    assert got == want
    assert ops.launches > before  # the relational batches ran bitmm


# ---------------------------------------------------------------------- #
# the block-sparse backend's tile kernel
# ---------------------------------------------------------------------- #


def _indices(rng, high, size, card):
    return torch.from_numpy(rng.integers(0, high, size).astype(np.int32)).to(card)


@pytest.mark.parametrize("B", [32, 64, 128])
def test_tile_contract_kernel_matches_plain_version(card, B):
    """The fixpoint's chunk: slot gathers, repeated output segments, pad
    pairs (segment n_out), old tiles gathered by slot, runs of consecutive
    pairs sharing an lhs slot (longer than a ring half, and cut at the
    block's 256 pairs), densities up to every bit set, several chunks
    through one work object (each finds its buffer zeroed by the one
    before): the new tiles and the changed and nonzero flags are
    word-equal to ``tile_contract_chunk_ref``, one launch each.
    ``tile_bitmm`` too."""
    rng = np.random.default_rng(40 + B)
    work = ops.tile_work(B, 512, card)
    for S, p, n_out, d, run in ((8, 1, 1, 0.05, 1), (64, 7, 4, 0.3, 3),
                                (600, 512, 100, 0.01, 1), (600, 512, 128, 0.01, 40),
                                (32, 40, 8, 1.0, 5), (16, 300, 8, 0.1, 300)):
        tiles = _words(rng, (S, B, B), d)
        l_idx = torch.from_numpy(
            rng.integers(0, S, -(-p // run)).astype(np.int32).repeat(run)[:p])
        r_idx, seg = _indices(rng, S, p, "cpu"), _indices(rng, n_out, p, "cpu")
        if p >= 4:
            seg[-(p // 4):] = n_out  # pad pairs
        out_slot = _indices(rng, S, n_out, "cpu")
        exists = torch.from_numpy((rng.random(n_out) < 0.5).astype(np.int32))
        want, want_flags = ref.tile_contract_chunk_ref(
            tiles, l_idx, r_idx, seg, out_slot, exists, n_out)
        for _ in range(2):
            before = ops.tile_launches
            new, flags = ops.tile_contract_chunk(
                *(t.to(card) for t in (tiles, l_idx, r_idx, seg, out_slot, exists)),
                n_out, work)
            flags = flags.cpu()
            assert ops.tile_launches == before + 1
            assert torch.equal(new.cpu(), want), (S, p, n_out, d, run)
            assert torch.equal(flags[:n_out], want_flags[:n_out])
            assert torch.equal(flags[512:512 + n_out], want_flags[n_out:-1])
            assert int(flags[-1]) == 0
    lhs = _words(rng, (9, B, B), 0.1).to(card)
    rhs = _words(rng, (9, B, B), 0.1).to(card)
    before = ops.tile_launches
    assert torch.equal(ops.tile_bitmm(lhs, rhs), ref.bitmm_ref(lhs, rhs))
    assert ops.tile_launches == before + 1


def test_tile_kernel_rejects_what_it_does_not_take(card):
    tiles = torch.zeros((8, 128, 4), dtype=torch.int32, device=card)
    idx = torch.zeros(4, dtype=torch.int32, device=card)
    work = ops.tile_work(128, 512, card)

    def chunk(tiles=tiles, l_idx=idx, r_idx=idx, seg=idx, out_slot=idx[:2],
              work=work):
        return ops.tile_contract_chunk(tiles, l_idx, r_idx, seg, out_slot,
                                       idx[:2], 2, work)

    with pytest.raises(TypeError, match="not torch.int32"):
        chunk(tiles=tiles.long())
    with pytest.raises(TypeError, match="not torch.int32"):
        chunk(l_idx=idx.long())
    with pytest.raises(ValueError, match="not CUDA"):
        chunk(r_idx=idx.cpu())
    with pytest.raises(ValueError, match="tiles must be"):
        chunk(tiles=tiles[:, :96, :3].contiguous(),
              work=ops.tile_work(96, 512, card))
    with pytest.raises(ValueError, match="the output tiles are"):
        chunk(tiles=tiles[:, :64, :2].contiguous())
    with pytest.raises(ValueError, match="differ"):
        chunk(r_idx=idx[:3])
    with pytest.raises(ValueError, match="not contiguous"):
        chunk(tiles=tiles.transpose(0, 1))
    with pytest.raises(ValueError, match="needs its TileWork"):
        chunk(work=None)
    with pytest.raises(ValueError, match="work buffers hold"):
        ops.tile_contract_chunk(tiles, idx, idx, idx, idx, idx, 4,
                                ops.tile_work(128, 2, card))
    with pytest.raises(ValueError, match="not CUDA"):
        ops.tile_bitmm(tiles.cpu(), tiles)
    before = ops.tile_launches
    with pytest.raises(ValueError, match="empty bucket"):
        chunk(l_idx=idx[:0], r_idx=idx[:0], seg=idx[:0])
    assert ops.tile_launches == before


@pytest.mark.parametrize("which, value", [
    ("seg", -1), ("seg", 3), ("l_idx", -1), ("l_idx", 8), ("r_idx", 8),
])
def test_tile_kernel_flags_a_pair_out_of_range_as_the_cpu_does(card, which, value):
    """A pair out of range is skipped and raises the fault word on the card
    exactly as on the CPU; the other pairs, in runs sharing an lhs slot,
    are contracted."""
    rng = np.random.default_rng(41)
    tiles = _words(rng, (8, 128, 128), 0.1)
    idx = {"l_idx": _indices(rng, 8, 6, "cpu").repeat_interleave(2)[:6],
           "r_idx": _indices(rng, 8, 6, "cpu"), "seg": _indices(rng, 2, 6, "cpu")}
    idx["seg"][-1] = 2  # a pad pair
    idx[which][1] = value
    out_slot = _indices(rng, 8, 2, "cpu")
    exists = torch.tensor([1, 0], dtype=torch.int32)
    want, want_flags = ops.tile_contract_chunk(tiles, *idx.values(), out_slot,
                                               exists, 2)
    assert int(want_flags[-1]) == 1
    new, flags = ops.tile_contract_chunk(
        *(t.to(card) for t in (tiles, *idx.values(), out_slot, exists)), 2,
        ops.tile_work(128, 512, card))
    assert int(flags[-1]) == 1
    assert torch.equal(new.cpu(), want)


def test_blocksparse_closure_state_on_card_matches_cpu(card):
    """The standalone closure over the compacted state: the same slots,
    coordinates and tile words on the card as on the CPU, through the
    kernel."""
    from repro_torch.core.blocksparse import blocksparse_closure_state

    graph = paper_table_graph("pizza").repeat(4)
    g = query1_grammar().to_cnf()
    want = blocksparse_closure_state(graph, g, tile=64, device="cpu")
    before = ops.tile_launches
    got = blocksparse_closure_state(graph, g, tile=64, device=card)
    assert ops.tile_launches > before
    assert got.coords == want.coords and got.index == want.index
    assert torch.equal(got.tiles.cpu(), want.tiles)


@pytest.mark.parametrize("which, value", [
    ("seg", -1), ("seg", 3), ("l_idx", -1), ("l_idx", 8), ("r_idx", 8),
    ("out_slot", 8),
])
def test_tile_chunk_mode_flags_a_pair_out_of_range(card, which, value):
    """In chunk mode too a pair (or an output's slot) out of range raises
    the fault word, and the block-sparse fixpoint raises on it at its
    chunk sync, as on the CPU."""
    rng = np.random.default_rng(43)
    tiles = _words(rng, (8, 128, 128), 0.1).to(card)
    idx = {"l_idx": _indices(rng, 8, 6, card), "r_idx": _indices(rng, 8, 6, card),
           "seg": _indices(rng, 2, 6, card), "out_slot": _indices(rng, 8, 2, card)}
    exists = torch.ones(2, dtype=torch.int32, device=card)
    idx["seg"][-1] = 2  # a pad pair
    idx[which][1] = value
    work = ops.tile_work(128, 512, card)
    _, flags = ops.tile_contract_chunk(
        tiles, idx["l_idx"], idx["r_idx"], idx["seg"], idx["out_slot"], exists, 2,
        work)
    assert int(flags[-1]) == 1


def test_fixpoint_on_card_raises_on_a_pair_out_of_range(card, monkeypatch):
    from repro_torch.core import blocksparse as tbs

    graph = paper_table_graph("pizza")
    g = query1_grammar().to_cnf()
    operands = tbs._chunk_operands

    def bad_operands(state, chunk, device):
        out = operands(state, chunk, device)
        out[3][0] = state.tiles.shape[0]  # an lhs slot past the store
        return out

    monkeypatch.setattr(tbs, "_chunk_operands", bad_operands)
    with pytest.raises(RuntimeError, match="outside its range"):
        tbs.blocksparse_closure_state(graph, g, tile=64, device=card)


# ---------------------------------------------------------------------- #
# conjunctive and count semantics on the card
# ---------------------------------------------------------------------- #

SAT = 0xFFFFFFFF


def _counts(rng, shape, nonzero, kind):
    """uint32 counts in int32 storage: small values, values near 2^16
    (their products pass 2^32) or SAT itself, zero outside a share
    ``nonzero`` of the entries."""
    if kind == "small":
        a = rng.integers(1, 50, size=shape, dtype=np.uint64)
    elif kind == "2^16":
        a = rng.integers(2**16 - 40, 2**16 + 40, size=shape, dtype=np.uint64)
    else:
        a = np.full(shape, SAT, dtype=np.uint64)
    a[rng.random(shape) >= nonzero] = 0
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("kind", ["small", "2^16", "sat"])
@pytest.mark.parametrize("P, R, K, C", [(3, 50, 70, 90), (2, 9, 1, 1030),
                                        (6, 33, 991, 2048)])
def test_count_mm_kernel_matches_plain_version(card, kind, P, R, K, C):
    """Plain, index (a permuted slab, repeated unsorted rows of a larger
    base) and acc forms, rows of zeros, C off a multiple of 4 and past one
    column tile: the kernel equals the plain version bit for bit, and each
    call counts one launch."""
    rng = np.random.default_rng(P * 100 + K)
    lhs = _counts(rng, (P, R, K), 0.05, kind)
    lhs[:, ::3] = 0
    rhs = _counts(rng, (P, K, C), 0.5, kind)
    base = _counts(rng, (P + 2, K + 7, C), 0.5, "small")
    slab = torch.from_numpy(rng.permutation(P + 2)[:P])
    row = torch.from_numpy(rng.integers(0, K + 7, size=K))
    acc = _counts(rng, (P, R, C), 0.2, kind)
    for args, kwargs in (((lhs, rhs), {}), ((lhs, base, slab, row), {}),
                         ((lhs, base, slab, row), {"acc": acc})):
        want = ref.count_mm_ref(*args, **kwargs)
        before = ops.count_mm_launches
        got = ops.count_mm(*(t.to(card) for t in args),
                           **{k: v.to(card) for k, v in kwargs.items()})
        torch.cuda.synchronize()
        assert ops.count_mm_launches == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", ["small", "2^16", "sat"])
@pytest.mark.parametrize("name", list(SPARSE_ROW_CASES))
def test_count_mm_kernel_matches_plain_version_on_sparse_row_cases(card, name, kind):
    rng = np.random.default_rng(len(name) + len(kind))
    operands = _sparse_row_operands(
        rng, name, lambda shape, d: _counts(rng, shape, d, kind), 0, -1)
    _held_on_card(ops.count_mm, ref.count_mm_ref, "count_mm_launches", card,
                  *operands)


def test_count_mm_kernel_rejects_what_it_does_not_take(card):
    lhs = torch.ones((2, 4, 8), dtype=torch.int32, device=card)
    base = torch.ones((3, 8, 16), dtype=torch.int32, device=card)
    row = torch.arange(8, device=card)
    with pytest.raises(TypeError, match="not torch.int32"):
        ops.count_mm(lhs.long(), base)
    with pytest.raises(ValueError, match="not contiguous"):
        ops.count_mm(lhs.transpose(1, 2).contiguous().transpose(1, 2), base)
    with pytest.raises(ValueError, match="one device"):
        ops.count_mm(lhs, base.cpu())
    with pytest.raises(ValueError, match="outside"):
        ops.count_mm(lhs, base, row=row + 1)
    before = ops.count_mm_launches
    assert ops.count_mm(lhs[:, :0], base).shape == (2, 0, 16)  # empty: no launch
    assert ops.count_mm_launches == before


@pytest.mark.parametrize("backend", ["dense", "bitpacked", "auto"])
def test_conjunctive_and_count_on_card_match_cpu(card, backend):
    """Conjunctive (Query 1 as one conjunct per production) and count
    queries on the card equal the same engine on the CPU, with an
    insert-only edit repaired on both; the card ran its kernels."""
    from repro_torch.core.conjunctive import ConjunctiveGrammar
    from repro_torch.core.graph import Graph

    graph = paper_table_graph("skos")  # the CPU's plain count product is slow
    g = query1_grammar().to_cnf()
    conj = ConjunctiveGrammar.from_rules(
        {x: [g.nonterms[a] for a in lhss] for x, lhss in g.term_prods.items()},
        [(g.nonterms[a], [(g.nonterms[b], g.nonterms[c])])
         for a, b, c in g.binary_prods])
    batches = [[Query(conj, "S", sources=(0, 7), semantics="conjunctive"),
                Query(g, "S", sources=(0, 7), semantics="count")],
               [Query(conj, "S", semantics="conjunctive"),
                Query(g, "S", semantics="count")]]
    engines = {dev: QueryEngine(Graph(graph.n_nodes, list(graph.edges)),
                                config=EngineConfig(engine=backend, device=dev))
               for dev in ("cpu", "cuda")}
    before = ops.launches, ops.count_mm_launches
    for batch in batches + [None] + batches:
        if batch is None:
            for eng in engines.values():  # type_r·type: a new S-pair (3, 5)
                st = eng.apply_delta(insert=[(3, "type_r", 100), (100, "type", 5)])
                assert st.conj_repairs == 1 and st.count_repairs == 1
            continue
        want = engines["cpu"].query_batch(batch)
        got = engines["cuda"].query_batch(batch)
        assert [r.pairs for r in got] == [r.pairs for r in want]
        assert [r.counts for r in got] == [r.counts for r in want]
    assert ops.count_mm_launches > before[1]
    if backend == "bitpacked":
        assert ops.launches > before[0]



# ---------------------------------------------------------------------- #
# the opt family in a one-rank NCCL world (NCCL takes one rank per card)
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def nccl_mesh():
    """A 1 x 1 (data, model) mesh over a one-rank NCCL world of card 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    if own:
        dist.destroy_process_group()


def test_opt_closures_on_card_match_cpu(card, nccl_mesh):
    """``opt_closure``, ``opt_step``, ``masked_opt_closure`` and
    ``masked_opt_single_path_closure`` on the card, with ``plan=None`` and
    with the mesh, equal the CPU's ``plan=None`` results; the relational
    closures launch ``bitmm``, the single-path one ``minplus``."""
    from repro_torch.core import closure, semantics
    from repro_torch.shard.plans import MeshPlan

    g = query1_grammar().to_cnf()
    tables = tm.ProductionTables.from_grammar(g)
    T0 = tm.init_matrix(paper_table_graph("foaf").repeat(2), g, device="cpu")
    n = T0.shape[-1]
    src = torch.zeros(n, dtype=torch.bool)
    src[[0, 7, 300]] = True
    L0 = semantics.base_lengths(T0)
    want = {
        "opt": closure.opt_closure(T0, tables),
        "step": closure.opt_step(tm.pack_bits(T0), tables, n),
        "masked": closure.masked_opt_closure(T0, tables, src, row_capacity=128),
        "sp": semantics.masked_opt_single_path_closure(L0, tables, src, row_capacity=128),
    }
    T, L, S = T0.to(card), L0.to(card), src.to(card)
    for plan in (None, MeshPlan.from_mesh(nccl_mesh)):
        def whole(x):
            return (x if plan is None else x.full()).cpu()

        before = (ops.launches, ops.minplus_launches)
        assert torch.equal(whole(closure.opt_closure(T, tables, plan=plan)), want["opt"])
        step = closure.opt_step(tm.pack_bits(T), tables, n, plan=plan)
        assert torch.equal(
            step.cpu() if plan is None else tm.pack_bits(step.full()).cpu(), want["step"])
        got = closure.masked_opt_closure(T, tables, S, row_capacity=128, plan=plan)
        assert torch.equal(whole(got[0]), want["masked"][0])
        assert torch.equal(got[1].cpu(), want["masked"][1]) and got[2] == want["masked"][2]
        got = semantics.masked_opt_single_path_closure(L, tables, S, row_capacity=128,
                                                       plan=plan)
        assert torch.equal(whole(got[0]), want["sp"][0])
        assert torch.equal(got[1].cpu(), want["sp"][1]) and got[2] == want["sp"][2]
        torch.cuda.synchronize()
        assert ops.launches > before[0] and ops.minplus_launches > before[1]


def test_opt_engine_on_card_matches_engine_on_cpu(card, nccl_mesh):
    """The mesh-backed ``opt`` engine on the card answers as the CPU's
    one-device ``opt`` engine: pairs, witnesses, cache statuses and repair
    stats through both semantics and an edit; the repair localizes the
    sharded state and the next closure shards it again."""
    from repro_torch.shard.plans import ShardedState

    g = query1_grammar().to_cnf()
    # the edit stays in copy 0 and the last batch asks for every row, so
    # its closure runs on the repaired state
    batches = [[Query(g, "S", sources=(0, 5)), Query(g, "S", sources=(3,),
                                                      semantics="single_path")],
               [Query(g, "S", semantics="single_path")]]

    def run(dev, mesh):
        eng = QueryEngine(paper_table_graph("skos").repeat(2),
                          config=EngineConfig(engine="opt", device=dev, mesh=mesh))
        out = [eng.query_batch(batches[0])]
        (state,) = eng._states.values()
        kinds = [type(state.T).__name__]
        out.append(eng.apply_delta(delete=[(1, "subClassOf_r", 0)],
                                   insert=[(3, "type_r", 20), (20, "type", 5)]))
        kinds.append(type(state.T).__name__)
        out += [eng.query_batch(b) for b in batches]
        kinds.append(type(state.sp_L).__name__)
        return out, state, kinds

    want, want_state, _ = run("cpu", None)
    got, got_state, kinds = run("cuda", nccl_mesh)
    assert kinds == ["ShardedState", "Tensor", "ShardedState"]
    for w, x in zip(want, got):
        if isinstance(w, list):
            assert [(r.pairs, r.paths, r.stats["cache"], r.stats["engine"]) for r in x] == \
                [(r.pairs, r.paths, r.stats["cache"], r.stats["engine"]) for r in w]
        else:
            assert x.as_dict() == w.as_dict()
    assert np.array_equal(got_state.T_host, want_state.T_host)
    assert np.array_equal(got_state.sp_L_host, want_state.sp_L_host)
    assert isinstance(got_state.sp_L, ShardedState)
    assert torch.equal(got_state.sp_L.full().cpu(), want_state.sp_L)


def test_cuda_mesh_refuses_a_cpu_engine(card, nccl_mesh):
    with pytest.raises(ValueError, match="must match"):
        EngineConfig(engine="opt", device="cpu", mesh=nccl_mesh)
    with pytest.raises(ValueError, match="only supported by the 'opt' engine"):
        EngineConfig(engine="bitpacked", device="cuda", mesh=nccl_mesh)


def test_calibration_tool_smoke_on_card(card, tmp_path):
    """tools/calibrate_planner_torch.py --smoke on the card: rc 0, the
    round trip OK, and a fitted profile stamped with the card's name."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "profile.json"
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    run = subprocess.run(
        [sys.executable, str(root / "tools" / "calibrate_planner_torch.py"),
         "--smoke", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "round-trip OK" in run.stdout
    profile = json.loads(out.read_text())
    assert profile["fitted"] is True and profile["version"] == 1
    assert profile["host"].endswith(f":cuda:{torch.cuda.get_device_name(card)}")


def test_lm_decode_on_card_matches_cpu(card):
    """The reduced smollm's forward and token-by-token decode on the card
    equal the CPU port's in f32 (same weights, moved from the CPU)."""
    import copy
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.models import transformer as ttf

    cfg = dataclasses.replace(reduce_config(registry.get_config("smollm-360m")), dtype="float32")
    on_cpu = ttf.Transformer(cfg, device="cpu", seed=0)
    on_card = copy.deepcopy(on_cpu).to(card)
    tokens = torch.from_numpy(np.random.default_rng(22).integers(0, cfg.vocab, (2, 16)))

    def run(model, ids, dev):
        with torch.inference_mode():
            full, _ = ttf.forward(model, ids, cfg)
            kv = ttf.init_cache(cfg, 2, 16, device=dev)
            steps = [ttf.serve_step(model, kv, ids[:, t:t + 1], t, cfg)[0] for t in range(16)]
        return full.cpu(), torch.stack(steps, dim=1).cpu()

    for got, want in zip(run(on_card, tokens.to(card), card), run(on_cpu, tokens, torch.device("cpu"))):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

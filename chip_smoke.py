"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels (``bitmm`` and ``bitmm_or``)
from this checkout, holds each against its plain torch version on the card,
drives the port's main path (relational CFPQ served by
``repro_torch.engine.QueryEngine``) at full size —
``paper_table_graph("pizza").repeat(16)``, 15,856 nodes padded to
n = 15,872, with Query 1 in CNF — and checks every answer against the
port's Hellings worklist oracle.  Then the delta path: on warm all-pairs
states of the bitpacked, dense and auto engines, seeded edge edits through
``QueryEngine.apply_delta`` are repaired row by row (the bitpacked repair
through ``bitmm_or``) and checked against Hellings, against a fresh
engine's closure, and for bit-identical untouched rows.  Each phase prints
one JSON line; the last line is ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the script exits non-zero; so does a machine without a CUDA device.
It imports nothing of JAX and nothing of the JAX reference package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM rates (NVIDIA data sheet) for the bounds: HBM3 bytes
# per second, and INT32 operations per second on the SMs' integer lanes
# (132 SMs x 64 INT32 lanes x 1.98 GHz boost clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

PIZZA_COPIES = 16
PIZZA_S_PAIRS = 313  # Query 1's S-pairs on one pizza copy (Hellings)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after ``warmup``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_words(gen, shape, density, device):
    """Packed int32 words with bits set at ``density``; at 0.5 every bit
    pattern is equally likely, bit 31 included."""
    B, rows, words = shape
    if density == 0.5:
        return torch.randint(
            -(2**31), 2**31, shape, generator=gen, dtype=torch.int64,
            device=device,
        ).to(torch.int32)
    from repro_torch.core.matrices import pack_bits

    bits = torch.rand((B, rows, 32 * words), generator=gen, device=device)
    return pack_bits(bits < density)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    emit(
        "device", name=info["kind"], count=info["count"], nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
    )
    print(smi, flush=True)
    return info


def phase_build() -> None:
    from repro_torch.kernels import bitmm as kbitmm

    kbitmm.library()  # one source, one nvcc: both kernels' entry points
    emit(
        "build", kernels=["bitmm", "bitmm_or"],
        seconds=kbitmm.BUILD_INFO["seconds"],
        library=Path(kbitmm.BUILD_INFO["path"]).name,
        ptxas=[ln for ln in kbitmm.BUILD_INFO["log"].splitlines() if ln],
    )


def phase_kernel_checks(dev) -> int:
    """ops.bitmm against the plain bitmm_ref, word for word, on the card."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    for n in (128, 512, 4096):
        for B in (1, 6):
            for d in (0.0, 0.05, 0.5):
                cases.append((f"square n={n} B={B} d={d}", (B, n, n // 32),
                              (B, n, n // 32), d))
    for R, n in ((32, 256), (96, 128), (256, 128)):
        cases.append((f"rect R={R} n={n}", (6, R, n // 32), (6, n, n // 32), 0.15))
    for R in (128, 15872):
        cases.append((f"main-path R={R} d=0.5", (6, R, 496), (6, 15872, 496), 0.5))
    cases.append(("tile_bitmm batch", (512, 128, 4), (512, 128, 4), 0.1))
    checked = 0
    for name, lshape, rshape, d in cases:
        lhs = random_words(gen, lshape, d, dev)
        rhs = random_words(gen, rshape, d, dev)
        got = ops.bitmm(lhs, rhs)
        want = ref.bitmm_ref(lhs, rhs)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"bitmm != bitmm_ref on {name}")
        checked += 1
        del lhs, rhs, got, want
    # all-zero and all-ones lhs rows, ragged m and w, rhs words with bit 31
    lhs = random_words(gen, (2, 100, 8), 0.5, dev)
    lhs[:, :10] = 0
    lhs[:, 10:20] = -1
    rhs = random_words(gen, (2, 256, 40), 0.05, dev)
    rhs[:, ::3] |= torch.iinfo(torch.int32).min
    got, want = ops.bitmm(lhs, rhs), ref.bitmm_ref(lhs, rhs)
    check(torch.equal(got, want), "bitmm != bitmm_ref on edge rows/bit 31")
    check(bool((got[:, :10] == 0).all()), "all-zero lhs rows must give 0")
    check(torch.equal(got[0, 10], _or_rows(rhs[0])),
          "an all-ones lhs row must give the OR of every rhs row")
    checked += 1
    torch.cuda.empty_cache()
    emit("kernels_checked", kernel="bitmm", cases=checked, tolerance="exact "
         "word equality (torch.equal)")
    return checked


def phase_bitmm_or_checks(dev) -> int:
    """ops.bitmm_or against the plain bitmm_or_ref, word for word, on the
    card: square and repair shapes, acc all zeros and all ones, bit 31 in
    acc and rhs, ragged m and w."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = []
    for n in (128, 512, 4096):
        for B in (1, 6):
            for d in (0.0, 0.05, 0.5):
                cases.append((f"square n={n} B={B} d={d}", (B, n, n // 32),
                              (B, n, n // 32), d))
    for R in (128, 1024, 2048):  # 2048: the delta phase's bitpacked repair
        for d in (0.05, 0.5):
            cases.append((f"repair R={R} d={d}", (6, R, 496), (6, 15872, 496), d))
    checked = 0
    for name, lshape, rshape, d in cases:
        lhs = random_words(gen, lshape, d, dev)
        rhs = random_words(gen, rshape, d, dev)
        acc = random_words(gen, (lshape[0], lshape[1], rshape[-1]), d, dev)
        got = ops.bitmm_or(lhs, rhs, acc)
        want = ref.bitmm_or_ref(lhs, rhs, acc)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"bitmm_or != bitmm_or_ref on {name}")
        check(torch.equal(got & acc, acc), f"bitmm_or lost acc bits on {name}")
        checked += 1
        if name.startswith("repair R=1024 d=0.5"):
            zero = ops.bitmm_or(lhs, rhs, torch.zeros_like(acc))
            check(torch.equal(zero, ops.bitmm(lhs, rhs)),
                  "bitmm_or with acc all zero != bitmm")
            ones = ops.bitmm_or(lhs, rhs, torch.full_like(acc, -1))
            check(bool((ones == -1).all()),
                  "bitmm_or with acc all ones must give all-ones words")
            checked += 2
        del lhs, rhs, acc, got, want
    # bit 31 in acc and rhs, ragged m and w, zero lhs rows keep acc as is
    lhs = random_words(gen, (2, 100, 8), 0.5, dev)
    lhs[:, :10] = 0
    rhs = random_words(gen, (2, 256, 40), 0.05, dev)
    rhs[:, ::3] |= torch.iinfo(torch.int32).min
    acc = random_words(gen, (2, 100, 40), 0.05, dev)
    acc[:, ::2] |= torch.iinfo(torch.int32).min
    got, want = ops.bitmm_or(lhs, rhs, acc), ref.bitmm_or_ref(lhs, rhs, acc)
    check(torch.equal(got, want), "bitmm_or != bitmm_or_ref on bit 31/ragged")
    check(torch.equal(got[:, :10], acc[:, :10]),
          "zero lhs rows must give their acc words unchanged")
    checked += 1
    torch.cuda.empty_cache()
    emit("kernels_checked", kernel="bitmm_or", cases=checked, tolerance="exact "
         "word equality (torch.equal)")
    return checked


def _or_rows(t: torch.Tensor) -> torch.Tensor:
    out = t[0].clone()
    for k in range(1, t.shape[0]):
        out |= t[k]
    return out


def shifted_oracle() -> set[tuple[int, int]]:
    """Hellings on ONE pizza copy, shifted to every disjoint copy."""
    from repro_torch.baselines.hellings import hellings_cfpq
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import paper_table_graph

    base = paper_table_graph("pizza")
    rel = hellings_cfpq(base, query1_grammar().to_cnf())["S"]
    off = base.n_nodes
    return {(i + t * off, j + t * off) for t in range(PIZZA_COPIES) for i, j in rel}


def run_phase(fn):
    """Run ``fn`` with the kernel counts at 0 and the peak memory reset;
    returns (result, wall ms, ``{"bitmm": .., "bitmm_or": ..}`` launches in
    the run)."""
    from repro_torch.kernels import ops

    ops.launches = ops.or_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, {"bitmm": ops.launches, "bitmm_or": ops.or_launches}


def closure_calls(engine) -> int:
    return int(sum(c.value for c in engine.metrics.closure_calls.children))


def phase_main_path(dev):
    from repro_torch.core import closure
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import paper_table_graph
    from repro_torch.core.matrices import (
        ProductionTables, init_matrix, relations_from_matrix,
    )
    from repro_torch.engine import EngineConfig, Query, QueryEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    graph = paper_table_graph("pizza").repeat(PIZZA_COPIES)
    g = query1_grammar().to_cnf()
    t0 = time.perf_counter()
    oracle = shifted_oracle()
    emit("oracle", pairs=len(oracle), nodes=graph.n_nodes,
         edges=len(graph.edges), seconds=time.perf_counter() - t0)
    check(len(oracle) == PIZZA_S_PAIRS * PIZZA_COPIES,
          f"oracle has {len(oracle)} pairs, want {PIZZA_S_PAIRS * PIZZA_COPIES}")
    launches = {}

    def engine_of(name):
        # spans without iteration events: the uninstrumented closures run
        return QueryEngine(
            graph, config=EngineConfig(engine=name, device=str(dev)),
            metrics=MetricsRegistry(), tracer=Tracer(iteration_events=False),
        )

    def report(phase, eng, wall_ms, n_launch, **extra):
        # closure.execute spans end after the closure's mask reached the
        # host, so they hold the closure's device work; the rest of the
        # wall time is building T0, copying the state out and slicing pairs
        closure_ms = 1e3 * sum(
            s.duration_s for s in eng.tracer.spans if s.name == "closure.execute"
        )
        emit(phase, wall_ms=wall_ms, closure_execute_ms=closure_ms,
             closure_calls=closure_calls(eng), bitmm_launches=n_launch,
             n=eng.n, max_memory_allocated=torch.cuda.max_memory_allocated(),
             **extra)

    # 1. the paper's all-pairs query on the bitpacked backend (masked
    #    closure at R = n through the bitmm kernel)
    eng = engine_of("bitpacked")
    res, ms, counts = run_phase(lambda: eng.query(Query(g, "S")))
    n_launch = counts["bitmm"]
    check(res.pairs == oracle, "bitpacked all-pairs != shifted Hellings")
    check(n_launch > 0, "bitpacked all-pairs never launched the bitmm kernel")
    launches["allpairs_bitpacked"] = n_launch
    report("allpairs_bitpacked", eng, ms, n_launch, pairs=len(res.pairs),
           cache=res.stats.cache)
    allpairs = res.pairs
    del eng, res

    # 2. the same query on a fresh dense engine
    eng = engine_of("dense")
    res, ms, counts = run_phase(lambda: eng.query(Query(g, "S")))
    n_launch = counts["bitmm"]
    check(res.pairs == allpairs, "dense all-pairs != bitpacked all-pairs")
    report("allpairs_dense", eng, ms, n_launch, pairs=len(res.pairs))
    del eng, res

    # 3. a batch of 256 single-source queries: the masked path at R < n
    rng = np.random.default_rng(0)
    sources = rng.choice(graph.n_nodes, size=256, replace=False).tolist()
    batch = [Query(g, "S", sources=(int(s),)) for s in sources]
    want = {s: {p for p in allpairs if p[0] == s} for s in sources}
    for backend in ("bitpacked", "auto"):
        eng = engine_of(backend)
        outs, ms, counts = run_phase(lambda: eng.query_batch(batch))
        n_launch = counts["bitmm"]
        for s, out in zip(sources, outs):
            check(out.pairs == want[s], f"{backend} batch source {s} differs")
        launches[f"batch_{backend}"] = n_launch
        if backend == "bitpacked":
            check(n_launch > 0, "bitpacked batch never launched bitmm")
        report(f"batch_{backend}", eng, ms, n_launch, queries=len(batch),
               route=outs[0].stats.planner["label"],
               pairs=sum(len(o.pairs) for o in outs))
        del eng, outs

    # 4. the plain all-pairs bitpacked closure (evaluate_relational's path);
    #    its final state gives the kernel's main-path operands below
    tables = ProductionTables.from_grammar(g)

    def allpairs_closure():
        return closure.bitpacked_closure(init_matrix(graph, g, device=dev), tables)

    T, ms, counts = run_phase(allpairs_closure)
    n_launch = counts["bitmm"]
    rel = relations_from_matrix(T, g, graph.n_nodes)["S"]
    check(rel == oracle, "bitpacked_closure != shifted Hellings")
    check(n_launch > 0, "bitpacked_closure never launched bitmm")
    launches["closure_bitpacked"] = n_launch
    emit("closure_bitpacked", wall_ms=ms, bitmm_launches=n_launch,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         pairs=len(rel))
    return T, tables, launches


def bound(lhs: torch.Tensor, rhs: torch.Tensor, out_numel: int, acc_numel: int = 0):
    """Least time for the product on these inputs, counting only what these
    inputs need: bytes = lhs read once, out written once (and for bitmm_or
    acc read once), and of the rhs only the rows k whose contraction bit is
    set in some lhs row of the same batch, over HBM; operations = one OR of
    a w-word rhs row per set lhs bit, over the INT32 rate."""
    from repro_torch.core.matrices import unpack_bits

    w = rhs.shape[-1]
    set_bits = needed_rows = 0
    for b in range(lhs.shape[0]):
        bits = unpack_bits(lhs[b], 32 * lhs.shape[-1])
        set_bits += int(bits.sum())
        needed_rows += int(bits.any(0).sum())
        del bits
    words = lhs.numel() + out_numel + acc_numel + needed_rows * w
    bytes_ms = 4 * words / HBM_BYTES_PER_S * 1e3
    ops_ms = set_bits * w / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return bound_ms, ("bytes" if bytes_ms >= ops_ms else "operations"), needed_rows


def phase_kernel_timing(T, tables, launches, repair) -> None:
    """Time bitmm, its plain version and the library yardstick at the main
    path's shapes: on the main path's own final state (all-pairs R = n and
    a masked R = 128 block), and on random words (every bit set with
    probability 1/2, so no k-step can be skipped).  Then bitmm_or at the
    bitpacked repair's shape (its row capacity ``repair["R"]``) on the
    state's active block: lhs ``Tp[b_idx][:, :R]``, acc ``Tp[a_idx][:, :R]``
    — the first R rows, the pizza copies the delta phase edits."""
    from repro_torch.core.matrices import pack_bits, unpack_bits
    from repro_torch.kernels import ops, ref

    Tp = pack_bits(T)
    del T
    b_idx, c_idx = tables.index_tensors(Tp.device)
    rhs_state = Tp[c_idx].contiguous()
    gen = torch.Generator(device=Tp.device)
    gen.manual_seed(1)
    configs = [
        ("main-path state", Tp.shape[1], lambda R: Tp[b_idx][:, :R].contiguous(),
         rhs_state),
        ("main-path state", 128, lambda R: Tp[b_idx][:, :R].contiguous(),
         rhs_state),
        ("random words", Tp.shape[1],
         lambda R: random_words(gen, (len(b_idx), R, Tp.shape[-1]), 0.5, Tp.device),
         random_words(gen, tuple(rhs_state.shape), 0.5, Tp.device)),
    ]
    rows = []
    for data, R, make_lhs, rhs in configs:
        lhs = make_lhs(R)
        got = ops.bitmm(lhs, rhs)
        want = ref.bitmm_ref(lhs, rhs)
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"bitmm != bitmm_ref on {data}, R={R}")
        del got, want
        ms = time_ms(lambda: ops.bitmm(lhs, rhs), reps=10, warmup=2)
        plain_ms = time_ms(lambda: ref.bitmm_ref(lhs, rhs), reps=3)
        a = unpack_bits(lhs, rhs.shape[1]).to(torch.bfloat16)
        bmat = unpack_bits(rhs, 32 * rhs.shape[-1]).to(torch.bfloat16)
        library_ms = time_ms(lambda: torch.matmul(a, bmat), reps=5)
        del a, bmat
        torch.cuda.empty_cache()
        bound_ms, bound_by, needed_rows = bound(
            lhs, rhs, lhs.shape[0] * R * rhs.shape[-1]
        )
        rows.append({
            "data": data, "R": R, "lhs": list(lhs.shape), "rhs": list(rhs.shape),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "rhs_rows_needed": needed_rows, "max_abs_err": err,
        })
    emit("kernel_timing", kernel="bitmm", rows=rows, launches=launches)

    R = repair["R"]
    a_idx = torch.tensor(tables.a_idx, dtype=torch.int64, device=Tp.device)
    lhs = Tp[b_idx][:, :R].contiguous()
    acc = Tp[a_idx][:, :R].contiguous()
    got = ops.bitmm_or(lhs, rhs_state, acc)
    want = ref.bitmm_or_ref(lhs, rhs_state, acc)
    or_err = int((got.long() - want.long()).abs().max())
    check(or_err == 0, f"bitmm_or != bitmm_or_ref on the state, R={R}")
    del got, want
    or_ms = time_ms(lambda: ops.bitmm_or(lhs, rhs_state, acc), reps=10, warmup=2)
    or_plain_ms = time_ms(lambda: ref.bitmm_or_ref(lhs, rhs_state, acc), reps=3)
    a = unpack_bits(lhs, rhs_state.shape[1]).to(torch.bfloat16)
    bmat = unpack_bits(rhs_state, 32 * rhs_state.shape[-1]).to(torch.bfloat16)
    or_library_ms = time_ms(lambda: torch.matmul(a, bmat), reps=5)
    del a, bmat
    torch.cuda.empty_cache()
    or_bound_ms, or_bound_by, or_needed = bound(
        lhs, rhs_state, acc.numel(), acc_numel=acc.numel()
    )
    or_row = {
        "data": "main-path state, active block", "R": R,
        "lhs": list(lhs.shape), "rhs": list(rhs_state.shape),
        "acc": list(acc.shape), "ms": or_ms, "plain_ms": or_plain_ms,
        "library_ms": or_library_ms, "bound_ms": or_bound_ms,
        "bound_by": or_bound_by, "rhs_rows_needed": or_needed,
        "max_abs_err": or_err,
    }
    emit("kernel_timing", kernel="bitmm_or", rows=[or_row],
         launches_per_repair=repair["launches"])
    main = rows[0]
    summary = {"kernels": [{
        "name": "bitmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitmm.cu",
        "replaces": "src/repro/kernels/bitmm.py:107",
        "launches": launches["allpairs_bitpacked"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }, {
        "name": "bitmm_or",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitmm.cu",
        "replaces": "src/repro/kernels/bitmm.py:73",
        "launches": repair["launches"],
        "max_abs_err": or_err,
        "ms": or_ms,
        "plain_ms": or_plain_ms,
        "bound_ms": or_bound_ms,
        "bound_by": or_bound_by,
        "library_ms": or_library_ms,
    }]}
    print(json.dumps(summary), flush=True)


DELTA_ROUNDS = 2  # interleaved rounds of edits and queries after the first


def _copy_oracle(graph, g, copy: int, off: int) -> set[tuple[int, int]]:
    """Hellings on pizza copy ``copy`` of ``graph`` alone, in global ids."""
    from repro_torch.baselines.hellings import hellings_cfpq
    from repro_torch.core.graph import Graph

    lo, hi = copy * off, (copy + 1) * off
    edges = [(i - lo, x, j - lo) for i, x, j in graph.edges if lo <= i < hi]
    check(all(0 <= j < off for _, _, j in edges), "an edge leaves its copy")
    rel = hellings_cfpq(Graph(off, edges), g)["S"]
    return {(i + lo, j + lo) for i, j in rel}


def _seeded_edits(rng, graph, g, off: int):
    """Two deletes and three inserts in each of pizza copies 0 and 1; insert
    labels are the grammar's terminals, endpoints in the same copy."""
    labels = sorted(g.term_prods)
    delete, insert = [], []
    for copy in (0, 1):
        lo = copy * off
        own = [e for e in graph.edges if lo <= e[0] < lo + off]
        for k in rng.choice(len(own), size=2, replace=False):
            delete.append(own[int(k)])
        for _ in range(3):
            i, j = (int(v) + lo for v in rng.integers(0, off, size=2))
            insert.append((i, labels[int(rng.integers(0, len(labels)))], j))
    return delete, insert


def phase_delta(dev):
    """Delta repair at full width, per backend: warm an all-pairs state,
    apply seeded edits to copies 0 and 1 through ``apply_delta``, then
    interleave more edits with all-pairs and single-source queries.  After
    the first delta and after the last round: the served pairs equal the
    oracle, the rows under the mask equal a fresh engine's closure of the
    mutated graph, and the rows of copies 2..15 are bit-identical to the
    warm state.  Returns what the bitmm_or timing row needs."""
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import Graph, paper_table_graph
    from repro_torch.engine import EngineConfig, Query, QueryEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    g = query1_grammar().to_cnf()
    off = paper_table_graph("pizza").n_nodes
    pristine = _copy_oracle(paper_table_graph("pizza"), g, 0, off)
    untouched = {(i + t * off, j + t * off)
                 for t in range(2, PIZZA_COPIES) for i, j in pristine}
    frozen_rows = np.arange(2 * off, PIZZA_COPIES * off)
    repair_info = None

    def engine_of(graph, name):
        return QueryEngine(
            graph, config=EngineConfig(engine=name, device=str(dev)),
            metrics=MetricsRegistry(), tracer=Tracer(iteration_events=False),
        )

    def span_ms(eng, first, name, **attrs):
        return 1e3 * sum(
            s.duration_s for s in eng.tracer.spans[first:] if s.name == name
            and all(s.attrs.get(k) == v for k, v in attrs.items())
        )

    for backend in ("bitpacked", "dense", "auto"):
        rng = np.random.default_rng(7)
        graph = paper_table_graph("pizza").repeat(PIZZA_COPIES)
        eng = engine_of(graph, backend)
        res, warm_ms, _ = run_phase(lambda: eng.query(Query(g, "S")))
        (state,) = eng._states.values()
        warm_frozen = state.T_host[:, frozen_rows, :].copy()

        def oracle():
            return untouched | _copy_oracle(graph, g, 0, off) | _copy_oracle(
                graph, g, 1, off)

        def verify(label):
            """The state checks on the engine's state as the last repair
            left it, then the served all-pairs answer against the oracle."""
            (st,) = eng._states.values()
            fresh = engine_of(Graph(graph.n_nodes, list(graph.edges)), backend)
            _, fresh_ms, _ = run_phase(lambda: fresh.query(Query(g, "S")))
            (fst,) = fresh._states.values()
            M = st.mask
            check(np.array_equal(st.T_host[:, M, :], fst.T_host[:, M, :]),
                  f"{backend} {label}: repaired rows != fresh closure rows")
            del fresh, fst
            check(np.array_equal(st.T_host[:, frozen_rows, :], warm_frozen),
                  f"{backend} {label}: rows of unedited copies changed")
            t0 = time.perf_counter()
            full = st.T.cpu().numpy()
            full_copy_ms = (time.perf_counter() - t0) * 1e3
            check(np.array_equal(full, st.T_host),
                  f"{backend} {label}: host copy != device state")
            del full
            res = eng.query(Query(g, "S"))
            check(res.pairs == oracle(), f"{backend} {label}: pairs != oracle")
            return res, fresh_ms, full_copy_ms

        delete, insert = _seeded_edits(rng, graph, g, off)
        first = len(eng.tracer.spans)
        st, delta_ms, n_launch = run_phase(
            lambda: eng.apply_delta(insert=insert, delete=delete)
        )
        peak = torch.cuda.max_memory_allocated()
        repairs = [s for s in eng.tracer.spans[first:]
                   if s.name == "closure.execute" and s.attrs.get("repair")]
        check(st.rows_repaired > 0 and st.rows_evicted > 0,
              f"{backend}: the delta repaired or evicted nothing: {st}")
        if backend == "bitpacked":
            check(n_launch["bitmm_or"] > 0,
                  "the bitpacked repair never launched bitmm_or")
            keys = [k for k in eng.plans._exe if k.repair]
            repair_info = {"R": max(k.row_capacity for k in keys),
                           "launches": n_launch["bitmm_or"]}
        res, fresh_ms, full_copy_ms = verify("after the delta")
        emit(
            f"delta_{backend}", edits={"delete": len(delete), "insert": len(insert)},
            warm_allpairs_ms=warm_ms, apply_delta_ms=delta_ms,
            delta_repair_span_ms=span_ms(eng, first, "delta.repair"),
            repair_closure_execute_ms=span_ms(eng, first, "closure.execute",
                                              repair=True),
            host_copy_ms=span_ms(eng, first, "delta.host_copy"),
            host_copy_rows=sum(s.attrs["rows"] for s in eng.tracer.spans[first:]
                               if s.name == "delta.host_copy"),
            full_state_copy_ms=full_copy_ms, fresh_allpairs_ms=fresh_ms,
            route=[s.attrs["engine"] for s in repairs],
            repair_calls=len(repairs), launches=n_launch,
            max_memory_allocated=peak, **st.as_dict(),
            served_after=res.stats.cache,
        )

        rounds = []
        for r in range(DELTA_ROUNDS):
            delete, insert = _seeded_edits(rng, graph, g, off)
            st, ms, n_launch = run_phase(
                lambda: eng.apply_delta(insert=insert, delete=delete)
            )
            if backend == "bitpacked":
                check(n_launch["bitmm_or"] > 0, "a repair never launched bitmm_or")
            res, q_ms, _ = run_phase(lambda: eng.query(Query(g, "S")))
            check(res.pairs == oracle(), f"{backend} round {r}: pairs != oracle")
            sources = [int(s) for s in rng.choice(2 * off, size=32, replace=False)]
            sources += [int(s) for s in rng.choice(graph.n_nodes, size=32,
                                                  replace=False)]
            outs = eng.query_batch([Query(g, "S", sources=(s,)) for s in sources])
            for s, out in zip(sources, outs):
                check(out.pairs == {p for p in res.pairs if p[0] == s},
                      f"{backend} round {r}: source {s} != all-pairs rows")
            rounds.append({"apply_delta_ms": ms, "allpairs_ms": q_ms,
                           "launches": n_launch, **st.as_dict()})
        res, fresh_ms, full_copy_ms = verify(f"after {DELTA_ROUNDS} rounds")
        emit(f"delta_{backend}_rounds", rounds=rounds, fresh_allpairs_ms=fresh_ms,
             full_state_copy_ms=full_copy_ms,
             delta_stats_total=eng.delta_stats.as_dict(), epoch=eng.clock.epoch)
        del eng, state, warm_frozen, res
        torch.cuda.empty_cache()
    return repair_info


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails here outside a checkout)

    info = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_kernel_checks(dev)
    phase_bitmm_or_checks(dev)
    T, tables, launches = phase_main_path(dev)
    repair = phase_delta(dev)
    phase_kernel_timing(T, tables, launches, repair)
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline-cu OTHER_REVISION/src/repro_torch/kernels/csrc/bitmm.cu]

Builds the port's hand-written CUDA kernels (``bitmm`` and ``bitmm_or``)
from this checkout and fails if ptxas reports a spill in any template
instance; holds each kernel against its plain torch version on the card,
through its compiled-in path threshold and with each of its two paths
(sparse row gather, staged dense tiles) forced; drives the port's main
path (relational CFPQ served by ``repro_torch.engine.QueryEngine``) at
full size — ``paper_table_graph("pizza").repeat(16)``, 15,856 nodes padded
to n = 15,872, with Query 1 in CNF — and checks every answer against the
port's Hellings worklist oracle.  Then the delta path: on warm all-pairs
states of the bitpacked, dense and auto engines, seeded edge edits through
``QueryEngine.apply_delta`` are repaired row by row (the bitpacked repair
through ``bitmm_or``) and checked against Hellings, against a fresh
engine's closure, and for bit-identical untouched rows.  Last, the kernels
are timed at the main path's shapes (one call, device time, with L2 cold,
and per path) and over a density sweep that shows where the two paths
cross.  ``--baseline-cu`` names another revision's kernel source (say, the
parent commit's, unpacked with ``git archive``): it is built too, and its
device time is timed beside this one's on the same operands.  Each phase
prints one JSON line; the last line is ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero; so does a machine
without a CUDA device.
It imports nothing of JAX and nothing of the JAX reference package.
"""
from __future__ import annotations

import argparse
import json
import re
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


SLEEP_CYCLES = 20_000_000  # about 10 ms of the H100's clock


def time_ms(fn, reps: int, warmup: int = 1, flush=None) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` (after
    ``warmup``).  The events also hold whatever host work ``fn`` does
    before its kernel starts.  With ``flush`` (a device buffer larger than
    L2) the buffer is written before each call, behind a sleep on the
    stream and outside the timed events, so each call finds L2 cold and the
    host's work does not show."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            torch.cuda._sleep(SLEEP_CYCLES // 10)
            flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Device time per call of ``fn``: ``reps`` calls back to back between
    two CUDA events, queued behind a sleep on the stream so that the host's
    work per call (the wrapper's checks, the launch) stays hidden."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def ptxas_instances(log: str) -> list[dict]:
    """Registers and spills of each template instance of the kernel, from
    ``nvcc -Xptxas -v``: ``bitmm_kernel<kAcc, NV, V>`` (kAcc 1 is
    bitmm_or; NV units of V words per lane in the sparse path)."""
    found, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*bitmm_kernelILb(\d)ELi(\d+)ELi(\d+)E", ln)
        if m:
            name = "bitmm_kernel<{}, {}, {}>".format(
                "true" if m.group(1) == "1" else "false", m.group(2), m.group(3))
            found.append({"instance": name})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            found[-1].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            found[-1]["registers"] = int(m.group(1))
            name = None
    return found


def phase_build() -> None:
    from repro_torch.kernels import bitmm as kbitmm

    kbitmm.library()  # one source, one nvcc: both kernels' entry points
    instances = ptxas_instances(kbitmm.BUILD_INFO["log"])
    emit(
        "build", kernels=["bitmm", "bitmm_or"],
        seconds=kbitmm.BUILD_INFO["seconds"],
        library=Path(kbitmm.BUILD_INFO["path"]).name,
        sparse_max_bits=kbitmm.sparse_max_bits(), instances=instances,
        ptxas=[ln for ln in kbitmm.BUILD_INFO["log"].splitlines() if ln],
    )
    check(len(instances) == 6, f"ptxas reported {len(instances)} kernel "
          "instances, want 6 (2 kernels x 3 row layouts)")
    for inst in instances:
        check(inst.get("spill_stores") == 0 and inst.get("spill_loads") == 0,
              f"ptxas reports spills in {inst}")


INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)


def held_on_paths(kernel: str, name: str, lhs, rhs, acc, want) -> None:
    """The kernel through ``ops`` (the compiled-in path threshold) and with
    each path forced (threshold 0: dense, INT32_MAX: sparse), word-equal to
    its plain version's ``want``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitmm import bitmm_path_cuda

    got = ops.bitmm(lhs, rhs) if acc is None else ops.bitmm_or(lhs, rhs, acc)
    check(torch.equal(got, want), f"{kernel} != its plain version on {name}")
    for t, path in ((0, "dense"), (INT32_MAX, "sparse")):
        got = bitmm_path_cuda(lhs, rhs, acc, sparse_max_bits=t)
        check(torch.equal(got, want),
              f"{kernel} ({path} path) != its plain version on {name}")


def exact_bits(gen, rows: int, k: int, n_bits: int, dev) -> torch.Tensor:
    """A (rows, k) Boolean tile with exactly ``n_bits`` set bits."""
    flat = torch.zeros(rows * k, dtype=torch.bool, device=dev)
    flat[torch.randperm(rows * k, generator=gen, device=dev)[:n_bits]] = True
    return flat.view(rows, k)


def path_cases(gen, dev, threshold: int):
    """(name, lhs, rhs, acc) of the cases that aim at the kernel's two
    paths and their edges; lhs has bit 31 set in some words, rhs in every
    third row, acc in every other row."""
    from repro_torch.core.matrices import pack_bits

    def operands(lhs_bits, w, d_rhs=0.2):
        B, m, k = lhs_bits.shape
        lhs = pack_bits(lhs_bits)
        rhs = random_words(gen, (B, k, w), d_rhs, dev)
        rhs[:, ::3] |= INT32_MIN
        acc = random_words(gen, (B, m, w), 0.05, dev)
        acc[:, ::2] |= INT32_MIN
        return lhs, rhs, acc

    def sparse_bits(B, m, k, d=0.05):
        bits = torch.rand((B, m, k), generator=gen, device=dev) < d
        bits[..., 31::32] |= torch.rand(bits[..., 31::32].shape, generator=gen,
                                        device=dev) < 0.3
        return bits

    yield ("all-empty tiles",
           *operands(torch.zeros((2, 100, 256), dtype=torch.bool, device=dev), 40))
    one = torch.zeros((2, 100, 256), dtype=torch.bool, device=dev)
    one[1, 37, 31] = True  # bit 31 of word 0
    yield ("single set bit", *operands(one, 40))
    # tiles of threshold + 1, threshold, 0 and 1 set bits in one launch:
    # dense, sparse, empty and sparse
    k = 32 * -(-(threshold + 2) // (64 * 32))
    edges = torch.zeros((1, 256, k), dtype=torch.bool, device=dev)
    edges[0, :64] = exact_bits(gen, 64, k, threshold + 1, dev)
    edges[0, 64:128] = exact_bits(gen, 64, k, threshold, dev)
    edges[0, 192:] = exact_bits(gen, 64, k, 1, dev)
    yield (f"threshold edges, tiles of {threshold + 1}/{threshold}/0/1 bits",
           *operands(edges, 496))
    for w in (1, 3, 5, 40, 496, 600, 601):  # 600, 601: above the widest instance
        yield f"w={w}", *operands(sparse_bits(2, 100, 256), w)
    for m in (1, 130):
        yield f"ragged m={m}", *operands(sparse_bits(2, m, 256), 40)
    yield "tile_bitmm batch", *operands(sparse_bits(512, 128, 128, 0.1), 4, 0.1)
    # operands one word past 16-byte alignment: the 4-byte instances
    yield "misaligned w=40", *(misaligned(t) for t in operands(
        sparse_bits(2, 100, 256), 40))


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one word past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_kernel_checks(dev) -> int:
    """bitmm against the plain bitmm_ref, word for word, on the card:
    through ops.bitmm and with each path forced."""
    from repro_torch.kernels import bitmm as kbitmm
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
        held_on_paths("bitmm", name, lhs, rhs, None, ref.bitmm_ref(lhs, rhs))
        checked += 1
        del lhs, rhs
    # all-zero and all-ones lhs rows, ragged m and w, rhs words with bit 31
    lhs = random_words(gen, (2, 100, 8), 0.5, dev)
    lhs[:, :10] = 0
    lhs[:, 10:20] = -1
    rhs = random_words(gen, (2, 256, 40), 0.05, dev)
    rhs[:, ::3] |= INT32_MIN
    want = ref.bitmm_ref(lhs, rhs)
    held_on_paths("bitmm", "edge rows/bit 31", lhs, rhs, None, want)
    got = ops.bitmm(lhs, rhs)
    check(bool((got[:, :10] == 0).all()), "all-zero lhs rows must give 0")
    check(torch.equal(got[0, 10], _or_rows(rhs[0])),
          "an all-ones lhs row must give the OR of every rhs row")
    checked += 1
    for name, lhs, rhs, _ in path_cases(gen, dev, kbitmm.sparse_max_bits()):
        held_on_paths("bitmm", name, lhs, rhs, None, ref.bitmm_ref(lhs, rhs))
        checked += 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit("kernels_checked", kernel="bitmm", cases=checked, paths=[
        "compiled threshold", "dense forced", "sparse forced"],
        tolerance="exact word equality (torch.equal)")
    return checked


def phase_bitmm_or_checks(dev) -> int:
    """bitmm_or against the plain bitmm_or_ref, word for word, on the
    card, through ops.bitmm_or and with each path forced: square and repair
    shapes, acc all zeros and all ones, bit 31 in lhs, acc and rhs, ragged
    m and w, the path cases."""
    from repro_torch.kernels import bitmm as kbitmm
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

    def zeros_and_ones(name, lhs, rhs, acc):
        nonlocal checked
        held_on_paths("bitmm_or", f"{name}, acc all zero", lhs, rhs,
                      torch.zeros_like(acc), ref.bitmm_ref(lhs, rhs))
        held_on_paths("bitmm_or", f"{name}, acc all ones", lhs, rhs,
                      torch.full_like(acc, -1), torch.full_like(acc, -1))
        checked += 2

    for name, lshape, rshape, d in cases:
        lhs = random_words(gen, lshape, d, dev)
        rhs = random_words(gen, rshape, d, dev)
        acc = random_words(gen, (lshape[0], lshape[1], rshape[-1]), d, dev)
        want = ref.bitmm_or_ref(lhs, rhs, acc)
        held_on_paths("bitmm_or", name, lhs, rhs, acc, want)
        check(torch.equal(want & acc, acc), f"bitmm_or lost acc bits on {name}")
        checked += 1
        if name.startswith("repair R=1024 d=0.5"):
            zeros_and_ones(name, lhs, rhs, acc)
        del lhs, rhs, acc, want
    # bit 31 in acc and rhs, ragged m and w, zero lhs rows keep acc as is
    lhs = random_words(gen, (2, 100, 8), 0.5, dev)
    lhs[:, :10] = 0
    rhs = random_words(gen, (2, 256, 40), 0.05, dev)
    rhs[:, ::3] |= INT32_MIN
    acc = random_words(gen, (2, 100, 40), 0.05, dev)
    acc[:, ::2] |= INT32_MIN
    want = ref.bitmm_or_ref(lhs, rhs, acc)
    held_on_paths("bitmm_or", "bit 31/ragged", lhs, rhs, acc, want)
    check(torch.equal(ops.bitmm_or(lhs, rhs, acc)[:, :10], acc[:, :10]),
          "zero lhs rows must give their acc words unchanged")
    checked += 1
    for name, lhs, rhs, acc in path_cases(gen, dev, kbitmm.sparse_max_bits()):
        held_on_paths("bitmm_or", name, lhs, rhs, acc,
                      ref.bitmm_or_ref(lhs, rhs, acc))
        zeros_and_ones(name, lhs, rhs, acc)
        checked += 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit("kernels_checked", kernel="bitmm_or", cases=checked, paths=[
        "compiled threshold", "dense forced", "sparse forced"],
        tolerance="exact word equality (torch.equal)")
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


def tile_bits(lhs: torch.Tensor) -> torch.Tensor:
    """Set lhs bits per 64-row tile, (B, ceil(m/64)): what the kernel
    counts to choose a tile's path."""
    x = lhs.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    rows = x.sum(-1)
    B, m = rows.shape
    pad = -m % 64
    rows = torch.nn.functional.pad(rows, (0, pad))
    return rows.view(B, (m + pad) // 64, 64).sum(-1)


def tile_paths(lhs: torch.Tensor, threshold: int) -> dict:
    """How many of lhs's 64-row tiles take each path at ``threshold``."""
    bits = tile_bits(lhs)
    empty = int((bits == 0).sum())
    dense = int((bits > threshold).sum())
    return {"empty": empty, "sparse": bits.numel() - empty - dense,
            "dense": dense}


L2_FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2


def kernel_times(lhs, rhs, acc, flush, threshold: int, base, want,
                 reps: int = 10) -> dict:
    """The kernel as the main path launches it: one call between two CUDA
    events, the wrapper's host work included (``ms``, as every earlier
    revision of this script timed it); its device time (``ms_device``) and
    its time with L2 cold; the device time with each path forced; and, with
    ``base`` (another revision's library), that revision's device time on
    the same operands, its output held to ``want``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitmm import bitmm_path_cuda

    if acc is None:
        def run():
            return ops.bitmm(lhs, rhs)
    else:
        def run():
            return ops.bitmm_or(lhs, rhs, acc)

    times = {
        "ms": time_ms(run, reps=reps, warmup=2),
        "ms_device": device_ms(run, reps=reps),
        "ms_cold_l2": time_ms(run, reps=reps, flush=flush),
        "ms_sparse": device_ms(lambda: bitmm_path_cuda(
            lhs, rhs, acc, sparse_max_bits=INT32_MAX), reps=reps),
        "ms_dense": device_ms(lambda: bitmm_path_cuda(
            lhs, rhs, acc, sparse_max_bits=0), reps=reps),
        "tiles": tile_paths(lhs, threshold),
    }
    if base is not None:
        times["ms_device_baseline"] = baseline_device_ms(
            base, lhs, rhs, acc, want, reps)
    return times


def baseline_device_ms(base, lhs, rhs, acc, want, reps: int) -> float:
    """Device time of another revision's kernel (``base``, a library with
    the same two public entry points) on these operands, after checking
    that it computes ``want``."""
    B, m, wk = lhs.shape
    w = rhs.shape[-1]
    out = torch.empty((B, m, w), dtype=torch.int32, device=lhs.device)
    stream = torch.cuda.current_stream().cuda_stream
    if acc is None:
        def run():
            return base.repro_bitmm(lhs.data_ptr(), rhs.data_ptr(),
                                    out.data_ptr(), B, m, wk, w, stream)
    else:
        def run():
            return base.repro_bitmm_or(lhs.data_ptr(), rhs.data_ptr(),
                                       acc.data_ptr(), out.data_ptr(),
                                       B, m, wk, w, stream)
    check(run() == 0, "the baseline kernel did not launch")
    check(torch.equal(out, want), "the baseline kernel != its plain version")
    return device_ms(run, reps=reps)


SWEEP_DENSITIES = (1e-4, 1e-3, 1e-2, 0.05, 0.1, 0.2, 0.3, 0.5)


def phase_kernel_timing(T, tables, launches, repair, base=None) -> None:
    """Time bitmm, its plain version and the library yardstick at the main
    path's shapes: on the main path's own final state (all-pairs R = n and
    a masked R = 128 block), and on random words (every bit set with
    probability 1/2, so no k-step can be skipped).  Then bitmm_or at the
    bitpacked repair's shape (its row capacity ``repair["R"]``) on the
    state's active block: lhs ``Tp[b_idx][:, :R]``, acc ``Tp[a_idx][:, :R]``
    — the first R rows, the pizza copies the delta phase edits.  Each row
    has its warm time, its time with L2 flushed before every launch, and
    each path's time forced (and with ``base``, another revision's
    library, that revision's device time).  Last, the density sweep: random lhs words at
    each density in SWEEP_DENSITIES at bitmm_or's shape against the state,
    timed on both paths and the library call — where the paths cross is
    the compiled-in threshold's reason."""
    from repro_torch.core.matrices import pack_bits, unpack_bits
    from repro_torch.kernels import bitmm as kbitmm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitmm import bitmm_path_cuda

    threshold = kbitmm.sparse_max_bits()
    Tp = pack_bits(T)
    del T
    b_idx, c_idx = tables.index_tensors(Tp.device)
    rhs_state = Tp[c_idx].contiguous()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=Tp.device)
    gen = torch.Generator(device=Tp.device)
    gen.manual_seed(1)
    # the library yardstick's unpacked rhs of the state, shared by the rows
    state_bmat = unpack_bits(rhs_state, 32 * rhs_state.shape[-1]).to(torch.bfloat16)

    def library_ms(lhs, bmat):
        a = unpack_bits(lhs, bmat.shape[1]).to(torch.bfloat16)
        ms = time_ms(lambda: torch.matmul(a, bmat), reps=5)
        del a
        return ms

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
        held_on_paths("bitmm", f"{data}, R={R}", lhs, rhs, None, want)
        times = kernel_times(lhs, rhs, None, flush, threshold, base, want)
        del got, want
        plain_ms = time_ms(lambda: ref.bitmm_ref(lhs, rhs), reps=3)
        if rhs is rhs_state:
            lib_ms = library_ms(lhs, state_bmat)
        else:
            bmat = unpack_bits(rhs, 32 * rhs.shape[-1]).to(torch.bfloat16)
            lib_ms = library_ms(lhs, bmat)
            del bmat
        torch.cuda.empty_cache()
        bound_ms, bound_by, needed_rows = bound(
            lhs, rhs, lhs.shape[0] * R * rhs.shape[-1]
        )
        rows.append({
            "data": data, "R": R, "lhs": list(lhs.shape), "rhs": list(rhs.shape),
            **times, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "rhs_rows_needed": needed_rows, "max_abs_err": err,
        })
        del lhs
    emit("kernel_timing", kernel="bitmm", rows=rows, launches=launches,
         sparse_max_bits=threshold)

    R = repair["R"]
    a_idx = torch.tensor(tables.a_idx, dtype=torch.int64, device=Tp.device)
    lhs = Tp[b_idx][:, :R].contiguous()
    acc = Tp[a_idx][:, :R].contiguous()
    got = ops.bitmm_or(lhs, rhs_state, acc)
    want = ref.bitmm_or_ref(lhs, rhs_state, acc)
    or_err = int((got.long() - want.long()).abs().max())
    check(or_err == 0, f"bitmm_or != bitmm_or_ref on the state, R={R}")
    held_on_paths("bitmm_or", f"the state, R={R}", lhs, rhs_state, acc, want)
    or_times = kernel_times(lhs, rhs_state, acc, flush, threshold, base, want)
    del got, want
    or_plain_ms = time_ms(lambda: ref.bitmm_or_ref(lhs, rhs_state, acc), reps=3)
    or_library_ms = library_ms(lhs, state_bmat)
    torch.cuda.empty_cache()
    or_bound_ms, or_bound_by, or_needed = bound(
        lhs, rhs_state, acc.numel(), acc_numel=acc.numel()
    )
    or_row = {
        "data": "main-path state, active block", "R": R,
        "lhs": list(lhs.shape), "rhs": list(rhs_state.shape),
        "acc": list(acc.shape), **or_times, "plain_ms": or_plain_ms,
        "library_ms": or_library_ms, "bound_ms": or_bound_ms,
        "bound_by": or_bound_by, "rhs_rows_needed": or_needed,
        "max_abs_err": or_err,
    }
    emit("kernel_timing", kernel="bitmm_or", rows=[or_row],
         launches_per_repair=repair["launches"], sparse_max_bits=threshold)

    sweep = []
    for d in SWEEP_DENSITIES:
        lhs = random_words(gen, (len(b_idx), R, Tp.shape[-1]), d, Tp.device)
        want = ref.bitmm_ref(lhs, rhs_state)
        for t in (0, INT32_MAX, threshold):
            got = bitmm_path_cuda(lhs, rhs_state, sparse_max_bits=t)
            check(torch.equal(got, want),
                  f"bitmm at threshold {t} != bitmm_ref at density {d}")
        del got, want
        bound_ms, bound_by, needed_rows = bound(
            lhs, rhs_state, lhs.shape[0] * R * rhs_state.shape[-1])
        sweep.append({
            "density": d, "lhs": list(lhs.shape),
            "tile_bits_mean": float(tile_bits(lhs).float().mean()),
            "ms_sparse": device_ms(lambda: bitmm_path_cuda(
                lhs, rhs_state, sparse_max_bits=INT32_MAX), reps=5),
            "ms_dense": device_ms(lambda: bitmm_path_cuda(
                lhs, rhs_state, sparse_max_bits=0), reps=5),
            "library_ms": library_ms(lhs, state_bmat),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tiles": tile_paths(lhs, threshold),
        })
        del lhs
        torch.cuda.empty_cache()
    emit("density_sweep", kernel="bitmm", rhs="main-path state",
         sparse_max_bits=threshold, rows=sweep)
    del state_bmat, flush

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
        "ms_device": main["ms_device"],
        "ms_cold_l2": main["ms_cold_l2"],
    }, {
        "name": "bitmm_or",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitmm.cu",
        "replaces": "src/repro/kernels/bitmm.py:73",
        "launches": repair["launches"],
        "max_abs_err": or_err,
        "ms": or_row["ms"],
        "plain_ms": or_plain_ms,
        "bound_ms": or_bound_ms,
        "bound_by": or_bound_by,
        "library_ms": or_library_ms,
        "ms_device": or_row["ms_device"],
        "ms_cold_l2": or_row["ms_cold_l2"],
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
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline-cu", type=Path, default=None,
        help="another revision's csrc/bitmm.cu: its kernels are also timed "
             "(device time) on the kernel_timing rows' operands")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails here outside a checkout)

    info = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    base = None
    if args.baseline_cu is not None:
        from repro_torch.kernels import bitmm as kbitmm

        base, _ = kbitmm.load(args.baseline_cu.resolve())
    phase_kernel_checks(dev)
    phase_bitmm_or_checks(dev)
    T, tables, launches = phase_main_path(dev)
    repair = phase_delta(dev)
    phase_kernel_timing(T, tables, launches, repair, base)
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()

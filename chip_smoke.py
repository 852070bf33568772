"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline-cu OTHER_REVISION/src/repro_torch/kernels/csrc/bitmm.cu]
    python3 chip_smoke.py --packing

Builds the port's hand-written CUDA kernels (``bitmm`` and ``bitmm_or``
from csrc/bitmm.cu, the block-sparse backend's ``tile_contract`` from
csrc/tile_bitmm.cu, the single-path closures' ``minplus`` from
csrc/minplus.cu, the count closures' ``count_mm`` from csrc/count_mm.cu;
one nvcc per source, started together) from this
checkout and fails if ptxas reports a spill in any template instance;
holds each kernel against its plain torch version on the card (``bitmm``
and ``bitmm_or`` through their compiled-in path threshold and with each of
their two paths, sparse row gather and staged dense tiles, forced;
``tile_contract`` on buckets of 1, 7 and 512 tile pairs at B = 32, 64 and
128, as the fixpoint's chunks, runs of pairs sharing an lhs slot
included; ``minplus``
bit-equal on random cases: finite shares 1e-4 to 1, ragged shapes, rows
without a finite entry, the index and the acc forms, K = 15,872, and the
cases of SPARSE_ROW_CASES that reach each branch of its sparse-row design:
lists that overflow, K = 0, misaligned operands, acc at inf); drives the port's main
path (relational CFPQ served by ``repro_torch.engine.QueryEngine``) at
full size — ``paper_table_graph("pizza").repeat(16)``, 15,856 nodes padded
to n = 15,872, with Query 1 in CNF — and checks every answer against the
port's Hellings worklist oracle.  Then the delta path: on warm all-pairs
states of the bitpacked, dense and auto engines, seeded edge edits through
``QueryEngine.apply_delta`` are repaired row by row (the bitpacked repair
through ``bitmm_or``) and checked against Hellings, against a fresh
engine's closure, and for bit-identical untouched rows.  Then single-path
CFPQ (paper Section 5) on the dense, frontier and auto engines: batches of
16 single-source queries in pizza copy 0 with one witness path per pair,
checked against Hellings and by a CYK check of each witness (its length
equal to its entry of the length state), the host mirror of the 7 GB
length state against the device, a seeded edit of copy 0 repaired in
place, each phase launching the min-plus kernel; the dense phase also
times one min-plus product on the state against its two bounds (every
candidate, and what the finite entries need) and the plain version.
The block-sparse backend: the engine pinned to ``blocksparse`` (and
``auto``) through all-pairs, the 256-source batch and a seeded edit at the
main path's size, checked against Hellings and a bitpacked engine's
state; then ``blocksparse_closure_state`` at a million nodes (pizza x
1024, n = 1,014,784; the dense tensor never exists), its S tiles checked
against Hellings on one copy, shifted, with the tile launches' device
time beside the wall time and the device operations per chunk (from
``torch.profiler``); the tile kernel on that run's slot store and timed at
its bucket shape.
Then ``serve_open_loop``: 512 requests at 200 offered queries/s through
``repro_torch.serve.CFPQServer`` with a fenced write halfway, every
answer checked against Hellings at the epoch it reports.  Then the
conjunctive semantics (a same-generation grammar of 14 conjuncts at the
main path's size on dense, bitpacked and auto, Query 1 as a conjunctive
grammar, an insert-only edit repaired and a delete dropped, the
a^n b^n c^n golden chain; against Hellings of its two CFG halves) and
the count semantics (Query 1's path counts at the main path's size
through the engine, (7, 15,872, 15,872) uint32 planes, against a scipy
Jacobi on one copy; a recount after an insert, a drop after a delete,
the saturation goldens, bounded all-path enumeration checked by CYK),
with ``count_mm`` held bit-equal to its plain version on 66 cases (45
random, 21 of SPARSE_ROW_CASES: acc at SAT among them) and on both real
states and timed at the all-pairs and the 16-source
shapes beside its bound, its plain version and a float64 matmul.  Then the
kernels are timed at the main path's shapes (one call, device time, with
L2 cold, and per path) and over a density sweep that shows where the two
paths cross.  Last, the sharded ``opt`` family in a one-rank NCCL world
(NCCL takes one rank per card): ``opt_closure`` with ``plan=None`` and on
the 1 x 1 mesh, word-equal to ``bitpacked_closure`` and to Hellings, and
``QueryEngine(engine="opt", mesh=...)`` through all pairs, the
256-source batch, 16 single-path queries, seeded edits and a query that
shards the repaired state again, with the words each exchange moved per
iteration.  Then the planner's calibration on the card
(tools/calibrate_planner_torch.py's ``calibrate()`` up to n = 4,096 at 1,
4, 16 sources and all pairs, single-path all pairs at n = 1,024 only, and
at the main path's n at 1 and 16 sources; the round trip of the saved
profile), the fitted coefficients beside the defaults and the grid
decisions they change, and the main path's 256-source ``auto`` batch and
``auto`` edit under both profiles in turns, each equal to a pinned
bitpacked engine's.  Last, the LM serving path (``lm_serve``):
``smollm-360m`` at full width, 409,007,040 parameters from a seeded
generator, its f32 decode held to the teacher-forced forward, then served
in bf16 through ``repro_torch.launch.serve.serve`` (batch 4, prompt 32,
gen 16) with its latencies, peak memory, the device operations of one
decode step (``torch.profiler``), the step's bound and its code's own
traffic, bf16 decode against forward to 2e-2; the reduced
configs of the five LM archs, bf16 decode against forward, and the card
against the CPU port in f32.  Then LM training (``lm_train``):
``smollm-360m`` at full width on ``train_4k`` (its sequence cut from 4,096
to 2,048, its global batch to 8, two microbatches of 4) through
``train/trainer.py``: 6 steps with f32 moments on one fixed batch (loss,
gradient norm, ms, tokens/s, mfu, peak memory and the moments' bytes per
step; the loss must fall), a checkpoint after step 3 restored bit for bit
into a fresh model and optimizer whose resumed losses and gradient norms
equal the uninterrupted run's bit for bit, the f32
products' share of one step's device time (``torch.profiler``), 2 steps
with int8 moments, and the five reduced configs' train step on the card
against the CPU port; and DeepFM training (``deepfm_train``): the full
config (430 M parameters) at a batch of 65,536 for 15 steps, its loss
falling 5%, examples/s, and the reduced config on the card against the CPU
port.  Then GNN training (``gnn_train``): each of the four GNN archs at
its published width on a registry shape it fits on one card (gcn-cora on
Cora and on ogb_products' full batch of 61.9 M edges, MeshGraphNet at a
``minibatch_lg`` sample's size, Equiformer-v2 and MACE on 128 molecules),
8 AdamW steps on ``gnn_batch`` at that size (loss, gradient norm, ms,
edges/s, peak memory; the loss must fall), one profiled step (device busy,
kernels, the gathers' and scatter-adds' share), the model FLOPs, an
Equiformer-v2 checkpoint restored bit for bit, the E(3) invariance on the
card, and the reduced configs on the card against the CPU port.  Last, the
sharded LM (``lm_sharded``): ``smollm-360m`` at full width and depth in the
one-rank NCCL world, its sharded train step held to the unsharded one
(loss rtol 1e-5, parameters 5e-4 / 1e-5) and its checkpoint restored bit
for bit; then a 2 x 2 gloo world of four spawned processes on the card
with CUDA tensors: ``smollm-360m`` at full width ("seq" attention, the
vocabulary over ``model``, FSDP over ``data``; 2 blocks) and the reduced
MoE arch held to their unsharded steps, the int8 compressed all-reduce of
real gradients within its one-shot bound, the checkpoint restored on a
1 x 4 mesh bit for bit; the same four ranks then run these checks on
2 x 1 x 2 and 2 x 2 x 1 ``(pod, data, model)`` meshes (the compressed
all-reduce over ``pod``, the 2 x 1 x 2 checkpoint restored on 2 x 2), and
the NCCL world one step on a 1 x 1 x 1 pod mesh; per rank step ms, the
bytes and calls of each collective per step and peak memory.  Then the
dry run and the roofline (``roofline``): seven components (smollm-360m's block forward, forward
and backward, head and optimizer at one rank's microbatch, its decode step,
a DeepFM step, one ``cfpq`` ``opt_step`` at n = 65,536 through
``repro_bitmm``) timed on the card beside the bound of their count on
``meta`` (``repro_torch.roofline.count``; a count above what the card did
fails), and every single-pod cell of the registry and the multi-pod LM
train and prefill cells (per rank, on the 2 x 16 x 16 mesh) counted and
tabled.
Every phase prints its ``phase_seconds``.
``--baseline-cu`` names another revision's ``bitmm.cu`` (say, the
parent commit's, unpacked with ``git archive``): it is built too, and its
device time is timed beside this one's on the same operands; so are the
``minplus.cu`` and ``count_mm.cu`` beside it, on the ``minplus_timing`` and
``count_mm_timing`` operands (before and after this revision's kernel).
``--packing`` runs only the timing of ``pack_bits`` and ``unpack_bits`` on
the main path's all-pairs state against their 32-step forms and prints no
result line.  Each phase prints one JSON line; the last line is ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero; so does a machine
without a CUDA device.
It imports nothing of JAX and nothing of the JAX reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
if not (SRC / "repro_torch").is_dir():
    sys.exit(f"chip_smoke: no port beside this script ({SRC / 'repro_torch'} "
             "is missing): run it from a checkout of the repository")
sys.path.insert(0, str(SRC))

# Published H100 SXM rates (NVIDIA data sheet) for the bounds, in one place:
# HBM3 bytes per second, INT32 operations on the SMs' integer lanes, float32
# outside and bf16 on the tensor cores.
from repro_torch.roofline.analysis import (  # noqa: E402
    BF16_OPS_PER_S,
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    INT32_OPS_PER_S,
)

BASE_GRAPH = "pizza"  # the full-width graph is BASE_GRAPH x PIZZA_COPIES
PIZZA_COPIES = 16
PIZZA_S_PAIRS = 313  # Query 1's S-pairs on one pizza copy (Hellings)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed(phase: str, fn, *args):
    """``fn(*args)``, then the phase's result line: its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit(phase, phase_seconds=time.perf_counter() - t0)
    return out


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


def kernel_instances(log: str, pattern: str, label) -> list[dict]:
    """Registers and spills of each template instance whose mangled name
    matches ``pattern``, from ``nvcc -Xptxas -v``; ``label`` names an
    instance from the pattern's groups."""
    found, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*" + pattern, ln)
        if m:
            name = label(*m.groups())
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


def _flag(bit: str) -> str:
    return "true" if bit == "1" else "false"


def ptxas_instances(log: str) -> list[dict]:
    """``bitmm_kernel<kAcc, NV, V>`` (kAcc true is bitmm_or; NV units of V
    words per lane in the sparse path)."""
    return kernel_instances(
        log, r"bitmm_kernelILb(\d)ELi(\d+)ELi(\d+)E",
        lambda acc, nv, v: f"bitmm_kernel<{_flag(acc)}, {nv}, {v}>")


def tile_instances(log: str) -> list[dict]:
    """``tile_contract_kernel<B>`` of the block-sparse tile kernel."""
    return kernel_instances(log, r"tile_contract_kernelILi(\d+)E",
                            lambda b: f"tile_contract_kernel<{b}>")


def minplus_instances(log: str) -> list[dict]:
    """``minplus_kernel<kVec, kAcc>`` of the min-plus kernel."""
    return kernel_instances(
        log, r"minplus_kernelILb(\d)ELb(\d)E",
        lambda vec, acc: f"minplus_kernel<{_flag(vec)}, {_flag(acc)}>")


def count_instances(log: str) -> list[dict]:
    """``count_mm_kernel<kVec, kAcc>`` of the saturating count kernel."""
    return kernel_instances(
        log, r"count_mm_kernelILb(\d)ELb(\d)E",
        lambda vec, acc: f"count_mm_kernel<{_flag(vec)}, {_flag(acc)}>")


def phase_build() -> None:
    """The four kernel sources, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import bitmm as kbitmm
    from repro_torch.kernels import count_mm as kcount
    from repro_torch.kernels import minplus as kminplus
    from repro_torch.kernels import tile_bitmm as ktile

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        (_, info), (_, tinfo), (_, minfo), (_, cinfo) = pool.map(
            kbitmm.load, (kbitmm.SOURCE, ktile.SOURCE, kminplus.SOURCE, kcount.SOURCE),
            (kbitmm.ENTRIES, ktile.ENTRIES, kminplus.ENTRIES, kcount.ENTRIES))
    wall_s = time.perf_counter() - t0
    instances = ptxas_instances(info["log"])
    tinstances = tile_instances(tinfo["log"])
    minstances = minplus_instances(minfo["log"])
    cinstances = count_instances(cinfo["log"])
    logs = (info["log"], tinfo["log"], minfo["log"], cinfo["log"])
    emit(
        "build", kernels=["bitmm", "bitmm_or", "tile_contract", "minplus", "count_mm"],
        wall_s=wall_s,
        seconds={"bitmm": info["seconds"], "tile_bitmm": tinfo["seconds"],
                 "minplus": minfo["seconds"], "count_mm": cinfo["seconds"]},
        library=[Path(i["path"]).name for i in (info, tinfo, minfo, cinfo)],
        sparse_max_bits=kbitmm.sparse_max_bits(), instances=instances,
        tile_instances=tinstances, minplus_instances=minstances,
        count_instances=cinstances,
        ptxas=[ln for ln in "\n".join(logs).splitlines() if ln],
    )
    check(len(instances) == 6, f"ptxas reported {len(instances)} kernel "
          "instances, want 6 (2 kernels x 3 row layouts)")
    check(len(tinstances) == 3, f"ptxas reported {len(tinstances)} tile kernel "
          "instances, want 3 (B = 32, 64, 128)")
    check(len(minstances) == 4, f"ptxas reported {len(minstances)} min-plus "
          "kernel instances, want 4 (16-byte or single columns, with or "
          "without acc)")
    check(len(cinstances) == 4, f"ptxas reported {len(cinstances)} count "
          "kernel instances, want 4 (16-byte or single columns, with or "
          "without acc)")
    for inst in instances + tinstances + minstances + cinstances:
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

    base = paper_table_graph(BASE_GRAPH)
    rel = hellings_cfpq(base, query1_grammar().to_cnf())["S"]
    off = base.n_nodes
    return {(i + t * off, j + t * off) for t in range(PIZZA_COPIES) for i, j in rel}


def reset_launches() -> None:
    from repro_torch.kernels import ops

    ops.launches = ops.or_launches = ops.tile_launches = 0
    ops.minplus_launches = ops.count_mm_launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import ops

    return {"bitmm": ops.launches, "bitmm_or": ops.or_launches,
            "tile_contract": ops.tile_launches, "minplus": ops.minplus_launches,
            "count_mm": ops.count_mm_launches}


def run_phase(fn):
    """Run ``fn`` with the kernel counts at 0 and the peak memory reset;
    returns (result, wall ms, ``{"bitmm": .., "bitmm_or": ..,
    "tile_contract": .., "minplus": .., "count_mm": ..}`` launches in the
    run)."""
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, read_launches()


#: the kernel each backend's closure launches (dense and frontier: none)
ROUTE_KERNEL = {"bitpacked": "bitmm", "blocksparse": "tile_contract"}


def check_route_launched(route: str, launches: dict, what: str) -> None:
    """A closure routed to ``route`` (a backend or a planner label) must
    have launched that backend's hand-written kernel in the run."""
    kernel = ROUTE_KERNEL.get(route.split(":")[0])
    if kernel is not None:
        check(launches[kernel] > 0, f"{what}: routed to {route} but {kernel} "
              f"never launched ({launches})")


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
        route = outs[0].stats.planner["label"]
        served = (outs[0].stats.fallback or {}).get("to", route)
        check_route_launched(served, counts, f"batch_{backend}")
        if backend == "bitpacked":
            check(n_launch > 0, "bitpacked batch never launched bitmm")
        report(f"batch_{backend}", eng, ms, n_launch, queries=len(batch),
               route=route, served_by=outs[0].stats["engine"],
               tile_launches=counts["tile_contract"],
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


def phase_kernel_timing(T, tables, launches, repair, base=None) -> list[dict]:
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
    the compiled-in threshold's reason.  Returns the two kernels' rows of
    the ``kernels`` summary."""
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
    return [{
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
    }]


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


def _seeded_edits(rng, graph, g, off: int, copies=(0, 1)):
    """Two deletes and three inserts in each of the pizza ``copies``; insert
    labels are the grammar's terminals, endpoints in the same copy."""
    labels = sorted(g.term_prods)
    delete, insert = [], []
    for copy in copies:
        lo = copy * off
        own = [e for e in graph.edges if lo <= e[0] < lo + off]
        for k in rng.choice(len(own), size=2, replace=False):
            delete.append(own[int(k)])
        for _ in range(3):
            i, j = (int(v) + lo for v in rng.integers(0, off, size=2))
            insert.append((i, labels[int(rng.integers(0, len(labels)))], j))
    return delete, insert


def span_ms(tracer, first: int, name: str, **attrs) -> float:
    """Total ms of the spans called ``name`` (with ``attrs``) recorded
    since span number ``first``."""
    return 1e3 * sum(
        s.duration_s for s in tracer.spans[first:] if s.name == name
        and all(s.attrs.get(k) == v for k, v in attrs.items())
    )


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
        for r in repairs:  # a packed repair launches bitmm_or, a tiled one tiles
            kernel = {"bitpacked": "bitmm_or",
                      "blocksparse": "tile_contract"}.get(r.attrs["engine"])
            if kernel is not None:
                check(n_launch[kernel] > 0, f"delta_{backend}: the "
                      f"{r.attrs['engine']} repair never launched {kernel}")
        res, fresh_ms, full_copy_ms = verify("after the delta")
        emit(
            f"delta_{backend}", edits={"delete": len(delete), "insert": len(insert)},
            warm_allpairs_ms=warm_ms, apply_delta_ms=delta_ms,
            delta_repair_span_ms=span_ms(eng.tracer, first, "delta.repair"),
            repair_closure_execute_ms=span_ms(
                eng.tracer, first, "closure.execute", repair=True),
            host_copy_ms=span_ms(eng.tracer, first, "delta.host_copy"),
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


# ---------------------------------------------------------------------- #
# the block-sparse backend: its tile kernel, the engine pinned to it at
# full width, and the standalone closure at a million nodes
# ---------------------------------------------------------------------- #

TILE_DENSITIES = (1e-3, 0.05, 0.5, 1.0)
TILE_PAIRS = ((1, 1), (7, 3), (512, 64))  # (pairs, output blocks) per bucket
SCALE_COPIES = 1024  # pizza copies of the standalone closure: n = 1,014,784


def tile_bucket(gen, store, p: int, n_out: int):
    """One bucket of ``p`` pairs over the slots of ``store``: segments over
    ``n_out`` output blocks (repeated), the last quarter pad pairs (segment
    ``n_out``), and for about half of the outputs an old tile (slot
    ``out_slot[s]`` where ``exists[s]``, int32 0/1).  Returns ``(l_idx,
    r_idx, seg, out_slot, exists)``."""
    dev = store.device
    S = store.shape[0]

    def ints(high, size):
        return torch.randint(0, high, (size,), generator=gen, device=dev,
                             dtype=torch.int32)

    l_idx, r_idx, seg = ints(S, p), ints(S, p), ints(n_out, p)
    seg[p - p // 4:] = n_out
    exists = (torch.rand(n_out, generator=gen, device=dev) < 0.5).to(torch.int32)
    return l_idx, r_idx, seg, ints(S, n_out), exists


def held_tile(store, l_idx, r_idx, seg, out_slot, exists, what: str) -> int:
    """The tile kernel word-equal to its plain version: the new tiles and
    the changed / nonzero flags of ``ops.tile_contract_chunk``, three
    chunks in a row through one work object, so the second reuses the
    buffer that the first zeroed and the third the one the second zeroed;
    no fault.  Returns the largest absolute difference of the words (0)."""
    from repro_torch.kernels import ops, ref

    n_out = out_slot.shape[0]
    want, want_flags = ref.tile_contract_chunk_ref(
        store, l_idx, r_idx, seg, out_slot, exists, n_out)
    work = ops.tile_work(store.shape[1], 512, store.device)
    err = 0
    for turn in range(3):
        new, flags = ops.tile_contract_chunk(
            store, l_idx, r_idx, seg, out_slot, exists, n_out, work)
        cap = (flags.shape[0] - 1) // 2
        err = max(err, int((new.long() - want.long()).abs().max()))
        check(torch.equal(new, want), f"tile_contract (chunk {turn}) != its "
              f"plain version on {what}")
        check(torch.equal(flags[:n_out], want_flags[:n_out])
              and torch.equal(flags[cap:cap + n_out], want_flags[n_out:-1])
              and int(flags[-1]) == 0,
              f"tile_contract (chunk {turn}) flags != the plain version's on {what}")
    return err


def phase_tile_checks(dev, state=None) -> int:
    """The tile kernel against its plain version, word for word, as the
    fixpoint's chunks (:func:`held_tile`): B = 32, 64 and 128; 1, 7 and 512
    pairs with repeated output blocks, pad pairs and outputs with and
    without an old tile, and 512 pairs in runs of 40 that share an lhs slot
    (longer than a half of the kernel's rhs ring at B = 128); random stores
    at densities 1e-3 to every bit set, or (``state``) the real slot store
    of the scale phase; and ``tile_bitmm`` against ``bitmm_ref``."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = []
    if state is None:
        for B in (32, 64, 128):
            for d in TILE_DENSITIES:
                store = random_words(gen, (600, B, B // 32), d, dev)
                for p, n_out in TILE_PAIRS:
                    cases.append((f"B={B} d={d} pairs={p}", store, p, n_out))
    else:
        store = state.tiles[: state.n_slots]
        for p, n_out in TILE_PAIRS:
            cases.append((f"the scale phase's store, pairs={p}", store, p, n_out))
    err = 0
    for name, store, p, n_out in cases:
        err = max(err, held_tile(store, *tile_bucket(gen, store, p, n_out), name))
    # runs of 40 pairs that share an lhs slot
    run_cases = 0
    for B in ((32, 64, 128) if state is None else (state.tile,)):
        store = (random_words(gen, (600, B, B // 32), 0.05, dev) if state is None
                 else state.tiles[: state.n_slots])
        l_idx, r_idx, seg, out_slot, exists = tile_bucket(gen, store, 512, 64)
        l_idx = l_idx[torch.arange(512, device=dev) // 40 * 40]
        err = max(err, held_tile(store, l_idx, r_idx, seg, out_slot, exists,
                                 f"runs of 40 pairs, B={B}"))
        run_cases += 1
    bitmm_cases = 0
    if state is None:
        for B in (32, 64, 128):
            lhs = random_words(gen, (512, B, B // 32), 0.1, dev)
            rhs = random_words(gen, (512, B, B // 32), 0.1, dev)
            check(torch.equal(ops.tile_bitmm(lhs, rhs), ref.bitmm_ref(lhs, rhs)),
                  f"tile_bitmm != bitmm_ref at B={B}")
            bitmm_cases += 1
    torch.cuda.synchronize()
    emit("tile_checks", kernel="tile_contract",
         store="random" if state is None else "blocksparse_scale",
         cases=len(cases) + run_cases, chunks_per_case=3,
         tile_bitmm_cases=bitmm_cases, max_abs_err=err,
         tolerance="exact word equality (torch.equal)")
    return err


class TileProbe:
    """For the duration of a ``with``: counts the block-sparse fixpoint's
    iterations, chunks and contracted pairs, times ``from_graph``, and
    brackets each tile-kernel launch with two CUDA events, by wrapping the
    module functions the fixpoint calls.  The events bracket the C launch
    call alone, not the wrapper's checks and allocations; each chunk syncs
    the host before the next, so the device is idle when the first event
    is recorded and each interval is the launch's enqueue latency plus the
    kernel.  ``device_ms``, their sum, is thus an upper bound of the
    launches' device time."""

    def __enter__(self):
        from repro_torch.core import blocksparse as tbs
        from repro_torch.kernels import tile_bitmm as ktile

        self.iterations = self.chunks = self.pairs = 0
        self.from_graph_s = 0.0
        self._events = []
        self._saved = (tbs._chunk_operands, ktile._launch,
                       tbs._blocksparse_fixpoint,
                       tbs.BlockSparseState.__dict__["from_graph"])
        operands, launch, fixpoint, from_graph = self._saved

        def chunk_operands(state, chunk, device):
            self.chunks += 1
            self.pairs += len(chunk)
            return operands(state, chunk, device)

        def timed_launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(*args)
            end.record()
            self._events.append((start, end))

        def counting_fixpoint(*args):
            *rest, hook = args  # every caller passes all nine positionally

            def count(*event):
                self.iterations += 1
                if hook is not None:
                    hook(*event)

            return fixpoint(*rest, count)

        def timed_from_graph(cls, *args, **kwargs):
            t0 = time.perf_counter()
            out = from_graph.__func__(cls, *args, **kwargs)
            torch.cuda.synchronize()
            self.from_graph_s += time.perf_counter() - t0
            return out

        tbs._chunk_operands = chunk_operands
        ktile._launch = timed_launch
        tbs._blocksparse_fixpoint = counting_fixpoint
        tbs.BlockSparseState.from_graph = classmethod(timed_from_graph)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import blocksparse as tbs
        from repro_torch.kernels import tile_bitmm as ktile

        (tbs._chunk_operands, ktile._launch, tbs._blocksparse_fixpoint,
         tbs.BlockSparseState.from_graph) = self._saved
        torch.cuda.synchronize()
        self.device_ms = sum(s.elapsed_time(e) for s, e in self._events)
        return False


def phase_blocksparse_engine(dev) -> int:
    """The engine pinned to ``blocksparse`` at the main path's size (pizza
    x 16, Query 1), and ``auto`` through the same three calls: all-pairs,
    the 256-source batch, and ``apply_delta`` of the delta phase's first
    seeded edits on the warm all-pairs state.  Checked: pairs against
    Hellings; the Boolean state under the mask bit-equal to a pinned
    bitpacked engine's all-pairs closure of the same graph (before and
    after the edit); the host copy equal to the device state; rows of the
    unedited copies bit-identical across the edit; every call of the
    pinned engine launched the tile kernel, every call of ``auto`` the
    kernel of its route.  Returns the pinned engine's tile launches."""
    from repro_torch.core.blocksparse import occupied_block_count
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import paper_table_graph
    from repro_torch.engine import EngineConfig, Query, QueryEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    g = query1_grammar().to_cnf()
    off = paper_table_graph("pizza").n_nodes
    oracle = shifted_oracle()

    def pizza():
        return paper_table_graph("pizza").repeat(PIZZA_COPIES)

    def engine_of(graph, name):
        return QueryEngine(
            graph, config=EngineConfig(engine=name, device=str(dev)),
            metrics=MetricsRegistry(), tracer=Tracer(iteration_events=False),
        )

    sources = np.random.default_rng(0).choice(
        pizza().n_nodes, size=256, replace=False).tolist()
    edited = pizza()
    delete, insert = _seeded_edits(np.random.default_rng(7), edited, g, off)
    edited.delete_edges(delete)
    edited.insert_edges(insert)
    after = set(oracle) - {p for p in oracle if p[0] < 2 * off}
    after |= _copy_oracle(edited, g, 0, off) | _copy_oracle(edited, g, 1, off)
    exact = {}
    for label, graph in (("before", pizza()), ("after", edited)):
        bp = engine_of(graph, "bitpacked")
        bp.query(Query(g, "S"))
        (st,) = bp._states.values()
        exact[label] = st.T_host
        del bp, st
    frozen_rows = np.arange(2 * off, PIZZA_COPIES * off)

    def state_checks(eng, label, what):
        (st,) = eng._states.values()
        M = st.mask
        check(np.array_equal(st.T_host[:, M, :], exact[label][:, M, :]),
              f"{what}: rows under the mask != the bitpacked engine's closure")
        check(torch.equal(st.T.cpu(), torch.from_numpy(st.T_host)),
              f"{what}: host copy != device state")
        return st

    def measure(eng, fn, what, check_result):
        first = len(eng.tracer.spans)
        with TileProbe() as probe:
            out, ms, launches = run_phase(fn)
        peak = torch.cuda.max_memory_allocated()
        spans = [s for s in eng.tracer.spans[first:] if s.name == "closure.execute"]
        routes = check_result(out)
        for route in routes:
            check_route_launched(route, launches, what)
        (st,) = eng._states.values()
        return {
            "wall_ms": ms, "closure_execute_ms": span_ms(eng.tracer, first,
                                                         "closure.execute"),
            "closure_calls": sum(s.attrs.get("calls", 0) for s in spans),
            "closure_engine": [s.attrs["engine"] for s in spans],
            "route": routes, "occupied_blocks": occupied_block_count(st.T, 128),
            "chunks": probe.chunks, "pairs_contracted": probe.pairs,
            "iterations": probe.iterations, "tile_device_ms": probe.device_ms,
            "launches": launches, "max_memory_allocated": peak,
        }

    pinned_launches = 0
    for name in ("blocksparse", "auto"):
        calls = {}
        eng = engine_of(pizza(), name)

        def allpairs(res):
            check(res.pairs == oracle, f"blocksparse_engine {name}: all-pairs "
                  "!= shifted Hellings")
            return [res.stats.planner["label"]]

        calls["allpairs"] = measure(eng, lambda: eng.query(Query(g, "S")),
                                    f"blocksparse_engine {name} all-pairs", allpairs)
        calls["allpairs"]["pairs"] = len(oracle)
        state_checks(eng, "before", f"blocksparse_engine {name} all-pairs")
        (st,) = eng._states.values()
        keep = st.T_host[:, frozen_rows, :].copy()

        batch_eng = engine_of(pizza(), name)

        def batch(outs):
            for s, out in zip(sources, outs):
                check(out.pairs == {p for p in oracle if p[0] == s},
                      f"blocksparse_engine {name} batch: source {s} != Hellings")
            return [outs[0].stats.planner["label"]]

        calls["batch"] = measure(
            batch_eng, lambda: batch_eng.query_batch(
                [Query(g, "S", sources=(int(s),)) for s in sources]),
            f"blocksparse_engine {name} batch", batch)
        state_checks(batch_eng, "before", f"blocksparse_engine {name} batch")
        del batch_eng

        def delta(st_delta):
            spans = [s for s in eng.tracer.spans if s.name == "closure.execute"
                     and s.attrs.get("repair")]
            check(st_delta.rows_repaired > 0 and st_delta.rows_evicted > 0,
                  f"blocksparse_engine {name}: the delta did nothing: {st_delta}")
            return [spans[-1].attrs["engine"]]

        calls["apply_delta"] = measure(
            eng, lambda: eng.apply_delta(insert=insert, delete=delete),
            f"blocksparse_engine {name} apply_delta", delta)
        st = state_checks(eng, "after", f"blocksparse_engine {name} apply_delta")
        check(np.array_equal(st.T_host[:, frozen_rows, :], keep),
              f"blocksparse_engine {name}: rows of unedited copies changed")
        res = eng.query(Query(g, "S"))
        check(res.pairs == after, f"blocksparse_engine {name}: pairs after "
              "the edit != Hellings")
        if name == "blocksparse":
            for label, c in calls.items():
                check(c["launches"]["tile_contract"] > 0,
                      f"blocksparse_engine: {label} never launched tile_contract")
            pinned_launches = sum(c["launches"]["tile_contract"]
                                  for c in calls.values())
        emit("blocksparse_engine", engine=name, n=eng.n, sources=len(sources),
             edits={"delete": len(delete), "insert": len(insert)}, calls=calls)
        del eng, st, keep, res
        torch.cuda.empty_cache()
    return pinned_launches


def phase_blocksparse_scale(dev):
    """The standalone closure over the compacted state at a million nodes:
    ``blocksparse_closure_state`` on pizza x SCALE_COPIES with Query 1,
    all-pairs, tile 128; the dense tensor never exists.  Checked: the S
    tiles of every copy equal tiles built from Hellings on one copy,
    shifted, block for block.  Returns the state."""
    from repro_torch.baselines.hellings import hellings_cfpq
    from repro_torch.core.blocksparse import blocksparse_closure_state
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import paper_table_graph

    g = query1_grammar().to_cnf()
    base = paper_table_graph("pizza")
    off = base.n_nodes
    t0 = time.perf_counter()
    graph = base.repeat(SCALE_COPIES)
    graph_s = time.perf_counter() - t0
    rel = np.array(sorted(hellings_cfpq(base, g)["S"]), dtype=np.int64)
    check(len(rel) == PIZZA_S_PAIRS, f"Hellings gives {len(rel)} S-pairs")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    with TileProbe() as probe:
        t0 = time.perf_counter()
        state = blocksparse_closure_state(graph, g, tile=128, device=dev)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["tile_contract"] > 0, "blocksparse_scale never launched "
          "tile_contract")

    # the S relation of every copy, block for block, without densifying
    B, G, W = state.tile, state.grid, state.tile // 32
    a = g.index_of("S")
    shift = (np.arange(SCALE_COPIES, dtype=np.int64) * off)[:, None]
    i = (rel[:, 0][None, :] + shift).ravel()
    j = (rel[:, 1][None, :] + shift).ravel()
    keys, slot = np.unique((i // B) * G + j // B, return_inverse=True)
    words = np.zeros(len(keys) * B * W, dtype=np.uint32)
    np.bitwise_or.at(words, (slot * B + i % B) * W + (j % B) // 32,
                     np.left_shift(np.uint32(1), (j % 32).astype(np.uint32)))
    have = sorted(rb * G + cb for rb, row in state.index[a].items() for cb in row)
    check(have == keys.tolist(), f"blocksparse_scale: {len(have)} S blocks, "
          f"Hellings needs {len(keys)}")
    slots = torch.tensor([state.index[a][int(k) // G][int(k) % G] for k in keys],
                         dtype=torch.int64, device=dev)
    want = torch.from_numpy(words.view(np.int32)).view(-1, B, W).to(dev)
    check(torch.equal(state.tiles[slots], want),
          "blocksparse_scale: S tiles != shifted Hellings")
    closure_s = total_s - probe.from_graph_s
    per_chunk = chunk_device_ops(graph, g, dev)
    emit("blocksparse_scale", copies=SCALE_COPIES, nodes=graph.n_nodes,
         edges=len(graph.edges), n=state.n, tile=B, grid=G,
         graph_build_s=graph_s, from_graph_s=probe.from_graph_s,
         closure_s=closure_s, total_s=total_s, occupied_blocks=state.occupied,
         state_mb=state.nbytes() / 2**20,
         store_mb=state.tiles.numel() * 4 / 2**20,
         dense_bool_tb=state.n_nonterms * state.n**2 / 1e12,
         iterations=probe.iterations, pairs_contracted=probe.pairs,
         chunks=probe.chunks, launches=launches,
         tile_device_ms=probe.device_ms,
         host_share_of_closure=1 - probe.device_ms / (1e3 * closure_s),
         s_pairs_checked=len(i), s_blocks=len(keys),
         max_memory_allocated=peak, memory_allocated_before=before,
         phase_peak_bytes=peak - before, device_ops_per_chunk=per_chunk)
    return state


def chunk_device_ops(graph, g, dev) -> dict | None:
    """Device operations per chunk of the block-sparse fixpoint: a second
    run of the closure of ``graph`` with ``torch.profiler`` around the
    fixpoint alone (not ``from_graph``), its device events by kind (kernels
    by name, copies, fills) over the chunks it contracted.  None where the
    profiler records no device event."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import blocksparse as tbs

    seen = {"chunks": 0}
    fixpoint, operands = tbs._blocksparse_fixpoint, tbs._chunk_operands

    def counted(*args):
        seen["chunks"] += 1
        return operands(*args)

    def profiled(*args):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fixpoint(*args)
            torch.cuda.synchronize()
        seen["events"] = [ev.name for ev in prof.events()
                          if ev.device_type == torch.autograd.DeviceType.CUDA]
        return out

    tbs._blocksparse_fixpoint, tbs._chunk_operands = profiled, counted
    try:
        tbs.blocksparse_closure_state(graph, g, tile=128, device=dev)
    finally:
        tbs._blocksparse_fixpoint, tbs._chunk_operands = fixpoint, operands
    names, chunks = Counter(seen.get("events", ())), seen["chunks"]
    if not names or not chunks:
        return None
    kinds = Counter("copy" if n.startswith("Memcpy") else
                    "fill" if n.startswith("Memset") else "kernel" for n in names.elements())
    return {"chunks": chunks, "per_chunk": {k: v / chunks for k, v in kinds.items()},
            "total_per_chunk": sum(kinds.values()) / chunks,
            "by_name": dict(names.most_common(12))}


def first_bucket(state, tables):
    """The first PAIR_CHUNK occupied (lhs, rhs, output block) pairs of the
    closed ``state`` in the fixpoint's enumeration order (all row-blocks
    active, every slot on the frontier)."""
    from repro_torch.core.blocksparse import PAIR_CHUNK

    pairs = []
    for a, b, c in zip(tables.a_idx, tables.b_idx, tables.c_idx):
        for rb, row in state.index[b].items():
            for kb, ls in row.items():
                for cb, rs in state.index[c].get(kb, {}).items():
                    pairs.append((ls, rs, (a, rb, cb)))
                    if len(pairs) == PAIR_CHUNK:
                        return pairs
    return pairs


def tile_bound(tiles, l_idx, r_idx, n_out: int) -> dict:
    """Least time of the tile contraction of the pairs ``(l_idx[i],
    r_idx[i])`` into ``n_out`` output blocks, counting only what these
    inputs need: bytes = each distinct slot named read once (one store
    serves both sides; of a slot named only as an rhs, only the rows that
    some set bit of its pairs' lhs tiles needs) and each output block read
    and written once, over HBM; operations = one OR of a W-word rhs row per
    set lhs bit, over the INT32 rate."""
    from repro_torch.core.matrices import unpack_bits

    B, W = tiles.shape[1:]
    lhs_bits = unpack_bits(tiles[l_idx.long()], B)  # (p, B rows, B columns)
    set_bits = int(lhs_bits.sum())
    lhs_slots = torch.unique(l_idx)
    rhs_slots, rhs_of = torch.unique(r_idx, return_inverse=True)
    needed = torch.zeros((len(rhs_slots), B), dtype=torch.uint8, device=tiles.device)
    needed.scatter_reduce_(0, rhs_of[:, None].expand(-1, B),
                           lhs_bits.any(1).to(torch.uint8), "amax")
    rhs_only = ~torch.isin(rhs_slots, lhs_slots)
    rhs_rows = int(needed[rhs_only].sum())
    words = (len(lhs_slots) * B + rhs_rows + 2 * n_out * B) * W
    bytes_ms = 4 * words / HBM_BYTES_PER_S * 1e3
    ops_ms = set_bits * W / INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "lhs_set_bits": set_bits, "distinct_lhs_slots": len(lhs_slots),
        "distinct_rhs_only_slots": int(rhs_only.sum()), "rhs_only_rows": rhs_rows,
        "bound_words": words,
    }


def tile_timing(state, launches: int, err: int) -> dict:
    """The tile kernel at the main path's bucket shape (512 pairs of
    (128, 4)-word tiles) on the real store of the scale phase, as the
    fixpoint runs it (the old tiles gathered and the flags set in the
    launch): one call (``ms``, the wrapper's host work included), device
    time, the plain version (``ref.tile_contract_chunk_ref``), and one bf16
    ``torch.bmm`` of the unpacked gathered tiles (the product only) as the
    library yardstick; ``runs`` counts the kernel's blocks that do work
    (runs of pairs sharing an lhs slot, cut at every 256th pair).  The bound is the larger of the bytes at HBM rate and
    one OR of a W-word rhs row per set lhs bit at the INT32 rate.  The
    bytes count only what the bucket needs: each distinct slot it names
    read once (one store serves both sides; of a slot named only as an
    rhs, only the rows some set bit of its pairs' lhs tiles needs), and
    one read and one write of each output block."""
    from repro_torch.core import blocksparse as tbs
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.matrices import ProductionTables, unpack_bits
    from repro_torch.kernels import ops, ref

    tables = ProductionTables.from_grammar(query1_grammar().to_cnf())
    pairs = first_bucket(state, tables)
    out_keys, _, _, l_idx, r_idx, seg, out_slot, exists = tbs._chunk_operands(
        state, pairs, state.tiles.device)
    tiles = state.tiles
    n_pad = out_slot.shape[0]
    err = max(err, held_tile(tiles, l_idx, r_idx, seg, out_slot, exists,
                             "the timed bucket"))
    work = ops.tile_work(tiles.shape[1], tbs.PAIR_CHUNK, tiles.device)

    def run():
        return ops.tile_contract_chunk(tiles, l_idx, r_idx, seg, out_slot, exists,
                                       n_pad, work)

    B = tiles.shape[1]
    p, n_out = len(pairs), len(out_keys)
    ls = [x for x, _, _ in pairs]
    runs = sum(1 for i in range(p) if i % 256 == 0 or ls[i] != ls[i - 1])
    bnd = tile_bound(tiles, l_idx[:p], r_idx[:p], n_out)
    a = unpack_bits(tiles[l_idx[:p].long()], B).to(torch.bfloat16)
    b = unpack_bits(tiles[r_idx[:p].long()], B).to(torch.bfloat16)
    row = {
        "name": "tile_contract", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tile_bitmm.cu",
        "replaces": "src/repro/kernels/ops.py:54",
        "launches": launches, "max_abs_err": err,
        "ms": time_ms(run, reps=20, warmup=3),
        "plain_ms": time_ms(lambda: ref.tile_contract_chunk_ref(
            tiles, l_idx, r_idx, seg, out_slot, exists, n_pad), reps=5),
        "bound_ms": bnd.pop("bound_ms"), "bound_by": bnd.pop("bound_by"),
        "library_ms": time_ms(lambda: torch.bmm(a, b), reps=20, warmup=3),
        "ms_device": device_ms(run, reps=50),
        "pairs": p, "output_blocks": n_out, "runs": runs,
        "tile": list(tiles.shape[1:]), **bnd,
    }
    del a, b
    emit("tile_timing", **row)
    return row


# ---------------------------------------------------------------------- #
# single-path semantics and the serving loop at full width
# ---------------------------------------------------------------------- #

SP_SOURCES = 16  # single-source queries per batch, all in pizza copy 0


def cyk_derives(g, start: str, word: list[str]) -> bool:
    """CYK over the CNF grammar ``g``: does ``start`` derive ``word``?"""
    n = len(word)
    if n == 0:
        return start in g.nullable
    tab = np.zeros((n, n + 1, g.n_nonterms), dtype=bool)  # [i, j) spans
    for i, x in enumerate(word):
        for a in g.term_prods.get(x, ()):
            tab[i, i + 1, a] = True
    for span in range(2, n + 1):
        for i in range(n - span + 1):
            j = i + span
            for a, b, c in g.binary_prods:
                if not tab[i, j, a]:
                    tab[i, j, a] = bool(
                        np.any(tab[i, i + 1:j, b] & tab[i + 1:j, j, c]))
    return bool(tab[0, n, g.index_of(start)])


def check_witness(edges: set, g, i: int, j: int, path, length: int,
                  what: str) -> None:
    """``path`` is a walk i ->* j over ``edges`` whose label word the
    grammar derives from S, with ``length`` edges."""
    if not path:
        check(i == j and "S" in g.nullable, f"{what}: empty witness of ({i}, {j})")
        return
    check(path[0][0] == i and path[-1][2] == j, f"{what}: witness ends wrong")
    prev = i
    for e in path:
        check(e[0] == prev and e in edges, f"{what}: {e} breaks the walk")
        prev = e[2]
    check(cyk_derives(g, "S", [x for _, x, _ in path]),
          f"{what}: witness word not derived from S")
    check(len(path) == length,
          f"{what}: witness has {len(path)} edges, L says {length}")


def state_equals_mirror(L: torch.Tensor, host: np.ndarray) -> bool:
    """The host mirror equals the whole device state, one plane at a time."""
    return all(
        torch.equal(torch.from_numpy(host[a]).to(L.device), L[a])
        for a in range(L.shape[0])
    )


def minplus_bound(lhs, base, slab, row, finite_only: bool = True) -> dict:
    """Least time of ``ops.minplus(lhs, base, slab, row)``: the larger of
    bytes over HBM and operations (an add and a min per candidate) over
    the float32 rate.  Counting what the inputs need (``finite_only``):
    the lhs read once, of the rhs only the rows (slab[p], row[k]) that some
    finite lhs entry names, the output written once, and 2 operations per
    finite lhs entry per output column.  Else every candidate: the whole
    gathered rhs (P, K, C) read and 2 operations per (p, i, k, j)."""
    P, R, K = lhs.shape
    C = base.shape[-1]
    fin = torch.isfinite(lhs)
    nnz = int(fin.sum())
    if finite_only:
        named = fin.any(dim=1)  # (P, K): rhs row k of slab p is read
        keys = (slab[:, None] * base.shape[1] + row[None, :])[named]
        rhs_rows = int(torch.unique(keys).numel())
        ops_n = 2 * nnz * C
    else:
        rhs_rows, ops_n = P * K, 2 * P * R * K * C
    bytes_ms = 4 * (lhs.numel() + rhs_rows * C + P * R * C) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "finite_lhs": nnz, "rhs_rows_read": rhs_rows}


def baseline_rows_ms(fn, lhs, base, slab, row, acc, want, reps: int) -> list[float]:
    """Device time of another revision's min-plus or count kernel (its C
    entry point ``fn``, whose arguments are this revision's) on these
    operands, after checking that it computes ``want``: timed before and
    after this revision's kernel, so the two alternate (baseline, this,
    baseline)."""
    P, R, K = lhs.shape
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run():
        return fn(lhs.data_ptr(), base.data_ptr(), ptr(slab), ptr(row), ptr(acc),
                  out.data_ptr(), P, R, K, base.shape[2], base.shape[1], stream)

    check(run() == 0, f"the baseline {fn.__name__} did not launch")
    torch.cuda.synchronize()
    check(torch.equal(out, want), f"the baseline {fn.__name__} != this kernel")
    return [device_ms(run, reps=reps)]


def with_baseline(times: dict, fn, reps: int, baseline, entry: str, *operands) -> None:
    """Add ``ms_device_baseline`` to ``times`` (which has this kernel's
    ``ms_device``) with ``baseline`` (another revision's library): its
    ``entry`` timed before this kernel and after it, and this kernel once
    more between them (``ms_device_again``)."""
    if baseline is None:
        return
    first = baseline_rows_ms(getattr(baseline, entry), *operands, reps=reps)
    times["ms_device_again"] = device_ms(fn, reps=reps)
    times["ms_device_baseline"] = first + baseline_rows_ms(
        getattr(baseline, entry), *operands, reps=reps)


def minplus_timing(L: torch.Tensor, mask: np.ndarray, tables, err: float,
                   baseline=None) -> dict:
    """One dense single-path iteration's min-plus product at R = 1024 on
    rows of the state, as the closure calls it: lhs (P, R, R) the active
    block, the rhs rows named in L by the productions' C operands and the
    active rows.  The kernel is checked equal to its plain version and
    timed: one call (``ms``, CUDA events around the wrapper: its checks,
    the index check's host sync and the launch), device time of launches
    back to back (``ms_device``), the plain version; beside its bound
    counting the data (the finite lhs entries and the rhs rows they name)
    and the bound of the dense product (every candidate).  Then the same
    shape with a fully finite random lhs, beside its operations bound.
    With ``baseline`` (another revision's min-plus library) its device time
    on both operands too (:func:`with_baseline`)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.minplus import minplus_launch

    R = 1024
    idx = torch.from_numpy(np.nonzero(mask)[0][:R]).to(L.device)
    b_idx, c_idx = tables.index_tensors(L.device)
    lhs = L[:, idx, :][:, :, idx][b_idx]
    P, rows_n, K = lhs.shape
    out = ops.minplus(lhs, L, c_idx, idx)
    want = ref.minplus_ref(lhs, L, c_idx, idx)
    check(torch.equal(out, want), "minplus != its plain version on the state")
    check(not bool(torch.isnan(out).any()), "min-plus produced NaN")
    # the frontier closure's form: the product of the delta rows min-accumulated
    # into the product against the active rows, here with half the entries
    # as the delta
    rows = L[:, idx, :]
    rows_d = torch.where(torch.arange(rows.shape[-1], device=L.device) % 2 == 0,
                         rows, float("inf"))
    lhs_d = rows_d[:, :, idx][b_idx]
    acc = ops.minplus(lhs, rows_d, c_idx)
    check(torch.equal(acc, ref.minplus_ref(lhs, rows_d, c_idx)),
          "minplus != its plain version on the state's delta rows")
    want = ref.minplus_ref(lhs_d, L, c_idx, idx, acc=acc)
    check(torch.equal(ops.minplus(lhs_d, L, c_idx, idx, acc=acc), want),
          "minplus (acc form) != its plain version on the state")
    del want, rows, rows_d, lhs_d, acc
    bnd = minplus_bound(lhs, L, c_idx, idx)
    dense = minplus_bound(lhs, L, c_idx, idx, finite_only=False)
    def run():
        minplus_launch(lhs, L, c_idx, idx, None, out)

    row = {
        "name": "minplus", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "src/repro/core/semantics.py:50",
        "launches": None, "max_abs_err": err,
        "ms": time_ms(lambda: ops.minplus(lhs, L, c_idx, idx), reps=10, warmup=2),
        "plain_ms": time_ms(lambda: ref.minplus_ref(lhs, L, c_idx, idx), reps=2),
        "bound_ms": bnd.pop("bound_ms"), "bound_by": bnd.pop("bound_by"),
        "library_ms": None,
        "ms_device": device_ms(run, reps=20),
        "R": rows_n, "K": K, "C": L.shape[-1], "P": P, **bnd,
        "dense_bound_ms": dense["bound_ms"], "dense_bound_by": dense["bound_by"],
    }
    with_baseline(row, run, 20, baseline, "repro_minplus",
                  lhs, L, c_idx, idx, None, out)
    gen = torch.Generator(device=L.device)
    gen.manual_seed(4)
    full = random_lengths(gen, tuple(lhs.shape), 1.0, L.device)
    got = ops.minplus(full, L, c_idx, idx)
    check(torch.equal(got, ref.minplus_ref(full, L, c_idx, idx)),
          "minplus != its plain version on a fully finite lhs")
    fbnd = minplus_bound(full, L, c_idx, idx)

    def run_full():
        minplus_launch(full, L, c_idx, idx, None, got)

    row["finite_lhs_case"] = {
        "ms": time_ms(lambda: ops.minplus(full, L, c_idx, idx), reps=3),
        "ms_device": device_ms(run_full, reps=3),
        **fbnd,
    }
    with_baseline(row["finite_lhs_case"], run_full, 3, baseline, "repro_minplus",
                  full, L, c_idx, idx, None, got)
    del lhs, out, full, got
    torch.cuda.empty_cache()
    emit("minplus_timing", **row)
    return row


#: (P, R, K, C) of the random min-plus checks: K and C off every multiple
#: of 4 and 32, more than one column tile, one row tile with a ragged edge,
#: and the repair's K = n
MINPLUS_SHAPES = ((3, 37, 45, 101), (2, 130, 33, 1030), (1, 8, 1, 4),
                  (6, 64, 991, 2048), (6, 16, 15872, 1100))
MINPLUS_DENSITIES = (1e-4, 1e-2, 1.0)  # share of finite lhs entries


#: (name, P, R, K, C) of the cases that reach each branch of the sparse-row
#: design (csrc/sparse_rows.cuh), beside the random shapes above: rows whose
#: list overflows a warp's 512 entries (fully taken rows among empty ones;
#: lists of exactly 512 and 513 entries), K = 0, R off the 8-row block and
#: C off 4 and the 512-column tile, a misaligned lhs (its 4-byte fringe
#: beside a 16-byte body) and misaligned operands (the single-column
#: sweep), acc at its absorbing value (SAT or inf), one row of one column
SPARSE_ROW_CASES = (
    ("overflow rows among empty ones", 2, 45, 1500, 777),
    ("lists of 512 and 513 entries", 1, 9, 1030, 516),
    ("K = 0", 2, 9, 0, 100),
    ("one row, one column", 1, 1, 7, 1),
    ("misaligned lhs", 3, 13, 50, 1028),
    ("misaligned operands", 2, 11, 51, 1024),
    ("acc absorbing", 2, 17, 300, 600),
)


def three_forms(lhs, rhs, base, slab, row, acc):
    """(form, args, kwargs) of the min-plus and count kernels' three forms:
    plain (rhs (P, K, C)), index (rhs rows of ``base`` by slab and row) and
    acc (the index form with ``acc``)."""
    return (("plain", (lhs, rhs), {}), ("index", (lhs, base, slab, row), {}),
            ("acc", (lhs, base, slab, row), {"acc": acc}))


def sparse_row_operands(gen, case, values, empty, top, dev):
    """lhs, base, slab, row and acc of one SPARSE_ROW_CASES case;
    ``values(shape, share)`` draws ring values taken at ``share`` (``empty``
    elsewhere: 0 or inf), ``top`` is the absorbing value (SAT or inf)."""
    name, P, R, K, C = case
    lhs = values((P, R, K), 0.05)
    lhs[:, ::4] = empty  # rows without a taken entry
    if name == "overflow rows among empty ones":
        lhs.fill_(empty)
        lhs[:, [3, 17, 40]] = values((P, 3, K), 1.0)
        lhs[:, 5] = values((P, K), 0.5)
    elif name == "lists of 512 and 513 entries":
        lhs.fill_(empty)
        for i, m in enumerate((512, 513, 1024, K)):
            lhs[:, i, :m] = values((P, m), 1.0)
    base = values((P + 1, K + 3, C), 0.5)
    slab = torch.randperm(P + 1, generator=gen, device=dev)[:P]
    row = torch.randint(0, K + 3, (K,), generator=gen, device=dev)
    acc = values((P, R, C), 0.3)
    if name == "acc absorbing":
        acc[:, ::2] = top
    if name.startswith("misaligned"):
        lhs = misaligned(lhs)
        if name == "misaligned operands":
            base, acc = misaligned(base), misaligned(acc)
    return lhs, base, slab, row, acc


def random_lengths(gen, shape, finite: float, dev, integral: bool = True):
    """f32 lengths >= 1 (integers below 1,000, or any float below 1,000),
    +inf outside a share ``finite`` of the entries."""
    x = torch.rand(shape, generator=gen, device=dev) * 999 + 1
    if integral:
        x = x.floor()
    keep = torch.rand(shape, generator=gen, device=dev) < finite
    return torch.where(keep, x, float("inf"))


def phase_minplus_checks(dev) -> float:
    """The min-plus kernel against its plain version, ``torch.equal``, on
    random cases: every shape of MINPLUS_SHAPES at every finite share of
    MINPLUS_DENSITIES (integral lengths, and at share 1e-2 any float, so
    the adds round), with a quarter of the lhs rows all inf; each plain
    (rhs (P, K, C)), in the index form (rhs rows of a larger base named
    by a permuted slab index and a repeated, unsorted row index), and in
    the acc form.  Returns the largest absolute difference (0)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    cases = err = 0
    for P, R, K, C in MINPLUS_SHAPES:
        for d in MINPLUS_DENSITIES:
            for integral in ((True, False) if d == 1e-2 else (True,)):
                lhs = random_lengths(gen, (P, R, K), d, dev, integral)
                lhs[:, ::4] = float("inf")  # rows without a finite entry
                rhs = random_lengths(gen, (P, K, C), 0.5, dev, integral)
                base = random_lengths(gen, (P + 1, K + 3, C), 0.5, dev, integral)
                slab = torch.randperm(P + 1, generator=gen, device=dev)[:P]
                row = torch.randint(0, K + 3, (K,), generator=gen, device=dev)
                acc = random_lengths(gen, (P, R, C), 0.3, dev, integral)
                for form, args, kwargs in three_forms(lhs, rhs, base, slab, row, acc):
                    got = ops.minplus(*args, **kwargs)
                    want = ref.minplus_ref(*args, **kwargs)
                    same = torch.isinf(got) == torch.isinf(want)
                    fin = torch.isfinite(want)
                    diff = (got[fin] - want[fin]).abs().max() if fin.any() else 0.0
                    err = max(err, float(diff))
                    check(bool(same.all()) and torch.equal(got, want),
                          f"minplus != its plain version: {(P, R, K, C)}, "
                          f"finite {d}, {form}, integral {integral}")
                    cases += 1
                del lhs, rhs, base, acc
    inf = float("inf")
    for case in SPARSE_ROW_CASES:
        lhs, base, slab, row, acc = sparse_row_operands(
            gen, case, lambda shape, d: random_lengths(gen, shape, d, dev),
            inf, inf, dev)
        rhs = base[slab][:, row].contiguous()
        for form, args, kwargs in three_forms(lhs, rhs, base, slab, row, acc):
            got = ops.minplus(*args, **kwargs)
            check(torch.equal(got, ref.minplus_ref(*args, **kwargs)),
                  f"minplus != its plain version: {case}, {form}")
            cases += 1
        del lhs, rhs, base, acc
    torch.cuda.synchronize()
    emit("minplus_checks", kernel="minplus", cases=cases, max_abs_err=err,
         shapes=[list(x) for x in MINPLUS_SHAPES], densities=MINPLUS_DENSITIES,
         sparse_row_cases=[c[0] for c in SPARSE_ROW_CASES],
         tolerance="bit equality (torch.equal)")
    return err


def phase_single_path(dev, backend: str, minplus_err: float | None = None,
                      baseline=None):
    """Single-path CFPQ at full width on ``backend``: a cold batch of 16
    single-source queries in pizza copy 0, a second batch of 16, the
    Section 5 golden case, then seeded edits to copy 0 through
    ``apply_delta`` and the cold batch again.  Checked: pairs against
    Hellings, every witness a walk whose word Query 1 derives with as many
    edges as its entry of L, the host mirror against the device state,
    rows outside copy 0 bit-identical across the edit, the repaired rows'
    support against a fresh engine's closure, and that the cold batch and
    the edit launched the min-plus kernel.  With ``minplus_err`` (the
    largest error of the kernel's checks) it also times one min-plus
    product on the state (:func:`minplus_timing`; ``baseline``: another
    revision's min-plus library timed beside it).  Returns ``(min-plus
    launches of the phase's batches and edit, the timing row or None)``."""
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import Graph, paper_example_graph, paper_table_graph
    from repro_torch.engine import EngineConfig, Query, QueryEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    g = query1_grammar().to_cnf()
    a0 = g.index_of("S")
    off = paper_table_graph("pizza").n_nodes
    graph = paper_table_graph("pizza").repeat(PIZZA_COPIES)
    picks = np.random.default_rng(3).choice(off, size=2 * SP_SOURCES, replace=False)
    cold, second = [int(s) for s in picks[:SP_SOURCES]], [int(s) for s in picks[SP_SOURCES:]]

    def engine_of(gr):
        # iteration events on: the closure's iterations are counted
        return QueryEngine(gr, config=EngineConfig(engine=backend, device=str(dev)),
                           metrics=MetricsRegistry(), tracer=Tracer())

    eng = engine_of(graph)
    tr = eng.tracer

    def serve(sources, label):
        oracle = _copy_oracle(graph, g, 0, off)
        edges = set(graph.edges)
        first = len(tr.spans)
        outs, ms, launches = run_phase(lambda: eng.query_batch(
            [Query(g, "S", sources=(s,), semantics="single_path") for s in sources]))
        peak = torch.cuda.max_memory_allocated()
        (st,) = eng._states.values()
        n_paths = 0
        for s, r in zip(sources, outs):
            check(r.pairs == {p for p in oracle if p[0] == s},
                  f"single_path_{backend} {label}: source {s} != Hellings")
            check(set(r.paths) == r.pairs, f"{label}: a pair without a witness")
            for (i, j), path in r.paths.items():
                check_witness(edges, g, i, j, path, int(st.sp_L_host[a0, i, j]),
                              f"single_path_{backend} {label} ({i}, {j})")
                n_paths += 1
        closures = [s for s in tr.spans[first:] if s.name == "closure.execute"]
        keys = [k for k in eng.plans._exe if k.semantics == "single_path"]
        return {
            "wall_ms": ms, "cache": outs[0].stats.cache,
            "route": (outs[0].stats.planner or {}).get("label"),
            "closure_engine": [s.attrs["engine"] for s in closures],
            "closure_execute_ms": span_ms(tr, first, "closure.execute"),
            "closure_calls": sum(s.attrs.get("calls", 0) for s in closures),
            "iterations": sum(1 for s in closures for e in s.events
                              if e["name"] == "iteration"),
            "row_capacity": max((k.row_capacity for k in keys), default=None),
            "active_rows": outs[0].stats["active_rows"],
            "mirror_init_ms": span_ms(tr, first, "state.mirror_init"),
            "host_copy_ms": span_ms(tr, first, "closure.host_copy"),
            "host_copy_bytes": sum(s.attrs["bytes"] for s in tr.spans[first:]
                                   if s.name == "closure.host_copy"),
            "extraction_ms": span_ms(tr, first, "witness.extract"),
            "pairs": sum(len(r.pairs) for r in outs), "witnesses": n_paths,
            "launches": launches, "max_memory_allocated": peak,
        }

    batches = {"cold": serve(cold, "cold"), "second": serve(second, "second")}
    (st,) = eng._states.values()
    check(state_equals_mirror(st.sp_L, st.sp_L_host),
          f"single_path_{backend}: host mirror != device state")
    timing = (minplus_timing(st.sp_L, st.sp_mask, st.tables, minplus_err, baseline)
              if minplus_err is not None else None)

    # the paper's example: (1, 2) freezes at 2, (0, 2) at 4, (0, 0) at 6
    small = QueryEngine(paper_example_graph(),
                        config=EngineConfig(engine=backend, device=str(dev)))
    r = small.query(Query(g, "S", semantics="single_path"))
    golden = {(0, 0): 6, (0, 2): 4, (1, 2): 2}
    check(r.pairs == set(golden), f"single_path_{backend}: golden pairs {r.pairs}")
    for (i, j), path in r.paths.items():
        check_witness(set(paper_example_graph().edges), g, i, j, path, golden[(i, j)],
                      f"single_path_{backend} golden ({i}, {j})")

    # seeded edits to copy 0; rows of the other copies must not move
    delete, insert = _seeded_edits(np.random.default_rng(7), graph, g, off, copies=(0,))
    keep = st.sp_L[:, off:, :].clone()
    first = len(tr.spans)
    dst, delta_ms, launches = run_phase(
        lambda: eng.apply_delta(insert=insert, delete=delete))
    peak = torch.cuda.max_memory_allocated()
    (st,) = eng._states.values()
    check(dst.rows_repaired > 0 and dst.rows_evicted > 0,
          f"single_path_{backend}: the edit repaired or evicted nothing: {dst}")
    check(torch.equal(st.sp_L[:, off:, :], keep),
          f"single_path_{backend}: rows outside copy 0 changed")
    del keep
    check(state_equals_mirror(st.sp_L, st.sp_L_host),
          f"single_path_{backend}: host mirror != device state after the edit")
    repairs = [s for s in tr.spans[first:]
               if s.name == "closure.execute" and s.attrs.get("repair")]
    delta = {
        "edits": {"delete": len(delete), "insert": len(insert)},
        "apply_delta_ms": delta_ms,
        "delta_repair_span_ms": span_ms(tr, first, "delta.repair"),
        "repair_closure_execute_ms": span_ms(tr, first, "closure.execute", repair=True),
        "repair_engine": [s.attrs["engine"] for s in repairs],
        "host_copy_ms": span_ms(tr, first, "delta.host_copy"),
        "host_copy_rows": sum(s.attrs["rows"] for s in tr.spans[first:]
                              if s.name == "delta.host_copy"),
        "launches": launches, "max_memory_allocated": peak, **dst.as_dict(),
    }
    batches["after_edit"] = serve(cold, "after the edit")
    (st,) = eng._states.values()
    rows = [int(i) for i in np.nonzero(st.sp_mask)[0] if i < graph.n_nodes]
    fresh = engine_of(Graph(graph.n_nodes, list(graph.edges)))
    fresh.query(Query(g, "S", sources=tuple(rows), semantics="single_path"))
    (fst,) = fresh._states.values()
    M = st.sp_mask
    check(bool(fst.sp_mask[M].all()), "the fresh closure misses repaired rows")
    check(np.array_equal(np.isfinite(st.sp_L_host[:, M, :]),
                         np.isfinite(fst.sp_L_host[:, M, :])),
          f"single_path_{backend}: repaired support != a fresh closure")
    del fresh, fst, st, eng
    torch.cuda.empty_cache()
    minplus_launches = sum(b["launches"]["minplus"] for b in batches.values())
    minplus_launches += delta["launches"]["minplus"]
    emit(f"single_path_{backend}", n=graph.n_nodes, sources=SP_SOURCES,
         batches=batches, delta=delta, minplus_launches=minplus_launches,
         golden={f"{i},{j}": v for (i, j), v in golden.items()})
    for label, launches in (("the cold batch", batches["cold"]["launches"]),
                            ("the edit", delta["launches"])):
        check(launches["minplus"] > 0, f"single_path_{backend}: {label} never "
              f"launched the min-plus kernel ({launches})")
    return minplus_launches, timing


SERVE_REQUESTS = 512
SERVE_QPS = 200.0
SERVE_WRITE_AFTER = 256  # the fenced write follows this many arrivals


def _pctl(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None


def phase_serve(dev) -> None:
    """The async server at full width: 512 single-source requests (Query 1
    and Query 2, Zipf-ish repeated sources over all 16 copies, one in 8 a
    single-path Query 1 request in copy 0) at 200 offered queries/s, and a
    fenced ``apply_delta`` on copies 0 and 1 after the 256th arrival (2
    deletes and 3 inserts in copy 0, 3 inserts in copy 1).
    Checked: every answer against Hellings of its copy at the epoch it
    reports, requests admitted before the write served at the old epoch,
    witnesses, exactly-once accounting with no failure, the kernel of
    every route taken launched, and the min-plus kernel launched when a
    single-path request was served."""
    import asyncio

    from repro_torch.core.grammar import query1_grammar, query2_grammar
    from repro_torch.core.graph import paper_table_graph
    from repro_torch.engine import EngineConfig, Query, QueryEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import CFPQServer, Overloaded, ServeConfig, poisson_arrivals

    grammars = {"q1": query1_grammar().to_cnf(), "q2": query2_grammar().to_cnf()}
    off = paper_table_graph("pizza").n_nodes
    graph = paper_table_graph("pizza").repeat(PIZZA_COPIES)
    rng = np.random.default_rng(11)
    arrivals = poisson_arrivals(SERVE_REQUESTS, SERVE_QPS, rng)
    hot = rng.integers(0, graph.n_nodes, size=8)
    hot0 = rng.integers(0, off, size=8)
    work = []
    for k in range(SERVE_REQUESTS):
        if k % 8 == 7:  # single-path, copy 0
            src = int(hot0[int(rng.integers(0, 8))]) if rng.random() < 0.5 \
                else int(rng.integers(0, off))
            work.append(("q1", Query(grammars["q1"], "S", sources=(src,),
                                     semantics="single_path")))
            continue
        name = ("q1", "q2")[int(rng.integers(0, 2))]
        src = int(hot[int(rng.integers(0, 8))]) if rng.random() < 0.5 \
            else int(rng.integers(0, graph.n_nodes))
        work.append((name, Query(grammars[name], "S", sources=(src,))))
    # copy 0: 2 deletes and 3 inserts (its rows are evicted, then rebuilt
    # from the inserted sources); copy 1: 3 inserts only (its cached rows
    # are re-seeded warm, which the planner routes to the packed repair)
    erng = np.random.default_rng(7)
    delete, insert = _seeded_edits(erng, graph, grammars["q1"], off, copies=(0,))
    insert += _seeded_edits(erng, graph, grammars["q1"], off, copies=(1,))[1]

    # Hellings per copy before the write (one copy, shifted) and after it
    oracle = {0: {}, 1: {}}
    for name, g in grammars.items():
        base = _copy_oracle(graph, g, 0, off)
        oracle[0][name] = {c: {(i + c * off, j + c * off) for i, j in base}
                          for c in range(PIZZA_COPIES)}
    edges = {0: set(graph.edges)}

    eng = QueryEngine(graph, config=EngineConfig(engine="auto", device=str(dev)),
                      metrics=MetricsRegistry())
    a0 = grammars["q1"].index_of("S")
    write = {}
    inner_apply = eng.apply_delta

    def closure_calls_by_engine():
        return {c.labels["engine"]: c.value
                for c in eng.metrics.closure_calls.children}

    def apply_delta(insert, delete):
        # the writer's engine call: runs in the server's worker after the
        # fence (no batch runs beside it); keeps copy 0's S-plane lengths
        # of the old epoch, and which backends ran the repair closures and
        # what they launched
        (st,) = [s for s in eng._states.values() if s.sp_L is not None]
        write["old_L"] = st.sp_L_host[a0, :off, :].copy()
        calls0, launches0 = closure_calls_by_engine(), read_launches()
        t0 = time.perf_counter()
        out = inner_apply(insert=insert, delete=delete)
        torch.cuda.synchronize()
        write["apply_delta_ms"] = (time.perf_counter() - t0) * 1e3
        write["repair_engines"] = sorted(
            e for e, v in closure_calls_by_engine().items() if v > calls0.get(e, 0))
        write["launches"] = {k: v - launches0[k] for k, v in read_launches().items()}
        return out

    eng.apply_delta = apply_delta
    inner_batch = eng.query_batch

    def query_batch(*args, **kwargs):
        # the server times this call as batch-exec: end it on the device
        out = inner_batch(*args, **kwargs)
        torch.cuda.synchronize()
        return out

    eng.query_batch = query_batch
    cfg = ServeConfig(max_batch=16, batch_window_s=0.005, max_queue_depth=256)

    async def main():
        results = [None] * SERVE_REQUESTS
        shed = 0
        async with CFPQServer(eng, cfg) as srv:

            async def one(k):
                nonlocal shed
                await asyncio.sleep(float(arrivals[k]))
                try:
                    results[k] = await srv.submit(work[k][1])
                except Overloaded:
                    shed += 1

            async def writer():
                await asyncio.sleep(float(arrivals[SERVE_WRITE_AFTER - 1]) + 1e-3)
                t0 = time.perf_counter()
                write["stats"] = await srv.apply_delta(insert=insert, delete=delete)
                write["write_ms"] = (time.perf_counter() - t0) * 1e3

            await asyncio.gather(writer(), *[one(k) for k in range(SERVE_REQUESTS)])
            stats = srv.stats
        return results, shed, stats

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, shed, stats = asyncio.run(asyncio.wait_for(main(), 900))
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    edges[1] = set(graph.edges)
    for name, g in grammars.items():
        oracle[1][name] = dict(oracle[0][name])
        for c in (0, 1):
            oracle[1][name][c] = _copy_oracle(graph, g, c, off)
    (sp_state,) = [s for s in eng._states.values() if s.sp_L is not None]
    new_L = sp_state.sp_L_host
    served = [r for r in results if r is not None]
    check(stats.failed == 0, f"serve_open_loop: {stats.failed} requests failed")
    check(stats.served + stats.failed + stats.cancelled == stats.admitted,
          f"serve_open_loop: accounting broken: {stats.as_dict()}")
    check(len(served) == stats.served and len(served) + shed == SERVE_REQUESTS,
          "serve_open_loop: a request was lost")
    n_sp = 0
    for k, r in enumerate(results):
        if r is None:
            continue
        name, q = work[k]
        ep = r.stats["epoch"]
        check(ep in (0, 1), f"serve_open_loop: epoch {ep}")
        if k < SERVE_WRITE_AFTER:
            check(ep == 0, f"serve_open_loop: request {k} admitted before the "
                  "write was served after it")
        (src,) = q.sources
        want = {p for p in oracle[ep][name][src // off] if p[0] == src}
        check(r.pairs == want, f"serve_open_loop: request {k} ({name}, "
              f"{q.semantics}, source {src}, epoch {ep}) != Hellings")
        if q.semantics == "single_path":
            n_sp += 1
            L = write["old_L"] if ep == 0 else new_L[a0]
            for (i, j), path in r.paths.items():
                check_witness(edges[ep], grammars["q1"], i, j, path,
                              int(L[i, j]), f"serve_open_loop request {k}")
    e2e = [r.stats["queue_delay_s"] + r.stats["batch_exec_s"] for r in served]
    qd = [r.stats["queue_delay_s"] for r in served]
    bx = [r.stats["batch_exec_s"] for r in served]
    emit("serve_open_loop", requests=SERVE_REQUESTS, offered_qps=SERVE_QPS,
         served=stats.served, failed=stats.failed, cancelled=stats.cancelled,
         admitted=stats.admitted, shed=shed, single_path=n_sp, wall_s=wall_s,
         throughput_qps=len(served) / wall_s,
         e2e_ms={"p50": _pctl(e2e, 50), "p99": _pctl(e2e, 99)},
         queue_delay_ms={"p50": _pctl(qd, 50), "p99": _pctl(qd, 99)},
         batch_exec_ms={"p50": _pctl(bx, 50), "p99": _pctl(bx, 99)},
         mean_batch=stats.mean_batch, batches=stats.batches,
         flushes=stats.flushes, planner_routes=stats.planner_routes,
         fallbacks=stats.fallbacks, launches=launches,
         write_ms=write["write_ms"], apply_delta_ms=write["apply_delta_ms"],
         repair_engines=write["repair_engines"], write_launches=write["launches"],
         write_minplus_launches=write["launches"]["minplus"],
         fence_ms=write["write_ms"] - write["apply_delta_ms"],
         delta=write["stats"].as_dict(), max_memory_allocated=peak, n=graph.n_nodes)
    # every route taken must have launched its kernel: the planner's routes
    # and the fallbacks' targets (relational batches), and the repair
    # closures of the write (a packed repair launches bitmm_or)
    served_by = {r.stats["engine"] for r in served
                 if r.stats.planner is not None and r.query.semantics == "relational"}
    for route in set(stats.planner_routes) | served_by:
        check_route_launched(route, launches, "serve_open_loop")
    for route in write["repair_engines"]:
        kernel = {"bitpacked": "bitmm_or", "blocksparse": "tile_contract"}.get(route)
        if kernel is not None:
            check(write["launches"][kernel] > 0, f"serve_open_loop: the write's "
                  f"{route} repair never launched {kernel} ({write['launches']})")
    check(sum(launches.values()) > 0,
          "serve_open_loop launched no hand-written kernel")
    check(n_sp == 0 or launches["minplus"] > 0, "serve_open_loop served "
          f"{n_sp} single-path requests but never launched the min-plus kernel")
    del eng, sp_state, new_L
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# conjunctive and count semantics at full width, and the count kernel
# ---------------------------------------------------------------------- #

CONJ_SOURCES = 256  # single-source conjunctive queries per batch
COUNT_SOURCES = 16  # single-source count queries, all in copy 0
ANBNCN = 256  # the golden chain a^n b^n c^n
SAT = 0xFFFFFFFF
COUNT_KINDS = ("small", "2^16", "sat")  # count values of the kernel checks


def same_generation_grammar():
    """"Same generation by subclass and by type" as a conjunctive grammar:
    S holds where G = subClassOf_r^k subClassOf^k and H = type_r^m type^m
    both do — 9 nonterminals, 14 flattened conjuncts."""
    from repro_torch.core.conjunctive import ConjunctiveGrammar

    return ConjunctiveGrammar.from_rules(
        {"subClassOf_r": ["Sr"], "subClassOf": ["Sc"], "type_r": ["Tr"],
         "type": ["Ty"]},
        [("S", [("Sr", "Gc"), ("Tr", "Hc")]), ("S", [("Sr", "Gc"), ("Tr", "Ty")]),
         ("S", [("Sr", "Sc"), ("Tr", "Hc")]), ("S", [("Sr", "Sc"), ("Tr", "Ty")]),
         ("G", [("Sr", "Gc")]), ("G", [("Sr", "Sc")]), ("Gc", [("G", "Sc")]),
         ("H", [("Tr", "Hc")]), ("H", [("Tr", "Ty")]), ("Hc", [("H", "Ty")])])


def conjunctive_of(g):
    """A CNF grammar as a conjunctive one, one conjunct per production."""
    from repro_torch.core.conjunctive import ConjunctiveGrammar

    name = g.nonterms
    return ConjunctiveGrammar.from_rules(
        {x: [name[a] for a in lhss] for x, lhss in g.term_prods.items()},
        [(name[a], [(name[b], name[c])]) for a, b, c in g.binary_prods])


def anbncn_grammar():
    """{a^n b^n c^n}, the non-context-free golden language."""
    from repro_torch.core.conjunctive import ConjunctiveGrammar

    return ConjunctiveGrammar.from_rules(
        {"a": ["A"], "b": ["B"], "c": ["C"]},
        [("S", [("AB", "C"), ("A", "BC")]), ("S", [("AB", "Cp"), ("Ap", "BC")]),
         ("AB", [("A", "B")]), ("AB", [("A", "ABb")]), ("ABb", [("AB", "B")]),
         ("BC", [("B", "C")]), ("BC", [("B", "BCc")]), ("BCc", [("BC", "C")]),
         ("Cp", [("C", "C")]), ("Cp", [("C", "Cp")]), ("Ap", [("A", "A")]),
         ("Ap", [("A", "Ap")])])


def _copy_graph(graph, copy: int, off: int):
    """Pizza copy ``copy`` of ``graph`` alone, in local ids."""
    from repro_torch.core.graph import Graph

    lo = copy * off
    edges = [(i - lo, x, j - lo) for i, x, j in graph.edges if lo <= i < lo + off]
    check(all(0 <= j < off for _, _, j in edges), "an edge leaves its copy")
    return Graph(off, edges)


def conj_copy_oracle(graph, copy: int, off: int) -> set[tuple[int, int]]:
    """The exact S-pairs of the same-generation grammar on one copy, in
    global ids: the AND at the top is over exact CFG relations, so it is
    Hellings(G) and Hellings(H) intersected."""
    from repro_torch.baselines.hellings import hellings_cfpq
    from repro_torch.core.grammar import Grammar

    one = _copy_graph(graph, copy, off)
    rel = {}
    for nt, (up, down) in (("G", ("subClassOf_r", "subClassOf")),
                           ("H", ("type_r", "type"))):
        g = Grammar.from_text(f"{nt} -> {up} {nt} {down} | {up} {down}").to_cnf()
        rel[nt] = hellings_cfpq(one, g)[nt]
    lo = copy * off
    return {(i + lo, j + lo) for i, j in rel["G"] & rel["H"]}


def traced_call(eng, fn):
    """Run ``fn`` (one engine call) under :func:`run_phase`; returns (its
    result, the phase line's fields: wall and ``closure.execute`` ms, the
    ms from each closure call's start to its first iteration event (for a
    count closure: the support and divergence phases and one Jacobi
    iteration), closure calls, iterations, the kernels' launches, peak
    memory)."""
    first = len(eng.tracer.spans)
    out, ms, launches = run_phase(fn)
    spans = [s for s in eng.tracer.spans[first:] if s.name == "closure.execute"]
    return out, {
        "wall_ms": ms, "closure_execute_ms": span_ms(eng.tracer, first, "closure.execute"),
        "to_first_iteration_ms": 1e3 * sum(
            next(e["t"] for e in s.events if e["name"] == "iteration") - s.t_start
            for s in spans if any(e["name"] == "iteration" for e in s.events)),
        "closure_engine": [s.attrs["engine"] for s in spans],
        "closure_calls": sum(s.attrs.get("calls", 0) for s in spans),
        "iterations": sum(1 for s in spans for e in s.events if e["name"] == "iteration"),
        "launches": launches, "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def phase_conjunctive(dev) -> dict:
    """Conjunctive CFPQ at full width (BASE_GRAPH x PIZZA_COPIES) with the
    same-generation grammar: all pairs on dense and bitpacked, 256 sources
    on bitpacked and auto, Query 1 as a conjunctive grammar against the
    relational Query 1 pairs, an insert-only edit of copy 0 (repaired in
    place) and an edit with a delete (the state dropped), each against the
    oracle; then the a^n b^n c^n golden chain (n = 256) on both backends.
    Every call routed to bitpacked must launch ``bitmm``.  Returns the
    ``bitmm`` launches of the phase."""
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import Graph, paper_table_graph
    from repro_torch.engine import EngineConfig, Query, QueryEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    base = paper_table_graph(BASE_GRAPH)
    off = base.n_nodes
    graph = base.repeat(PIZZA_COPIES)
    cg = same_generation_grammar()
    t0 = time.perf_counter()
    one = conj_copy_oracle(base, 0, off)
    oracle = {(i + t * off, j + t * off) for t in range(PIZZA_COPIES) for i, j in one}
    emit("conjunctive_oracle", pairs_per_copy=len(one), pairs=len(oracle),
         nonterminals=len(cg.nonterms), conjuncts=sum(len(p) for _, p in cg.conj_prods),
         seconds=time.perf_counter() - t0)

    def engine_of(name, gr=graph):
        return QueryEngine(gr, config=EngineConfig(engine=name, device=str(dev)),
                           metrics=MetricsRegistry(), tracer=Tracer())

    calls, launches = {}, 0

    def serve(label, eng, queries, want):
        nonlocal launches
        outs, fields = traced_call(eng, lambda: eng.query_batch(queries))
        for q, r in zip(queries, outs):
            rows = want if q.sources is None else {p for p in want if p[0] in q.sources}
            check(r.pairs == rows, f"conjunctive {label}: pairs != oracle "
                  f"(sources {q.sources})")
        route = (outs[0].stats.planner or {}).get("label")
        if route is not None and route.startswith("bitpacked"):
            check(fields["launches"]["bitmm"] > 0,
                  f"conjunctive {label}: routed to {route} but bitmm never launched")
        launches += fields["launches"]["bitmm"]
        calls[label] = {"route": route, "cache": outs[0].stats.cache,
                        "pairs": sum(len(r.pairs) for r in outs), **fields}
        return outs

    all_pairs = [Query(cg, "S", semantics="conjunctive")]
    for backend in ("dense", "bitpacked"):
        eng = engine_of(backend)
        serve(f"allpairs_{backend}", eng, all_pairs, oracle)
        if backend == "dense":
            del eng
            torch.cuda.empty_cache()
    (st,) = eng._states.values()
    calls["allpairs_bitpacked"]["state_bytes"] = st.T.numel()
    sources = np.random.default_rng(5).choice(graph.n_nodes, CONJ_SOURCES, replace=False)
    batch = [Query(cg, "S", sources=(int(s),), semantics="conjunctive") for s in sources]
    for backend in ("bitpacked", "auto"):
        serve(f"batch_{backend}", engine_of(backend), batch, oracle)
    q1 = conjunctive_of(query1_grammar().to_cnf())
    serve("query1_bitpacked", engine_of("bitpacked"),
          [Query(q1, "S", semantics="conjunctive")], shifted_oracle())

    # edits of copy 0 on the cached all-pairs bitpacked state
    labels = ["subClassOf_r", "subClassOf", "type_r", "type"]
    rng = np.random.default_rng(9)
    inserts = [(int(rng.integers(off)), labels[int(rng.integers(4))],
                int(rng.integers(off))) for _ in range(3)]
    edits = {}
    for label, insert, delete in (
            ("insert", inserts, []),
            ("delete", [], [e for e in graph.edges if e[0] < off][:2])):
        first = len(eng.tracer.spans)
        dst, ms, dl = run_phase(lambda: eng.apply_delta(insert=insert, delete=delete))
        want = {p for p in oracle if p[0] >= off} | conj_copy_oracle(graph, 0, off)
        if label == "insert":
            check(dst.conj_repairs == 1 and dst.conj_drops == 0,
                  f"conjunctive insert-only edit: {dst}")
            check(dl["bitmm"] > 0, "the conjunctive repair never launched bitmm")
        else:
            check(dst.conj_drops == 1 and dst.conj_repairs == 0,
                  f"conjunctive edit with a delete: {dst}")
        edits[label] = {"apply_delta_ms": ms, "launches": dl,
                        "repair_closure_execute_ms": span_ms(eng.tracer, first,
                                                             "closure.execute"),
                        **dst.as_dict()}
        launches += dl["bitmm"]
        outs = serve(f"after_{label}", eng, all_pairs, want)
        check(outs[0].stats.cache == ("hit" if label == "insert" else "miss"),
              f"conjunctive after the {label} edit: cache {outs[0].stats.cache}")
        oracle = want
    del eng, st
    torch.cuda.empty_cache()

    # the golden chain: exactly the pair (0, 3n) is in {a^n b^n c^n}
    word = "a" * ANBNCN + "b" * ANBNCN + "c" * ANBNCN
    chain = Graph(len(word) + 1, [(i, ch, i + 1) for i, ch in enumerate(word)])
    abc = anbncn_grammar()
    for backend in ("dense", "bitpacked"):
        serve(f"anbncn_{backend}", engine_of(backend, chain),
              [Query(abc, "S", semantics="conjunctive")], {(0, len(word))})
    emit("conjunctive", n=graph.n_nodes, calls=calls, edits=edits, bitmm_launches=launches,
         golden={"n": ANBNCN, "pairs": [[0, len(word)]]})
    torch.cuda.empty_cache()
    return launches


def count_copy_oracle(base, g) -> tuple[dict, int]:
    """Path counts of Query 1's S on one copy: the int64 Jacobi iteration
    of C = C0 + sum over A -> B C of C[B] C[C] with scipy.sparse, from C0
    (one per edge and derived label) to its fixpoint.  Returns ({(i, j):
    count}, iterations); fails if it does not converge."""
    import scipy.sparse as sp

    n = base.n_nodes
    C0 = []
    for a in range(g.n_nonterms):
        ij = [(i, j) for i, x, j in base.edges if a in g.term_prods.get(x, ())]
        rows, cols = zip(*ij) if ij else ((), ())
        C0.append(sp.csr_matrix((np.ones(len(ij), np.int64), (rows, cols)), shape=(n, n)))
    C = C0
    for it in range(1, 1000):
        nxt = []
        for a in range(g.n_nonterms):
            m = C0[a].copy()
            for pa, b, c in g.binary_prods:
                if pa == a:
                    m = m + C[b] @ C[c]
            nxt.append(m.tocsr())
        if all((x != y).nnz == 0 for x, y in zip(nxt, C)):
            break
        C = nxt
    else:
        raise AssertionError("the count oracle's Jacobi did not converge")
    S = C[g.index_of("S")].tocoo()
    return {(int(i), int(j)): int(v) for i, j, v in zip(S.row, S.col, S.data) if v}, it


def random_counts(gen, shape, nonzero: float, kind: str, dev) -> torch.Tensor:
    """uint32 counts in int32 storage (see COUNT_KINDS), 0 outside a share
    ``nonzero`` of the entries."""
    from repro_torch.kernels.ref import as_storage

    if kind == "small":
        x = torch.randint(1, 50, shape, generator=gen, device=dev)
    elif kind == "2^16":
        x = torch.randint(2**16 - 40, 2**16 + 40, shape, generator=gen, device=dev)
    else:
        x = torch.full(shape, SAT, dtype=torch.int64, device=dev)
    keep = torch.rand(shape, generator=gen, device=dev) < nonzero
    return as_storage(torch.where(keep, x, 0))


def phase_count_checks(dev) -> int:
    """The count kernel against its plain version, ``torch.equal``: every
    shape of MINPLUS_SHAPES at non-zero shares 1e-4, 1e-2 and 1, with a
    quarter of the lhs rows zero, values small, near 2^16 (the products
    pass 2^32) or SAT (COUNT_KINDS, in turn); each plain, in the index form
    (rhs rows of a larger base named by a permuted slab index and a
    repeated, unsorted row index) and in the acc form.  Returns the cases."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    cases = 0
    for si, (P, R, K, C) in enumerate(MINPLUS_SHAPES):
        for di, d in enumerate(MINPLUS_DENSITIES):
            kind = COUNT_KINDS[(si + di) % len(COUNT_KINDS)]
            lhs = random_counts(gen, (P, R, K), d, kind, dev)
            lhs[:, ::4] = 0  # rows without a non-zero entry
            rhs = random_counts(gen, (P, K, C), 0.5, kind, dev)
            base = random_counts(gen, (P + 1, K + 3, C), 0.5, kind, dev)
            slab = torch.randperm(P + 1, generator=gen, device=dev)[:P]
            row = torch.randint(0, K + 3, (K,), generator=gen, device=dev)
            acc = random_counts(gen, (P, R, C), 0.3, kind, dev)
            for form, args, kwargs in three_forms(lhs, rhs, base, slab, row, acc):
                got = ops.count_mm(*args, **kwargs)
                check(torch.equal(got, ref.count_mm_ref(*args, **kwargs)),
                      f"count_mm != its plain version: {(P, R, K, C)}, "
                      f"non-zero {d}, {kind}, {form}")
                cases += 1
            del lhs, rhs, base, acc
    for ci, case in enumerate(SPARSE_ROW_CASES):
        kind = COUNT_KINDS[ci % len(COUNT_KINDS)]
        lhs, base, slab, row, acc = sparse_row_operands(
            gen, case, lambda shape, d: random_counts(gen, shape, d, kind, dev),
            0, -1, dev)  # -1: SAT in int32 storage
        rhs = base[slab][:, row].contiguous()
        for form, args, kwargs in three_forms(lhs, rhs, base, slab, row, acc):
            got = ops.count_mm(*args, **kwargs)
            check(torch.equal(got, ref.count_mm_ref(*args, **kwargs)),
                  f"count_mm != its plain version: {case}, {kind}, {form}")
            cases += 1
        del lhs, rhs, base, acc
    torch.cuda.synchronize()
    emit("count_checks", kernel="count_mm", cases=cases, max_abs_err=0,
         shapes=[list(x) for x in MINPLUS_SHAPES], densities=MINPLUS_DENSITIES,
         sparse_row_cases=[c[0] for c in SPARSE_ROW_CASES],
         kinds=COUNT_KINDS, tolerance="bit equality (torch.equal)")
    return cases


def count_bound(lhs, base, slab, row, acc) -> dict:
    """Least time of ``ops.count_mm(lhs, base, slab, row, acc)``: the
    larger of bytes over HBM and operations (a multiply and an add per
    non-zero lhs entry per output column) over the int32 rate, counting
    what the inputs need: the lhs, acc and the output once, and of the rhs
    only the rows (slab[p], row[k]) that some non-zero lhs entry names."""
    P, R, K = lhs.shape
    C = base.shape[-1]
    nz = lhs != 0
    nnz = int(nz.sum())
    keys = (slab[:, None] * base.shape[1] + row[None, :])[nz.any(dim=1)]
    rhs_rows = int(torch.unique(keys).numel())
    n_bytes = 4 * (lhs.numel() + rhs_rows * C + 2 * P * R * C)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * nnz * C / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "nonzero_lhs": nnz, "rhs_rows_read": rhs_rows}


def count_mm_timing(label: str, state, baseline=None) -> dict:
    """One Jacobi product of the count closure on a served state, as the
    closure makes it: the production whose lhs has the most non-zero
    entries, lhs (1, R, R) the active block of its B plane, rhs the rows of
    its C plane of the state named in place, acc its LHS's base rows.
    Checked against the plain version (on the first 64 rows when R is
    larger than 1,024, where the plain version would take minutes) and
    against a float64 ``torch.matmul`` of the same operands (exact while
    every sum stays below 2^53); timed: one call, device time of launches
    back to back, the plain version (on the 64 rows past R = 1,024), the
    float64 matmul (the library yardstick, which the port never calls).
    With ``baseline`` (another revision's count library) its device time on
    the same operands too (:func:`with_baseline`)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.count_mm import count_mm_launch

    C, tables = state.cnt_C, state.tables
    idx = torch.from_numpy(np.nonzero(state.cnt_mask)[0]).to(C.device)
    b_idx, c_idx = tables.index_tensors(C.device)
    nnz = [int((C[b][idx][:, idx] != 0).sum()) for b in tables.b_idx]
    p = int(np.argmax(nnz))
    lhs = C[b_idx[p]][idx][:, idx][None].contiguous()
    slab = c_idx[p:p + 1]
    acc = state.cnt_base[tables.a_idx[p]][idx][None].contiguous()
    R = lhs.shape[1]
    out = ops.count_mm(lhs, C, slab, idx, acc)
    rows = slice(None) if R <= 1024 else slice(0, 64)
    plain_args = (lhs[:, rows].contiguous(), C, slab, idx, acc[:, rows].contiguous())
    want = ref.count_mm_ref(*plain_args)
    check(torch.equal(out[:, rows], want), f"count_mm != its plain version on the "
          f"{label} state")
    L64 = ref.as_unsigned(lhs).double()
    R64 = ref.as_unsigned(C[slab][:, idx]).double()
    got64 = (torch.matmul(L64, R64) + ref.as_unsigned(acc)).clamp(max=SAT).long()
    check(torch.equal(ref.as_storage(got64), out), f"the float64 matmul != count_mm "
          f"on the {label} state")
    del got64
    bnd = count_bound(lhs, C, slab, idx, acc)
    row = {
        "name": "count_mm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/count_mm.cu",
        "replaces": "src/repro/core/semantics.py:695",
        "launches": None, "max_abs_err": 0,
        "ms": time_ms(lambda: ops.count_mm(lhs, C, slab, idx, acc), reps=10, warmup=2),
        "plain_ms": time_ms(lambda: ref.count_mm_ref(*plain_args), reps=2),
        "plain_rows": R if R <= 1024 else 64,
        "bound_ms": bnd.pop("bound_ms"), "bound_by": bnd.pop("bound_by"),
        "library_ms": time_ms(lambda: torch.matmul(L64, R64), reps=5),
        "ms_device": device_ms(lambda: count_mm_launch(lhs, C, slab, idx, acc, out),
                               reps=20),
        "shape": label, "production": p, "R": R, "K": R, "C": C.shape[-1], **bnd,
    }
    with_baseline(row, lambda: count_mm_launch(lhs, C, slab, idx, acc, out), 20,
                  baseline, "repro_count_mm", lhs, C, slab, idx, acc, out)
    del lhs, acc, out, L64, R64
    torch.cuda.empty_cache()
    emit("count_mm_timing", **row)
    return row


def count_paths(eng, g, counts: dict, pairs, max_len: int) -> dict:
    """``engine.extract_paths`` on ``pairs`` with k = 10: each path a
    distinct walk whose word the grammar derives (CYK), at most ``max_len``
    edges, as many as min(k, count)."""
    from repro_torch.engine import Query

    t0 = time.perf_counter()
    eng.query(Query(g, "S", sources=tuple(sorted({i for i, _ in pairs}))))
    edges = set(eng.graph.edges)
    found = {}
    for i, j in pairs:
        paths = eng.extract_paths(g, "S", i, j, k=10, max_len=max_len)
        check(len(paths) == min(10, counts[(i, j)]),
              f"extract_paths ({i}, {j}): {len(paths)} paths, count {counts[(i, j)]}")
        check(len({tuple(p) for p in paths}) == len(paths), "repeated paths")
        for path in paths:
            check(path[0][0] == i and path[-1][2] == j and len(path) <= max_len,
                  f"extract_paths ({i}, {j}): a path ends wrong or is too long")
            check(all(e in edges for e in path)
                  and all(a[2] == b[0] for a, b in zip(path, path[1:])),
                  f"extract_paths ({i}, {j}): not a walk")
            check(cyk_derives(g, "S", [x for _, x, _ in path]),
                  f"extract_paths ({i}, {j}): word not derived from S")
        found[f"{i},{j}"] = [len(paths), counts[(i, j)]]
    return {"pairs": found, "k": 10, "max_len": max_len,
            "seconds": time.perf_counter() - t0}


def phase_count(dev, baseline=None) -> tuple[int, list[dict]]:
    """Count CFPQ at full width (BASE_GRAPH x PIZZA_COPIES, Query 1): all
    pairs through the engine (the count state is (7, n, n) int32), a
    16-source batch in copy 0, the all-pairs query pinned to bitpacked
    (which must hit the collapsed dense plan); counts against a scipy
    Jacobi on one copy, shifted, and the support against Hellings.  Then
    an insert-only edit of copy 0 (recounted, against a fresh engine), an
    edit with a delete (dropped), the saturation golden cases, bounded
    all-path enumeration on 8 pairs of copy 0, and one count product timed
    at each shape (:func:`count_mm_timing`, beside ``baseline``: another
    revision's count library).  Every closure must launch ``count_mm``.
    Returns (its launches, the timing rows)."""
    from repro_torch.core.grammar import Grammar, query1_grammar
    from repro_torch.core.graph import Graph, paper_table_graph
    from repro_torch.engine import CompiledClosureCache, EngineConfig, Query, QueryEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    g = query1_grammar().to_cnf()
    base = paper_table_graph(BASE_GRAPH)
    off = base.n_nodes
    graph = base.repeat(PIZZA_COPIES)
    t0 = time.perf_counter()
    one, iters = count_copy_oracle(base, g)
    oracle = {(i + t * off, j + t * off): c
              for t in range(PIZZA_COPIES) for (i, j), c in one.items()}
    check(set(oracle) == shifted_oracle(), "the count oracle's support != Hellings")
    emit("count_oracle", iterations=iters, pairs_per_copy=len(one),
         paths_per_copy=sum(one.values()), max_count=max(one.values()),
         seconds=time.perf_counter() - t0)
    plans = CompiledClosureCache()

    def engine_of(name, gr=None):  # a pristine graph unless one is given
        gr = gr if gr is not None else base.repeat(PIZZA_COPIES)
        return QueryEngine(gr, plans=plans, config=EngineConfig(engine=name, device=str(dev)),
                           metrics=MetricsRegistry(), tracer=Tracer())

    calls, launches, rows = {}, 0, []

    def serve(label, eng, queries, want):
        nonlocal launches
        outs, fields = traced_call(eng, lambda: eng.query_batch(queries))
        for q, r in zip(queries, outs):
            part = want if q.sources is None else {
                k: v for k, v in want.items() if k[0] in q.sources}
            check(r.counts == part, f"count {label}: counts != the oracle")
        if outs[0].stats.cache != "hit":
            check(fields["launches"]["count_mm"] > 0, f"count {label}: no count_mm launch")
        launches += fields["launches"]["count_mm"]
        (st,) = [s for s in eng._states.values() if s.cnt_C is not None]
        calls[label] = {"route": (outs[0].stats.planner or {}).get("label"),
                        "cache": outs[0].stats.cache, "active_rows": int(st.cnt_mask.sum()),
                        "state_bytes": st.cnt_C.numel() * 4, **fields}
        return st

    # 1. all pairs (dense), then the product timed on its state, then edits
    eng = engine_of("dense", graph)
    st = serve("allpairs_dense", eng, [Query(g, "S", semantics="count")], oracle)
    check(tuple(st.cnt_C.shape) == (g.n_nonterms, eng.n, eng.n), "count state shape")
    check(state_equals_mirror(st.cnt_C, st.cnt_C_host), "count host mirror != device")
    rows.append(count_mm_timing("allpairs", st, baseline))
    labels = sorted(g.term_prods)
    rng = np.random.default_rng(13)
    inserts = [(int(rng.integers(off)), labels[int(rng.integers(len(labels)))],
                int(rng.integers(off))) for _ in range(3)]
    keep = st.cnt_C[:, off:, :].clone()
    edits = {}
    dst, ms, dl = run_phase(lambda: eng.apply_delta(insert=inserts))
    check(dst.count_repairs == 1 and dst.count_drops == 0, f"count insert edit: {dst}")
    check(dl["count_mm"] > 0, "the count recount never launched count_mm")
    launches += dl["count_mm"]
    edits["insert"] = {"apply_delta_ms": ms, "launches": dl, **dst.as_dict()}
    (st,) = eng._states.values()
    check(torch.equal(st.cnt_C[:, off:, :], keep), "count rows outside copy 0 changed")
    del keep
    check(state_equals_mirror(st.cnt_C, st.cnt_C_host),
          "count host mirror != device after the recount")
    fresh = engine_of("dense", Graph(graph.n_nodes, list(graph.edges)))
    copy0 = tuple(range(off))
    want = fresh.query(Query(g, "S", sources=copy0, semantics="count")).counts
    del fresh
    torch.cuda.empty_cache()
    got = eng.query(Query(g, "S", semantics="count"))
    check(got.stats.cache == "hit", "count after the insert edit: not a hit")
    check({k: v for k, v in got.counts.items() if k[0] < off} == want,
          "the recount != a fresh engine's counts on copy 0")
    check({k: v for k, v in got.counts.items() if k[0] >= off}
          == {k: v for k, v in oracle.items() if k[0] >= off},
          "the recount changed counts outside copy 0")
    dst, ms, dl = run_phase(lambda: eng.apply_delta(delete=[e for e in graph.edges
                                                             if e[0] < off][:2]))
    check(dst.count_drops == 1 and dst.count_repairs == 0, f"count delete edit: {dst}")
    edits["delete"] = {"apply_delta_ms": ms, "launches": dl, **dst.as_dict()}
    check(not any(s.cnt_C is not None for s in eng._states.values()),
          "the delete left a count state")
    del eng, st
    torch.cuda.empty_cache()

    # 2. the same query pinned to bitpacked: the collapsed dense plan, a hit
    hits = plans.stats.compile_hits
    eng = engine_of("bitpacked")
    serve("allpairs_bitpacked", eng, [Query(g, "S", semantics="count")], oracle)
    check(plans.stats.compile_hits > hits, "pinned bitpacked built a count plan of its own")
    check({k.engine for k in plans._exe if k.semantics == "count"} == {"dense"},
          "a count plan keyed under another backend than dense")
    del eng
    torch.cuda.empty_cache()

    # 3. a 16-source batch in copy 0 (auto), its product timed, all paths
    eng = engine_of("auto")
    srcs = np.random.default_rng(3).choice(off, size=COUNT_SOURCES, replace=False)
    st = serve("batch_auto", eng,
               [Query(g, "S", sources=(int(s),), semantics="count") for s in srcs], oracle)
    check(calls["batch_auto"]["route"] == "dense:masked+count",
          f"auto routed a count batch to {calls['batch_auto']['route']}")
    rows.append(count_mm_timing(f"batch{COUNT_SOURCES}", st, baseline))
    top = sorted(one, key=lambda k: -one[k])[:4]
    rest = [k for k in sorted(one) if k not in top]
    picks = top + [rest[int(i)] for i in np.random.default_rng(4).choice(
        len(rest), 4, replace=False)]
    paths = count_paths(eng, g, one, picks, max_len=2 * iters + 2)
    del eng, st
    torch.cuda.empty_cache()

    # 4. the saturation golden: a cycle admits unboundedly many paths
    lin = Grammar.from_text("S -> a S | a").to_cnf()
    golden = {}
    for name, edges, want in (
            ("loop", [(0, "a", 0)], {(0, 0): SAT}),
            ("cycle", [(0, "a", 1), (1, "a", 0)],
             {(i, j): SAT for i in (0, 1) for j in (0, 1)}),
            ("sticky", [(0, "a", 0), (0, "a", 1), (1, "a", 2)],
             {(0, 0): SAT, (0, 1): SAT, (0, 2): SAT, (1, 2): 1})):
        gr = Graph(1 + max(max(i, j) for i, _, j in edges), edges)
        serve(f"saturation_{name}", engine_of("dense", gr),
              [Query(lin, "S", semantics="count")], want)
        golden[name] = {f"{i},{j}": v for (i, j), v in want.items()}
    for row in rows:
        row["launches"] = launches
    emit("count", n=graph.n_nodes, calls=calls, edits=edits, all_paths=paths,
         saturation=golden, count_mm_launches=launches)
    return launches, rows


# ---------------------------------------------------------------------- #
# the sharded opt family on a one-rank NCCL world
# ---------------------------------------------------------------------- #

OPT_BATCH = 256  # single-source relational queries of the opt batch


def opt_mesh(dev):
    """A one-rank NCCL world and its 1 x 1 (data, model) device mesh: every
    collective of the opt closures runs, trivially (NCCL takes one rank
    per card, and this run has one card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def exchange_words() -> dict:
    """4-byte words each exchange sent (``shard.exchanged`` counts bytes;
    the ``opt`` exchanges move int32 words or f32 lengths)."""
    from repro_torch.shard import plans

    return {k: v // 4 for k, v in plans.exchanged.items()}


def per_iteration(words: dict, calls: dict) -> dict:
    """Words each exchange sent per closure iteration (``any_world`` runs
    once an iteration)."""
    its = max(calls.get("any_world", 0), 1)
    return {k: v / its for k, v in sorted(words.items())}


def phase_opt(dev) -> dict:
    """The ``opt`` family at full width (pizza x 16, n = 15,872, Query 1) in
    a one-rank NCCL world: ``opt_closure`` with ``plan=None`` and with the
    1 x 1 mesh, word-equal to ``bitpacked_closure``'s state and to the
    shifted Hellings oracle; then ``QueryEngine(engine="opt", mesh=...)``:
    all pairs (its state word-equal to a bitpacked engine's), the
    256-source batch, 16 single-path queries in copy 0 (witnesses by CYK),
    seeded edits in copies 0 and 1 through ``apply_delta`` (pairs against
    Hellings and the bitpacked engine's repaired state, rows of the other
    copies bit-identical), then single-path queries in copy 2 that shard
    the repaired state again.  Prints wall and ``closure.execute`` ms per
    call, launches, the words each exchange moved per iteration, the
    placement around the edit and peak memory.  Every relational closure
    must launch ``bitmm``, the single-path batch ``minplus``.  Returns the
    phase's launches of ``bitmm``, ``bitmm_or`` and ``minplus``."""
    from repro_torch.core import closure
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import Graph, paper_table_graph
    from repro_torch.core.matrices import (
        ProductionTables, init_matrix, pack_bits, relations_from_matrix,
    )
    from repro_torch.delta.repair import placement_of
    from repro_torch.engine import EngineConfig, Query, QueryEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.shard import plans as shard

    t0 = time.perf_counter()
    mesh = opt_mesh(dev)
    plan = shard.MeshPlan.from_mesh(mesh)
    setup_ms = (time.perf_counter() - t0) * 1e3
    g = query1_grammar().to_cnf()
    a0 = g.index_of("S")
    tables = ProductionTables.from_grammar(g)
    off = paper_table_graph(BASE_GRAPH).n_nodes
    graph = paper_table_graph(BASE_GRAPH).repeat(PIZZA_COPIES)
    oracle = shifted_oracle()
    total = {"bitmm": 0, "bitmm_or": 0, "minplus": 0}

    def count(launches):
        for k in total:
            total[k] += launches[k]
        return launches

    # 1. the all-pairs closure, without and with the mesh, against the
    #    bitpacked closure's words and Hellings; each returns the whole
    #    bool state (the mesh's gathered), timed twice in turns
    # the state's construction, timed apart: the main path's
    # closure_bitpacked time holds it and that function's first call
    T0, init_ms, _ = run_phase(lambda: init_matrix(graph, g, device=dev))
    plans = {"bitpacked_closure": None, "plan_none": None, "mesh_1x1": plan}
    want = None
    closures = {label: {"wall_ms": []} for label in plans}
    for label in list(plans) + list(plans)[::-1]:
        p = plans[label]

        def run():
            shard.reset_exchanges()
            if label == "bitpacked_closure":
                return closure.bitpacked_closure(T0, tables), {}
            out = closure.opt_closure(T0, tables, plan=p)
            if p is None:
                return out, {}
            calls, words = dict(shard.exchange_calls), exchange_words()
            return out.full(), per_iteration(words, calls) | {
                "iterations": calls.get("any_world", 0)}

        (full, words), ms, launches = run_phase(run)
        words_of = pack_bits(full)
        want = words_of if want is None else want
        check(torch.equal(words_of, want), f"{label} != bitpacked_closure's words")
        check(relations_from_matrix(full, g, graph.n_nodes)["S"] == oracle,
              f"{label} != shifted Hellings")
        check(launches["bitmm"] > 0, f"{label} never launched bitmm")
        if label != "bitpacked_closure":  # the opt path's launches only
            count(launches)
        row = closures[label]
        row["wall_ms"].append(ms)
        row.update(bitmm_launches=launches["bitmm"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   **({"exchange_words_per_iteration": words} if words else {}))
        del full, words_of
    del T0, want
    torch.cuda.empty_cache()
    emit("opt_closure", n=graph.n_nodes, nccl_setup_ms=setup_ms,
         init_matrix_ms=init_ms,
         mesh={"data": plan.data_size, "model": plan.model_size}, **closures)

    def engine_of(name, gr=graph, m=mesh):
        return QueryEngine(
            gr, config=EngineConfig(engine=name, device=str(dev), mesh=m),
            metrics=MetricsRegistry(), tracer=Tracer(iteration_events=False),
        )

    def call(eng, fn):
        """One engine call: wall and closure ms, launches, exchanges."""
        first = len(eng.tracer.spans)
        shard.reset_exchanges()
        out, ms, launches = run_phase(fn)
        count(launches)
        return out, {
            "wall_ms": ms,
            "closure_execute_ms": span_ms(eng.tracer, first, "closure.execute"),
            "host_copy_ms": span_ms(eng.tracer, first, "closure.host_copy"),
            "launches": {k: launches[k] for k in total},
            "iterations": shard.exchange_calls.get("any_world", 0),
            "exchange_words": exchange_words(),
            "exchange_words_per_iteration": per_iteration(
                exchange_words(), shard.exchange_calls),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
        }

    report = {}
    # 2. the 256-source batch on its own engine
    eng = engine_of("opt")
    sources = np.random.default_rng(0).choice(graph.n_nodes, size=OPT_BATCH,
                                              replace=False).tolist()
    outs, report["batch"] = call(eng, lambda: eng.query_batch(
        [Query(g, "S", sources=(int(s),)) for s in sources]))
    for s, r in zip(sources, outs):
        check(r.pairs == {p for p in oracle if p[0] == s}, f"opt batch: source {s}")
    check(report["batch"]["launches"]["bitmm"] > 0, "the opt batch never launched bitmm")
    report["batch"]["route"] = outs[0].stats.planner["label"]
    del eng, outs

    # 3. all pairs, single path, an edit, a query that shards again
    eng = engine_of("opt")
    res, report["allpairs"] = call(eng, lambda: eng.query(Query(g, "S")))
    check(res.pairs == oracle, "opt all pairs != shifted Hellings")
    check(report["allpairs"]["launches"]["bitmm"] > 0, "opt all pairs never launched bitmm")
    (st,) = eng._states.values()
    report["allpairs"]["state"] = type(st.T).__name__
    bp = engine_of("bitpacked", m=None)
    bp.query(Query(g, "S"))
    (bst,) = bp._states.values()
    check(torch.equal(pack_bits(st.T.full()), pack_bits(bst.T)),
          "the opt engine's state != the bitpacked engine's")
    check(np.array_equal(st.T_host, bst.T_host), "the opt host mirror != bitpacked's")

    picks = np.random.default_rng(3).choice(off, size=SP_SOURCES, replace=False)
    edges = set(graph.edges)
    sp_oracle = _copy_oracle(graph, g, 0, off)
    outs, report["single_path"] = call(eng, lambda: eng.query_batch(
        [Query(g, "S", sources=(int(s),), semantics="single_path") for s in picks]))
    (st,) = eng._states.values()
    n_paths = 0
    for s, r in zip(picks, outs):
        check(r.pairs == {p for p in sp_oracle if p[0] == s}, f"opt single path: {s}")
        for (i, j), path in r.paths.items():
            check_witness(edges, g, i, j, path, int(st.sp_L_host[a0, i, j]),
                          f"opt single path ({i}, {j})")
            n_paths += 1
    check(report["single_path"]["launches"]["minplus"] > 0,
          "the opt single-path batch never launched minplus")
    report["single_path"]["witnesses"] = n_paths
    check(state_equals_mirror(st.sp_L.full(), st.sp_L_host),
          "the opt single-path mirror != its sharded state")

    frozen_rows = np.arange(2 * off, PIZZA_COPIES * off)
    keep_T = st.T_host[:, frozen_rows, :].copy()
    keep_L = st.sp_L_host[:, frozen_rows, :].copy()
    placement = {"before": {"relational": st.placement, "single_path": st.sp_placement,
                            "state": type(st.T).__name__}}
    delete, insert = _seeded_edits(np.random.default_rng(7), graph, g, off)
    dst, report["apply_delta"] = call(
        eng, lambda: eng.apply_delta(insert=insert, delete=delete))
    (st,) = eng._states.values()
    placement["after_edit"] = {"relational": st.placement,
                               "single_path": st.sp_placement,
                               "state": type(st.T).__name__}
    report["apply_delta"].update(dst.as_dict())
    check(dst.rows_repaired > 0 and dst.rows_evicted > 0, f"the opt edit: {dst}")
    bp.apply_delta(insert=insert, delete=delete)
    (bst,) = bp._states.values()
    M = st.mask
    check(np.array_equal(st.T_host[:, M, :], bst.T_host[:, M, :]),
          "the opt engine's repaired rows != the bitpacked engine's")
    check(np.array_equal(st.T_host[:, frozen_rows, :], keep_T),
          "the opt edit changed rows of the other copies")
    check(np.array_equal(st.sp_L_host[:, frozen_rows, :], keep_L),
          "the opt edit changed length rows of the other copies")
    untouched = {(i, j) for i, j in oracle if i >= 2 * off}
    want_pairs = untouched | _copy_oracle(graph, g, 0, off) | _copy_oracle(graph, g, 1, off)
    res, report["allpairs_after_edit"] = call(eng, lambda: eng.query(Query(g, "S")))
    check(res.pairs == want_pairs, "opt all pairs after the edit != Hellings")
    del bp, bst, keep_T, keep_L

    # single-path queries in copy 2 need new rows: the closure shards the
    # repaired state again
    again = [int(s) + 2 * off for s in picks]
    edges = set(graph.edges)
    outs, report["single_path_after_edit"] = call(eng, lambda: eng.query_batch(
        [Query(g, "S", sources=(s,), semantics="single_path") for s in again]))
    (st,) = eng._states.values()
    for s, r in zip(again, outs):
        check(r.pairs == {p for p in want_pairs if p[0] == s},
              f"opt single path after the edit: {s}")
        for (i, j), path in r.paths.items():
            check_witness(edges, g, i, j, path, int(st.sp_L_host[a0, i, j]),
                          f"opt single path after the edit ({i}, {j})")
    placement["after_query"] = {"relational": st.placement,
                                "single_path": st.sp_placement,
                                "sp_state": type(st.sp_L).__name__,
                                "placement_of": placement_of(st.sp_L)}
    check(placement["after_query"]["sp_state"] == "ShardedState",
          "the query after the edit did not shard the length state again")
    emit("opt_engine", n=graph.n_nodes, calls=report, placement=placement,
         launches=total, plan_keys=sorted(
             f"{k.semantics}:{k.engine}:{k.row_capacity}:{'repair' if k.repair else ''}"
             f":{k.mesh}" for k in eng.plans._exe))
    del eng, st, outs, res
    torch.cuda.empty_cache()
    import torch.distributed as dist

    dist.destroy_process_group()
    return total


# ---------------------------------------------------------------------- #
# the planner's calibration on the card, and the fitted profile against
# the defaults on the main path's auto calls
# ---------------------------------------------------------------------- #

CAL_SIZES = (1024, 4096)  # the calibration grid: sizes x CAL_SOURCES
CAL_SOURCES = (1, 4, 16)
# and, per semantics, all pairs ("n") and the main path's n at 1 and 16
# sources.  All pairs: single path only at n = 1,024, because at 4,096 its
# witness extraction on the host took 39 s a point; none at 15,872 (the
# single-path state alone would be 7 GB)
CAL_EXTRA = (
    ((1024, 4096), ("n",), ("relational",)),
    ((1024,), ("n",), ("single_path",)),
    ((15872,), (1, 16), ("relational", "single_path")),
)
CAL_BACKENDS = ("dense", "frontier", "bitpacked")
CAL_BATCH = 256  # the main path's auto batch: phase_main_path's sources


def calibration_tool():
    """tools/calibrate_planner_torch.py of this checkout, loaded by path."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "calibrate_planner_torch.py"
    spec = importlib.util.spec_from_file_location("calibrate_planner_torch", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def phase_calibrate(dev) -> dict:
    """The planner's calibration on the card: the tool's ``calibrate()``
    over CAL_SIZES x CAL_SOURCES and, through its ``extra`` grids, all
    pairs (single path at n = 1,024 only) and the main path's n = 15,872
    at 1 and 16 sources; the round trip of the saved
    profile; the fitted coefficients beside the defaults; the canonical
    grid's decisions that the fitted profile routes differently.  Then the
    main path's 256-source ``auto`` batch and the ``auto`` ``apply_delta``
    (copies 0 and 1, seed 7, as ``phase_delta``) under the defaults and the
    fitted profile in turns (default, fitted, fitted, default), each
    pair set equal to a pinned bitpacked engine's, which launches
    ``bitmm`` and, in its repair, ``bitmm_or``; its edited pairs equal
    Hellings.  Returns the phase's launches of ``bitmm``,
    ``bitmm_or`` and ``minplus``."""
    import tempfile

    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import paper_table_graph
    from repro_torch.engine import EngineConfig, PlannerProfile, Query, QueryEngine
    from repro_torch.engine.planner import _DEFAULT_COEF
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    t_phase = time.perf_counter()
    tool = calibration_tool()
    total = {"bitmm": 0, "bitmm_or": 0, "minplus": 0}

    def count(launches):
        for k in total:
            total[k] += launches[k]
        return launches

    log: list[str] = []
    profile, fit_ms, launches = run_phase(lambda: tool.calibrate(
        list(CAL_SIZES), list(CAL_SOURCES), list(CAL_BACKENDS),
        device=str(dev), log=log.append, extra=CAL_EXTRA))
    count(launches)
    check(launches["bitmm"] > 0, "the bitpacked family's fit never launched bitmm")
    check(launches["minplus"] > 0, "the single-path families' fit never launched minplus")
    with tempfile.TemporaryDirectory() as tmp:
        round_trip = tool.verify_round_trip(profile, profile.save(Path(tmp) / "p.json"))
    check(round_trip, "the saved and reloaded profile decides differently")
    defaults = PlannerProfile()
    changed = [
        {"n": f.n, "seed_rows": f.seed_rows, "semantics": f.semantics,
         "mesh_devices": f.mesh_devices, "default": a["label"], "fitted": b["label"]}
        for f, a, b in zip(tool.grid_features(), tool.decision_grid(defaults),
                           tool.decision_grid(profile))
        if a["label"] != b["label"]
    ]
    emit("calibrate", sizes=list(CAL_SIZES), sources=list(CAL_SOURCES),
         extra=[[list(part) for part in grid] for grid in CAL_EXTRA],
         fit_seconds=fit_ms / 1e3, host=profile.host,
         coef={k: {"fitted": list(profile.coef[k]), "default": list(ab)}
               for k, ab in _DEFAULT_COEF.items()},
         clamped=[line for line in log if "clamped" in line],
         points=[line for line in log if " n=" in line],
         reach_factor=profile.reach_factor, default_reach_factor=defaults.reach_factor,
         round_trip="OK", routes_changed=len(changed),
         grid_decisions=len(tool.grid_features()), changed=changed,
         launches=launches)

    g = query1_grammar().to_cnf()
    off = paper_table_graph(BASE_GRAPH).n_nodes
    graph = paper_table_graph(BASE_GRAPH).repeat(PIZZA_COPIES)
    sources = np.random.default_rng(0).choice(graph.n_nodes, size=CAL_BATCH,
                                              replace=False).tolist()
    batch = [Query(g, "S", sources=(int(s),)) for s in sources]
    untouched = {(i, j) for i, j in shifted_oracle() if i >= 2 * off}

    def engine_of(gr, name, prof=None):
        return QueryEngine(
            gr, config=EngineConfig(engine=name, device=str(dev), profile=prof),
            metrics=MetricsRegistry(), tracer=Tracer(iteration_events=False),
        )

    def batch_run(name, prof=None):
        eng = engine_of(graph, name, prof)
        outs, ms, launches = run_phase(lambda: eng.query_batch(batch))
        route = outs[0].stats.planner["label"]
        check_route_launched((outs[0].stats.fallback or {}).get("to", route),
                             count(launches), f"calibrate batch on {name}")
        return [o.pairs for o in outs], {
            "route": route, "wall_ms": ms, "launches": launches,
            "candidates": outs[0].stats.planner["candidates"]}

    def delta_run(name, prof=None):
        """A warm all-pairs state, then the seeded edits of phase_delta."""
        gr = paper_table_graph(BASE_GRAPH).repeat(PIZZA_COPIES)
        eng = engine_of(gr, name, prof)
        warm, warm_ms, launches = run_phase(lambda: eng.query(Query(g, "S")))
        count(launches)
        delete, insert = _seeded_edits(np.random.default_rng(7), gr, g, off)
        first = len(eng.tracer.spans)
        st, ms, launches = run_phase(lambda: eng.apply_delta(insert=insert, delete=delete))
        repairs = [s.attrs["engine"] for s in eng.tracer.spans[first:]
                   if s.name == "closure.execute" and s.attrs.get("repair")]
        for route in repairs:  # a packed repair launches bitmm_or
            if route == "bitpacked":
                check(launches["bitmm_or"] > 0, f"calibrate: the {name} repair "
                      "routed to bitpacked never launched bitmm_or")
        count(launches)
        res = eng.query(Query(g, "S"))
        if name == "bitpacked":  # the edited graph's pairs by Hellings
            check(res.pairs == untouched | _copy_oracle(gr, g, 0, off)
                  | _copy_oracle(gr, g, 1, off), "the pinned edit's pairs != Hellings")
        decision = warm.stats.planner
        return res.pairs, {"warm_route": decision["label"],
                           "warm_candidates": decision["candidates"],
                           "warm_allpairs_ms": warm_ms, "route": repairs,
                           "wall_ms": ms, "launches": launches, **st.as_dict()}

    want_batch, pinned_batch = batch_run("bitpacked")
    check(pinned_batch["launches"]["bitmm"] > 0, "the pinned batch never launched bitmm")
    want_delta, pinned_delta = delta_run("bitpacked")
    check(pinned_delta["launches"]["bitmm_or"] > 0,
          "the pinned bitpacked repair never launched bitmm_or")
    runs = {"default": [], "fitted": []}
    for label in ("default", "fitted", "fitted", "default"):
        prof = defaults if label == "default" else profile
        pairs, row_b = batch_run("auto", prof)
        check(pairs == want_batch, f"the auto batch under the {label} profile "
              "!= the pinned bitpacked batch")
        pairs, row_d = delta_run("auto", prof)
        check(pairs == want_delta, f"the auto edit under the {label} profile "
              "!= the pinned bitpacked edit")
        runs[label].append({"batch": row_b, "apply_delta": row_d})
    emit("calibrate_routes", n=graph.n_nodes, pinned={"batch": pinned_batch,
         "apply_delta": pinned_delta}, **runs,
         phase_seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return total


HBM_BYTES_PER_MS = HBM_BYTES_PER_S / 1e3


def pack_loop(T: torch.Tensor) -> torch.Tensor:
    """``pack_bits`` as 32 strided steps, one bit position each: the form
    the timing of ``--packing`` holds the library's blocked form against."""
    w = -(-T.shape[-1] // 32)
    T = torch.nn.functional.pad(T, (0, w * 32 - T.shape[-1]))
    out = torch.zeros((*T.shape[:-1], w), dtype=torch.int32, device=T.device)
    for b in range(32):
        out |= T[..., b::32].to(torch.int32) << b
    return out


def unpack_loop(Tp: torch.Tensor, n: int) -> torch.Tensor:
    """``unpack_bits`` as 32 steps, one bit position each."""
    w = Tp.shape[-1]
    out = torch.empty((*Tp.shape[:-1], w, 32), dtype=torch.bool, device=Tp.device)
    for b in range(32):
        out[..., b] = ((Tp >> b) & 1).bool()
    return out.reshape(*Tp.shape[:-1], w * 32)[..., :n]


LM_ARCH = "smollm-360m"  # the registry's default --arch, served at full width
LM_PARAMS = 409_007_040  # its TransformerConfig.param_count()


def lm_decode_and_forward(model, cfg, tokens, dev):
    """``serve_step`` token by token and the teacher-forced ``forward`` over
    ``tokens`` (B, S): both (B, S, vocab) f32 logits."""
    from repro_torch.models import transformer as tf

    B, S = tokens.shape
    with torch.inference_mode():
        full, _ = tf.forward(model, tokens, cfg)
        kv = tf.init_cache(cfg, B, S, device=dev)
        steps = []
        for t in range(S):
            logits, kv = tf.serve_step(model, kv, tokens[:, t:t + 1], t, cfg)
            steps.append(logits)
    return torch.stack(steps, dim=1), full


def lm_excess(got, want, rtol: float, atol: float) -> float:
    """The largest ``|got - want| - (atol + rtol |want|)``: at most 0 where
    ``got`` is within the tolerance of ``want`` everywhere."""
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


def lm_step_traffic(cfg, batch: int, prompt_len: int, gen: int) -> dict:
    """One decode step of a dense config, averaged over the run's decode
    positions ``prompt_len .. prompt_len + gen - 1``.

    ``need_bytes``, what the function must move: every weight read once at
    its stored width (f32), the embedding's ``batch`` rows only; the keys
    and values of the earlier positions each attends to read, this
    position's written (activation dtype); the tokens read, the f32 logits
    written.  ``ops``: two a weight per token, and the scores and the
    weighted sum over the attended positions.  ``bound_ms`` is the larger
    of ``need_bytes`` over the HBM rate and ``ops`` over the peak rate of
    the activation dtype.

    ``impl_bytes``, what ``serve_step``'s code moves for the same weights
    and caches: each matrix read in f32 and its cast written and read back
    (8 bytes a parameter in bf16), the unembedding also cast back to f32
    for the f32 logits (16 bytes), the norm scales read in f32, every
    cache slot read."""
    from repro_torch.models import transformer as tf

    if cfg.moe:
        raise ValueError("the traffic of a MoE step depends on the routing")
    act = torch.finfo(tf._act_dtype(cfg)).bits // 8
    model = tf.Transformer(cfg, device="meta")
    n_all = sum(p.numel() for p in model.parameters())
    norms = sum(p.numel() for name, p in model.named_parameters() if "norm" in name)
    embed, unembed = model.embed.numel(), model.unembed.numel()
    matrices = n_all - norms - embed - unembed  # those of the blocks
    slot = batch * cfg.n_kv_heads * cfg.hd * act  # one position's key (or value)
    io = batch * 8 + batch * cfg.vocab * 4  # token ids in, f32 logits out
    max_seq = prompt_len + gen
    need, ops = [], []
    for pos in range(prompt_len, max_seq):
        attended = [min(pos + 1, cfg.window) if cfg.window and cfg.layer_is_local(i) else pos + 1
                    for i in range(cfg.n_layers)]
        need.append((n_all - embed) * 4 + batch * cfg.d_model * 4 + io
                    + sum(2 * (a - 1) * slot + 2 * slot for a in attended))
        ops.append(2 * batch * (matrices + unembed)
                   + sum(4 * batch * cfg.n_heads * cfg.hd * a for a in attended))
    cast = 2 * act if act < 4 else 0  # the cast written and read back
    unembed_bytes = 4 + (2 * act + 4 + 4 if act < 4 else 0)  # and back to f32, read
    impl = (matrices * (4 + cast) + unembed * unembed_bytes + norms * 4
            + batch * cfg.d_model * 4 + io
            + sum(2 * (tf.cache_len(cfg, i, max_seq) + 1) * slot for i in range(cfg.n_layers)))
    need_bytes, n_ops = float(np.mean(need)), float(np.mean(ops))
    rate = BF16_OPS_PER_S if act == 2 else FP32_OPS_PER_S
    bytes_ms, ops_ms = need_bytes / HBM_BYTES_PER_S * 1e3, n_ops / rate * 1e3
    return {"need_bytes": need_bytes, "ops": n_ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "impl_bytes": impl, "impl_ms": impl / HBM_BYTES_PER_S * 1e3}


def lm_step_launches(model, cfg, batch: int, max_seq: int, dev) -> dict:
    """Device operations of one decode step (``torch.profiler``), by kind,
    the most frequent kernels by name, and the device's busy time: the sum
    of the operations' durations."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tf

    kv = tf.init_cache(cfg, batch, max_seq, device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    with torch.inference_mode():
        tf.serve_step(model, kv, tok, 0, cfg)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tf.serve_step(model, kv, tok, 1, cfg)
            torch.cuda.synchronize()
    events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    names = Counter(ev.name for ev in events)
    kinds = Counter("copy" if n.startswith("Memcpy") else
                    "fill" if n.startswith("Memset") else "kernel" for n in names.elements())
    return {"kinds": dict(kinds), "by_name": dict(names.most_common(8)),
            "busy_ms": sum(ev.time_range.elapsed_us() for ev in events) / 1e3}


def phase_lm_serve(dev) -> None:
    """The LM serving path of ``repro_torch`` (``models/``, ``launch/serve``):
    (a) ``smollm-360m`` at full width in f32, decode logits against the
    teacher-forced forward's at every step (B = 2, S = 24) to 2e-3 absolute;
    (b) the same weights served in the config's own bf16 through
    ``launch.serve.serve`` (batch 4, prompt 32, gen 16: the reference
    driver's defaults), with its timings, peak memory, the device operations
    of one decode step, the step's bound and the code's own weight and cache
    traffic (``lm_step_traffic``), and beside them the prompt through one
    batched ``prefill_step`` instead of the decode path, and its decode
    logits against the forward's (B = 2, S = 24) to the reference's 2e-2
    (rtol and atol); (c) the five LM archs'
    reduced configs in bf16, decode against forward to the reference's own
    2e-2 (gemma at S = 40, past its window); (d) the card against the port
    on the CPU, reduced configs in f32 with the same weights, to 1e-4."""
    import copy
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(22)

    def tokens(cfg, B, S):
        return torch.randint(0, cfg.vocab, (B, S), generator=gen).to(dev)

    # (a) full width, f32
    cfg = registry.get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = tf.Transformer(cfg32, device=dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == LM_PARAMS == cfg.param_count(), f"{LM_ARCH}: {n_params} parameters")
    dec, full = lm_decode_and_forward(model, cfg32, tokens(cfg, 2, 24), dev)
    err32 = (dec - full).abs().max().item()
    check(bool(torch.isfinite(full).all()), "full-width f32 logits not finite")
    check(err32 <= 2e-3, f"full-width f32 decode vs forward: {err32}")
    emit("lm_serve", part="full_width_f32", arch=LM_ARCH, params=n_params,
         weight_bytes=n_params * 4, build_s=build_s, B=2, S=24,
         max_abs_err=err32, tol_abs=2e-3,
         greedy_equal=(dec.argmax(-1) == full.argmax(-1)).float().mean().item())

    # (b) full width, the config's own bf16, through serve()
    batch, prompt_len, n_gen = 4, 32, 16
    serve(cfg, batch, 2, 2, device=dev, model=model)  # warm: cuBLAS handles, allocator
    torch.cuda.reset_peak_memory_stats(dev)
    res = serve(cfg, batch, prompt_len, n_gen, device=dev, model=model)
    peak = torch.cuda.max_memory_allocated(dev)
    check(res["tokens"].shape == (batch, n_gen), f"served tokens {res['tokens'].shape}")
    check(bool(((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all()), "token ids out of range")
    ids = torch.from_numpy(res["prompts"]).to(dev)
    with torch.inference_mode():
        tf.prefill_step(model, ids, cfg)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.prefill_step(model, ids, cfg)
        torch.cuda.synchronize()
        prefill_step_ms = (time.perf_counter() - t0) * 1e3
    step = lm_step_launches(model, cfg, batch, prompt_len + n_gen, dev)
    traffic = lm_step_traffic(cfg, batch, prompt_len, n_gen)
    dec, full = lm_decode_and_forward(model, cfg, tokens(cfg, 2, 24), dev)
    check(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()), "bf16 logits not finite")
    excess_b = lm_excess(dec, full, 2e-2, 2e-2)
    emit("lm_serve", part="full_width_bf16", arch=LM_ARCH, batch=batch,
         prompt_len=prompt_len, gen=n_gen, prefill_ms=res["prefill_ms"],
         prefill_step_ms=prefill_step_ms,
         decode_p50_ms=res["p50_ms"], decode_p95_ms=res["p95_ms"],
         decode_ms=res["decode_ms"], tokens_per_s=res["tokens_per_s"],
         max_memory_allocated=peak, step_device_ops=step["kinds"],
         step_kernels_by_name=step["by_name"], step_device_busy_ms=step["busy_ms"],
         step_need_bytes=traffic["need_bytes"], step_ops=traffic["ops"],
         step_bound_ms=traffic["bound_ms"], step_bound_by=traffic["bound_by"],
         step_impl_bytes=traffic["impl_bytes"], step_impl_ms=traffic["impl_ms"],
         bf16_decode_vs_forward_max_abs=(dec - full).abs().max().item(),
         bf16_decode_vs_forward_excess=excess_b, bf16_tol=2e-2,
         bf16_greedy_equal=(dec.argmax(-1) == full.argmax(-1)).float().mean().item(),
         first_row=res["tokens"][0].tolist())
    check(excess_b <= 0, f"{LM_ARCH} full-width bf16: decode vs forward past 2e-2")
    del model, dec, full
    torch.cuda.empty_cache()

    # (c) the reduced configs, bf16, decode against forward; (d) card vs CPU
    archs = [a for a, c in registry.ARCHS.items() if isinstance(c, TransformerConfig)]
    for seed, arch in enumerate(archs):
        small = reduce_config(registry.get_config(arch))
        S = 40 if small.window else 24
        model = tf.Transformer(small, device=dev, seed=seed)
        dec, full = lm_decode_and_forward(model, small, tokens(small, 2, S), dev)
        excess_c = lm_excess(dec, full, 2e-2, 2e-2)
        small32 = dataclasses.replace(small, dtype="float32")
        on_cpu = tf.Transformer(small32, device="cpu", seed=seed)
        ids = tokens(small, 2, S)
        card = lm_decode_and_forward(copy.deepcopy(on_cpu).to(dev), small32, ids, dev)
        host = lm_decode_and_forward(on_cpu, small32, ids.cpu(), torch.device("cpu"))
        excess_d = max(lm_excess(c.cpu(), h, 1e-4, 1e-4) for c, h in zip(card, host))
        emit("lm_serve", part="reduced", arch=arch, S=S, dtype=small.dtype,
             decode_vs_forward_max_abs=(dec - full).abs().max().item(),
             decode_vs_forward_excess=excess_c,
             card_vs_cpu_f32_max_abs=max((c.cpu() - h).abs().max().item()
                                         for c, h in zip(card, host)),
             card_vs_cpu_excess=excess_d)
        check(excess_c <= 0, f"{arch} reduced bf16: decode vs forward past 2e-2")
        check(excess_d <= 0, f"{arch} reduced f32: card vs CPU past 1e-4")
    emit("lm_serve", part="phase", seconds=time.perf_counter() - t_phase)


# train_4k's sequence of 4,096, cut to 2,048: at 4,096 a step took 8,902 ms
# and the phase 151.9 s on an H100 80GB HBM3 at 700 W, past its 120 s
LM_TRAIN_SEQ = 2048
LM_TRAIN_BATCH, LM_TRAIN_MICRO = 8, 2  # train_4k's global batch 256, cut to 2 microbatches of 4
LM_TRAIN_STEPS, LM_TRAIN_RESUME_AT, LM_TRAIN_INT8_STEPS = 6, 3, 2
# device kernels that take a product, by name: cuBLAS/cuBLASLt GEMMs (xmma,
# nvjet, cutlass, sgemm, gemv); of those, the ones on f32 operands
PRODUCT_KERNEL = re.compile(r"gemm|gemv|nvjet|xmma|cutlass", re.IGNORECASE)
F32_PRODUCT_KERNEL = re.compile(r"sgemm|sgemv|f32f32_f32f32|gemm_f32|_s1688|_s16816|simt_s", re.IGNORECASE)


def lm_train_flops(cfg, batch: int, seq: int) -> dict:
    """Model FLOPs of one train step of a dense config: 6 x the matmul
    parameters x tokens (2 for the forward product, 4 for its two backward
    products; the matmul parameters are every matrix of the blocks and the
    unembedding: the embedding is a gather, the norm scales are vectors),
    plus the causal attention: 12 x H x hd per attended (query, key) pair
    per layer (QK^T and PV, 2 x hd each forward, twice that backward), the
    pairs of a global layer S (S + 1) / 2 per sequence, of a local one
    those within the window.  The remat's recomputation and the masked
    score entries the chunk loop computes are not model FLOPs."""
    from repro_torch.models import transformer as tf

    if cfg.moe:
        raise ValueError("the FLOPs of a MoE step depend on the routing")
    model = tf.Transformer(cfg, device="meta")
    matmul = sum(p.numel() for name, p in model.named_parameters()
                 if p.dim() >= 2 and name != "embed")
    tokens = batch * seq
    pairs = sum(sum(min(i + 1, cfg.window) for i in range(seq))
                if cfg.window and cfg.layer_is_local(layer) else seq * (seq + 1) // 2
                for layer in range(cfg.n_layers))
    dense, attn = 6 * matmul * tokens, 12 * cfg.n_heads * cfg.hd * pairs * batch
    return {"matmul_params": matmul, "tokens": tokens, "dense_flops": dense,
            "attention_flops": attn, "flops": dense + attn}


def profile_kernels(step, dev):
    """``step()`` under ``torch.profiler``: its result, the wall ms of the
    step inside the profiler's window (ending in a synchronize; the
    profiler's own start and stop are not in it), the device microseconds
    per kernel name and the number of kernels the profiler reports."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    us = Counter()
    for ev in kernels:
        us[ev.name] += ev.time_range.elapsed_us()
    return out, wall_ms, us, len(kernels)


def f32_product_share(step, dev) -> dict:
    """One step under ``torch.profiler``: the device time of the kernels
    that take products on f32 operands (by kernel name,
    ``F32_PRODUCT_KERNEL``: in a bf16 model the attention's scores and
    weighted sums, the f32 logits and their backward products) and of every
    product kernel (``PRODUCT_KERNEL``), over the device time of every
    kernel of the step; the kernels that take the most time, by name, so
    that the split can be checked."""
    metrics, wall_ms, us, n_kernels = profile_kernels(step, dev)
    busy = sum(us.values())
    products = sum(t for n, t in us.items() if PRODUCT_KERNEL.search(n))
    f32 = sum(t for n, t in us.items() if PRODUCT_KERNEL.search(n) and F32_PRODUCT_KERNEL.search(n))
    return {"metrics": metrics, "profiled_wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "kernels": n_kernels, "product_device_ms": products / 1e3,
            "f32_product_device_ms": f32 / 1e3,
            "f32_product_share": f32 / busy if busy else None,
            "product_share": products / busy if busy else None,
            "top_kernels_ms": {n[:120]: t / 1e3 for n, t in us.most_common(12)}}


def leaves(tree, prefix: str = "") -> dict:
    """``{path: tensor}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def card_vs_cpu_grads(model_cls, cfg, batch, loss_fn, seed: int, dev, rtol: float, atol: float) -> dict:
    """``loss_fn`` and its backward on the same weights (drawn on the CPU)
    on the card and on the CPU: the largest excess of the loss and of every
    gradient over ``atol + rtol |cpu|`` (at most 0 where they agree)."""
    import copy

    from repro_torch.train.trainer import to_device

    host = model_cls(cfg, device="cpu", seed=seed)
    card = copy.deepcopy(host).to(dev)
    out = {}
    for name, model, where in (("cpu", host, torch.device("cpu")), ("card", card, dev)):
        loss, _ = loss_fn(model, to_device(batch, where))
        loss.backward()
        out[name] = (loss.detach().cpu(), {n: p.grad.cpu() for n, p in model.named_parameters()})
    (l_h, g_h), (l_c, g_c) = out["cpu"], out["card"]
    excess = lm_excess(l_c, l_h, rtol, atol)
    worst, worst_abs = excess, (l_c - l_h).abs().item()
    for n in g_h:
        worst = max(worst, lm_excess(g_c[n], g_h[n], rtol, atol))
        worst_abs = max(worst_abs, (g_c[n] - g_h[n]).abs().max().item())
    return {"loss_cpu": l_h.item(), "loss_card": l_c.item(), "leaves": len(g_h),
            "max_abs": worst_abs, "excess": worst}


def phase_lm_train(dev) -> None:
    """The LM training path of ``repro_torch`` (``train/``, ``loss_fn`` and
    the remats of ``models/``): ``smollm-360m`` at full width (409,007,040
    parameters, bf16 activations, f32 weights) on ``train_4k`` with its
    sequence cut from 4,096 to ``LM_TRAIN_SEQ`` and its global batch from 256
    to 8, as 2 microbatches of 4, through ``trainer.make_train_step`` on one
    fixed batch:

    (a) 6 steps with f32 moments, a checkpoint saved after step 3; each
        step's loss, grad_norm, ms (host clock, ending in a synchronize),
        tokens/s, mfu (``lm_train_flops`` over the step time at the bf16
        peak) and the peak memory beside the moments' bytes; every loss and
        gradient norm finite, and the loss falls;
    (b) a fresh model and optimizer (other seed) restored from the
        checkpoint, bit for bit against a host copy taken at the save, then
        steps 4-6 again: their losses and gradient norms equal the
        uninterrupted run's bit for bit (no operation of the dense path
        accumulates into one location in a varying order: the embedding's
        backward sorts its indices, the NLL's gather touches each location
        once), so steps 5 and 6 also hold the restored moments; the last
        step runs under ``torch.profiler`` (the f32 products' share of the
        device time) and its row is marked ``profiled``;
    (c) 2 steps with int8 moments from the same start, with their peak
        memory and moments' bytes;
    (d) the five LM archs' reduced configs in f32: a train step's loss and
        every gradient on the card against the CPU port, within 1e-4."""
    import dataclasses
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import data, optimizer as opt, trainer

    t_phase = time.perf_counter()
    cfg = registry.get_config(LM_ARCH)
    shape = {s.name: s for s in registry.get_shapes(LM_ARCH)}["train_4k"]
    check(shape.dim("seq_len") == 4096, f"train_4k: {shape}")

    def timed(step, model, state, batch) -> tuple[dict, float]:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = step(model, state, batch)
        torch.cuda.synchronize(dev)
        return {k: v.item() for k, v in m.items()}, (time.perf_counter() - t0) * 1e3

    def record(run: str, i: int, m: dict, ms: float, state, profiled: bool = False) -> dict:
        """A step's line; a profiled step's ms is the profiler's wall time,
        so it gets no tokens/s and no mfu."""
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"{run} step {i}: loss {m['loss']}, grad_norm {m['grad_norm']}")
        rate = None if profiled else LM_TRAIN_BATCH * LM_TRAIN_SEQ / (ms / 1e3)
        row = {"run": run, "step": i, "loss": m["loss"], "grad_norm": m["grad_norm"], "ms": ms,
               "profiled": profiled, "tokens_per_s": rate,
               "mfu": None if profiled else flops["flops"] / (ms / 1e3) / BF16_OPS_PER_S,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "moment_bytes": opt.moment_bytes(state)}
        emit("lm_train", part="step", seq=LM_TRAIN_SEQ, **row)
        return row

    ocfg = opt.OptimizerConfig()
    step32 = trainer.make_train_step(cfg, ocfg, n_micro=LM_TRAIN_MICRO)
    batch = data.lm_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, step=0, n_micro=LM_TRAIN_MICRO)
    model = tf.Transformer(cfg, device=dev, seed=0)
    state = opt.init_opt_state(model, ocfg)
    flops = lm_train_flops(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    emit("lm_train", part="config", arch=LM_ARCH, params=sum(p.numel() for p in model.parameters()),
         seq=LM_TRAIN_SEQ, batch=LM_TRAIN_BATCH, n_micro=LM_TRAIN_MICRO, dtype=cfg.dtype,
         reduced={"global_batch": [shape.dim("global_batch"), LM_TRAIN_BATCH],
                  "seq_len": [shape.dim("seq_len"), LM_TRAIN_SEQ]},
         lr=ocfg.lr, **flops)

    # (a) 6 steps, f32 moments, a checkpoint after step 3
    torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(LM_TRAIN_STEPS):
            if i == LM_TRAIN_RESUME_AT:
                # the save stacks the tree on the card: its memory is not the step's
                peak_before = torch.cuda.max_memory_allocated(dev)
                t0 = time.perf_counter()
                saved = {k: v.detach().cpu().clone()
                         for k, v in leaves(ckpt.training_tree(model, state)).items()}
                path = ckpt.save(tmp, i, ckpt.training_tree(model, state))
                save_s = time.perf_counter() - t0
                torch.cuda.reset_peak_memory_stats(dev)
            m, ms = timed(step32, model, state, batch)
            rows.append(record("f32", i, m, ms, state))
        peak32 = max(peak_before, torch.cuda.max_memory_allocated(dev))
        moments32 = opt.moment_bytes(state)
        losses = [r["loss"] for r in rows]
        check(losses[-1] < losses[0], f"the loss did not fall over {LM_TRAIN_STEPS} steps: {losses}")
        del model, state
        torch.cuda.empty_cache()

        # (b) restore into a fresh model and optimizer, resume
        fresh = tf.Transformer(cfg, device=dev, seed=1)
        fstate = opt.init_opt_state(fresh, ocfg)
        t0 = time.perf_counter()
        tree, _ = ckpt.restore(path, ckpt.training_tree(fresh, fstate))
        ckpt.load_training_tree(tree, fresh, fstate)
        del tree
        restore_s = time.perf_counter() - t0
    got = leaves(ckpt.training_tree(fresh, fstate))
    check(got.keys() == saved.keys(), "the restored tree has other leaves")
    unequal = [k for k in saved if not torch.equal(got[k].detach().cpu(), saved[k])]
    check(not unequal, f"restored leaves differ from the saved ones: {unequal[:5]}")
    emit("lm_train", part="checkpoint", step=LM_TRAIN_RESUME_AT, leaves=len(saved),
         bytes=sum(v.numel() * v.element_size() for v in saved.values()), save_s=save_s,
         restore_s=restore_s, bit_equal=True)
    del saved, got
    resumed = []
    for i in range(LM_TRAIN_RESUME_AT, LM_TRAIN_STEPS):
        if i < LM_TRAIN_STEPS - 1:
            resumed.append(record("resumed", i, *timed(step32, fresh, fstate, batch), fstate))
        else:
            prof = f32_product_share(lambda: step32(fresh, fstate, batch), dev)
            m = {k: v.item() for k, v in prof.pop("metrics").items()}
            resumed.append(record("resumed", i, m, prof["profiled_wall_ms"], fstate, profiled=True))
    pairs = [(r[k], rows[r["step"]][k]) for r in resumed for k in ("loss", "grad_norm")]
    emit("lm_train", part="resume", losses=[r["loss"] for r in resumed],
         uninterrupted=[rows[r["step"]]["loss"] for r in resumed],
         grad_norms=[r["grad_norm"] for r in resumed],
         uninterrupted_grad_norms=[rows[r["step"]]["grad_norm"] for r in resumed],
         max_abs_diff=max(abs(a - b) for a, b in pairs), bit_equal=all(a == b for a, b in pairs))
    check(all(a == b for a, b in pairs),
          f"resumed losses or gradient norms differ from the uninterrupted run's: {pairs}")
    emit("lm_train", part="profile", step=LM_TRAIN_STEPS - 1, **prof)
    del fresh, fstate
    torch.cuda.empty_cache()

    # (c) int8 moments from the same start
    ocfg8 = dataclasses.replace(ocfg, moment_dtype="int8")
    step8 = trainer.make_train_step(cfg, ocfg8, n_micro=LM_TRAIN_MICRO)
    model = tf.Transformer(cfg, device=dev, seed=0)
    state = opt.init_opt_state(model, ocfg8)
    torch.cuda.reset_peak_memory_stats(dev)
    rows8 = [record("int8", i, *timed(step8, model, state, batch), state)
             for i in range(LM_TRAIN_INT8_STEPS)]
    peak8, moments8 = torch.cuda.max_memory_allocated(dev), opt.moment_bytes(state)
    del model, state
    torch.cuda.empty_cache()
    steady = [r["ms"] for r in rows[1:]]
    emit("lm_train", part="summary", seq=LM_TRAIN_SEQ, step_ms_median=statistics.median(steady),
         tokens_per_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ / (statistics.median(steady) / 1e3),
         mfu=flops["flops"] / (statistics.median(steady) / 1e3) / BF16_OPS_PER_S,
         losses_f32=losses, losses_int8=[r["loss"] for r in rows8],
         peak_bytes_f32=peak32, moment_bytes_f32=moments32,
         peak_bytes_int8=peak8, moment_bytes_int8=moments8)

    # (d) card vs CPU, reduced configs in f32
    archs = [a for a, c in registry.ARCHS.items() if isinstance(c, TransformerConfig)]
    for seed, arch in enumerate(archs):
        small = dataclasses.replace(reduce_config(registry.get_config(arch)), dtype="float32")
        small_batch = data.lm_batch(small, 2, 40 if small.window else 24, step=seed)
        res = card_vs_cpu_grads(tf.Transformer, small, small_batch,
                                lambda mdl, b, c=small: tf.loss_fn(mdl, b, c), seed, dev, 1e-4, 1e-4)
        emit("lm_train", part="reduced_card_vs_cpu", arch=arch, tol=1e-4, **res)
        check(res["excess"] <= 0, f"{arch} reduced f32 train step: card vs CPU past 1e-4")
    emit("lm_train", part="phase", seconds=time.perf_counter() - t_phase)


DEEPFM_ARCH = "deepfm"
DEEPFM_STEPS = 15


def phase_deepfm_train(dev) -> None:
    """DeepFM training (``models/recsys/deepfm.py`` through
    ``trainer.make_train_step``): the full config (39 fields x 10^6 rows x
    dim 10, MLP (400, 400, 400)) at the config's ``train_batch`` of 65,536,
    AdamW with f32 moments, 15 steps on one fixed batch: each step's loss
    and ms, examples/s and the peak memory; every loss finite, and the last
    loss under 0.95 x the first (``tests/test_recsys.py``'s criterion).
    Then the reduced config's train step on the card against the CPU port:
    the loss and every gradient within 1e-5."""
    from repro_torch.configs import registry
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.models.recsys import deepfm
    from repro_torch.train import data, optimizer as opt, trainer

    t_phase = time.perf_counter()
    cfg = registry.get_config(DEEPFM_ARCH)
    n_batch = {s.name: s for s in registry.get_shapes(DEEPFM_ARCH)}["train_batch"].dim("batch")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    model = deepfm.DeepFM(cfg, device=dev, seed=0)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ocfg = opt.OptimizerConfig()
    state = opt.init_opt_state(model, ocfg)
    step = trainer.make_train_step(cfg, ocfg)
    batch = trainer.to_device(data.recsys_batch(cfg, n_batch, step=0), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for i in range(DEEPFM_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = step(model, state, batch)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        check(np.isfinite(losses[-1]) and np.isfinite(m["grad_norm"].item()),
              f"deepfm step {i}: loss {losses[-1]}")
    peak = torch.cuda.max_memory_allocated(dev)
    steady = statistics.median(times[1:])
    emit("deepfm_train", part="full_width", arch=DEEPFM_ARCH, params=n_params,
         param_bytes=n_params * 4, build_s=build_s, batch=n_batch, steps=DEEPFM_STEPS,
         losses=losses, step_ms=times, step_ms_median=steady,
         examples_per_s=n_batch / (steady / 1e3), max_memory_allocated=peak,
         moment_bytes=opt.moment_bytes(state))
    check(losses[-1] < losses[0] * 0.95, f"deepfm loss did not fall 5%: {losses}")
    del model, state, batch
    torch.cuda.empty_cache()

    small = reduce_config(cfg)
    res = card_vs_cpu_grads(deepfm.DeepFM, small, data.recsys_batch(small, 256, step=1),
                            lambda mdl, b: deepfm.loss_fn(mdl, b, small), 0, dev, 1e-5, 1e-5)
    emit("deepfm_train", part="reduced_card_vs_cpu", tol=1e-5, **res)
    check(res["excess"] <= 0, "deepfm reduced train step: card vs CPU past 1e-5")
    emit("deepfm_train", part="phase", seconds=time.perf_counter() - t_phase)


# the rows of gnn_train: each arch at its published width on the registry
# shape (GNN_SHAPES) it fits on one card
GNN_ROWS = (
    ("gcn-cora", "full_graph_sm"),
    ("gcn-cora", "ogb_products"),
    ("meshgraphnet", "minibatch_lg"),
    ("equiformer-v2", "molecule"),
    ("mace", "molecule"),
)
GNN_TRAIN_STEPS = 8
# device kernels that move rows by an index: gathers (index_select and its
# kin) and scatter-adds (index_add's indexFunc, scatter_reduce, index_put);
# a kernel that matches both is counted as a scatter
GATHER_KERNEL = re.compile(r"indexSelect|index_select|gather", re.IGNORECASE)
SCATTER_KERNEL = re.compile(r"indexFunc|index_add|index_put|scatter_add|scatter_reduce|Reduce(Add|Maximum)",
                            re.IGNORECASE)


def gnn_row_size(shape) -> tuple[int, int, int]:
    """(nodes, edges, d_feat) of a ``GNN_SHAPES`` entry: a full graph as
    it is, a sampled one at ``sampled_sizes(batch_nodes, fanouts)`` (as the
    dry run sizes it), a batch of small graphs flattened."""
    from repro_torch.models.gnn.common import sampled_sizes

    d = dict(shape.dims)
    if shape.kind == "graph_full":
        return d["n_nodes"], d["n_edges"], d["d_feat"]
    if shape.kind == "graph_sampled":
        n, e = sampled_sizes(d["batch_nodes"], (d["fanout1"], d["fanout2"]))
        return n, e, d["d_feat"]
    if shape.kind == "graph_batched":
        return d["n_nodes"] * d["batch"], d["n_edges"] * d["batch"], d["d_feat"]
    raise ValueError(shape)


def gnn_train_flops(model, batch, cfg) -> int:
    """Model FLOPs of one train step, counted from the code's products and
    einsums (``torch.utils.flop_counter``: matmuls, batched matmuls and the
    einsums they carry, forward and backward) on one forward and backward
    of ``batch``; the gradients are dropped afterwards."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.gnn import api

    with FlopCounterMode(display=False) as counter:
        loss, _ = api.loss_fn(model, batch, cfg)
        loss.backward()
    for p in model.parameters():
        p.grad = None
    return counter.get_total_flops()


def rotated_batch(batch, seed: int):
    """``batch`` with its positions turned by a random proper rotation and
    moved by 1.5 along every axis."""
    rng = np.random.default_rng(seed)
    a = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(a) < 0:
        a[:, 0] = -a[:, 0]
    pos = batch["positions"]
    return dict(batch, positions=pos @ torch.as_tensor(a.T, dtype=pos.dtype, device=pos.device) + 1.5)


def invariance_error(model, batch, cfg, seed: int) -> dict:
    """The readout against the readout of the rotated and moved batch: the
    largest absolute difference and the largest excess over rtol 1e-3 and
    atol 1e-4 (at most 0 where they agree)."""
    from repro_torch.models.gnn import api

    with torch.no_grad():
        out = api.forward(model, batch, cfg)
        out_rot = api.forward(model, rotated_batch(batch, seed), cfg)
    check(bool(torch.isfinite(out).all()), f"{cfg.arch_id}: non-finite readout")
    return {"max_abs": (out_rot - out).abs().max().item(), "excess": lm_excess(out_rot, out, 1e-3, 1e-4),
            "out_abs_max": out.abs().max().item()}


def phase_gnn_train(dev) -> None:
    """GNN training (``models/gnn/`` through ``trainer.make_train_step``):
    each row of ``GNN_ROWS`` at the arch's published width, uncut, on
    ``gnn_batch`` at its registry shape's size (``gnn_row_size``), 8 AdamW
    steps with f32 moments on that one batch, moved to the card once.
    Each step prints its loss, grad_norm, ms (host clock, ending in a
    synchronize), edges/s, the peak memory and the moments' bytes; the
    last step runs under ``torch.profiler`` (device-busy ms against wall
    ms, the kernel count, the top kernels, the gathers' and scatter-adds'
    share) and is marked ``profiled``; the model FLOPs of a step
    (``gnn_train_flops``) over the median step time at the f32 peak.
    Every loss and gradient norm must be finite and the loss must fall
    over the 8 steps.  Equiformer-v2's row also times ``wigner_stack`` at
    l_max 6 on its edges, and checkpoints its training tree after the
    steps, restored bit for bit into a fresh model and optimizer; it and
    MACE print their full-width readout's E(3) invariance error (rotation
    plus translation) as a number.  Then the four reduced configs' train
    step on the card against the CPU port (loss and every gradient within
    1e-4), and the E(3) invariance of Equiformer-v2 and MACE on the card at
    the reference test's shape (2 layers, width 8, 2 heads, the full l_max
    and m_max; rtol 1e-3, atol 1e-4)."""
    import dataclasses
    import functools

    from repro_torch.configs import registry
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.models.gnn import api, so3
    from repro_torch.train import data, optimizer as opt, trainer

    t_phase = time.perf_counter()
    for arch, shape_name in GNN_ROWS:
        t_row = time.perf_counter()
        cfg = registry.get_config(arch)
        shape = {s.name: s for s in registry.get_shapes(arch)}[shape_name]
        n, e, d_feat = gnn_row_size(shape)
        t0 = time.perf_counter()
        host = data.gnn_batch(cfg, n=n, e=e, d_feat=d_feat, step=0)
        batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = trainer.to_device(host, dev)
        torch.cuda.synchronize(dev)
        h2d_s = time.perf_counter() - t0
        batch_bytes = sum(v.nbytes for v in host.values())
        del host
        model = api.GNN(cfg, d_feat, device=dev, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        ocfg = opt.OptimizerConfig()
        state = opt.init_opt_state(model, ocfg)
        step = trainer.make_train_step(cfg, ocfg)
        torch.cuda.reset_peak_memory_stats(dev)
        rows = []
        for i in range(GNN_TRAIN_STEPS):
            profiled = i == GNN_TRAIN_STEPS - 1
            if profiled:
                m, ms, us, n_kernels = profile_kernels(lambda: step(model, state, batch), dev)
            else:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                m = step(model, state, batch)
                torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
            m = {k: v.item() for k, v in m.items()}
            check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                  f"{arch}/{shape_name} step {i}: loss {m['loss']}, grad_norm {m['grad_norm']}")
            row = {"step": i, "loss": m["loss"], "grad_norm": m["grad_norm"], "ms": ms,
                   "profiled": profiled, "edges_per_s": None if profiled else e / (ms / 1e3),
                   "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                   "moment_bytes": opt.moment_bytes(state)}
            emit("gnn_train", part="step", arch=arch, shape=shape_name, **row)
            rows.append(row)
        losses = [r["loss"] for r in rows]
        check(losses[-1] < losses[0], f"{arch}/{shape_name}: the loss did not fall over "
              f"{GNN_TRAIN_STEPS} steps: {losses}")
        flops = gnn_train_flops(model, batch, cfg)
        steady = statistics.median(r["ms"] for r in rows[1:-1])
        busy = sum(us.values())
        gathers = sum(t for k, t in us.items() if GATHER_KERNEL.search(k) and not SCATTER_KERNEL.search(k))
        scatters = sum(t for k, t in us.items() if SCATTER_KERNEL.search(k))
        extra = {}
        if cfg.model == "equiformer_v2":
            # the Wigner assembly on this batch's edges: its device time
            # and launches (eager: one small expression per matrix entry)
            vec = batch["positions"][batch["edge_dst"].long()] - batch["positions"][batch["edge_src"].long()]
            R = so3.rotation_to_z(vec)
            _, wig_ms, wig_us, wig_kernels = profile_kernels(lambda: so3.wigner_stack(R, cfg.l_max), dev)
            extra["wigner"] = {"edges": e, "l_max": cfg.l_max, "wall_ms": wig_ms,
                               "device_busy_ms": sum(wig_us.values()) / 1e3, "kernels": wig_kernels,
                               "ms": time_ms(lambda: so3.wigner_stack(R, cfg.l_max), reps=5)}
            del vec, R
            extra["checkpoint"] = gnn_checkpoint_round_trip(model, state, cfg, d_feat, dev)
        if cfg.model in ("equiformer_v2", "mace"):
            extra["invariance_full_width"] = invariance_error(model, batch, cfg, seed=7)
        emit("gnn_train", part="row", arch=arch, shape=shape_name, params=n_params,
             nodes=n, edges=e, d_feat=d_feat, batch_bytes=batch_bytes, batch_s=batch_s, h2d_s=h2d_s,
             steps=GNN_TRAIN_STEPS, losses=losses, step_ms_median=steady,
             edges_per_s=e / (steady / 1e3),
             peak_bytes=max(r["max_memory_allocated"] for r in rows),
             moment_bytes=opt.moment_bytes(state), flops=flops,
             flop_share=flops / (steady / 1e3) / FP32_OPS_PER_S,
             profile={"step": GNN_TRAIN_STEPS - 1, "wall_ms": rows[-1]["ms"], "device_busy_ms": busy / 1e3,
                      "busy_share": busy / 1e3 / rows[-1]["ms"],
                      "busy_over_median_step": busy / 1e3 / steady, "kernels": n_kernels,
                      "gather_ms": gathers / 1e3, "gather_share": gathers / busy if busy else None,
                      "scatter_ms": scatters / 1e3, "scatter_share": scatters / busy if busy else None,
                      "top_kernels_ms": {k[:120]: t / 1e3 for k, t in us.most_common(10)}},
             row_s=time.perf_counter() - t_row, **extra)
        del model, state, batch, step
        torch.cuda.empty_cache()

    # the reduced configs: one train step, card against the CPU port
    for seed, arch in enumerate(dict.fromkeys(a for a, _ in GNN_ROWS)):
        small = reduce_config(registry.get_config(arch))
        res = card_vs_cpu_grads(functools.partial(api.GNN, d_feat=16), small,
                                data.gnn_batch(small, n=256, e=1024, d_feat=16, step=seed),
                                lambda mdl, b, c=small: api.loss_fn(mdl, b, c), seed, dev, 1e-4, 1e-4)
        emit("gnn_train", part="reduced_card_vs_cpu", arch=arch, tol=1e-4, **res)
        check(res["excess"] <= 0, f"{arch} reduced train step: card vs CPU past 1e-4")
    # E(3) invariance at the reference test's shape
    for arch in ("equiformer-v2", "mace"):
        cfg = dataclasses.replace(registry.get_config(arch), n_layers=2, d_hidden=8, n_heads=2)
        model = api.GNN(cfg, 12, device=dev, seed=1)
        batch = trainer.to_device(data.gnn_batch(cfg, n=12, e=36, d_feat=12, step=1), dev)
        res = invariance_error(model, batch, cfg, seed=1)
        emit("gnn_train", part="invariance", arch=arch, l_max=cfg.l_max, m_max=cfg.m_max,
             rtol=1e-3, atol=1e-4, **res)
        check(res["excess"] <= 0, f"{arch}: the readout is not E(3)-invariant on the card")
    emit("gnn_train", part="phase", seconds=time.perf_counter() - t_phase)


def gnn_checkpoint_round_trip(model, state, cfg, d_feat: int, dev) -> dict:
    """The training tree of ``model`` and ``state`` saved, then restored
    into a fresh model (another seed) and optimizer: every leaf must equal
    a host copy taken at the save, bit for bit."""
    import tempfile

    from repro_torch.models.gnn import api
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt

    saved = {k: v.detach().cpu().clone() for k, v in leaves(ckpt.training_tree(model, state)).items()}
    fresh = api.GNN(cfg, d_feat, device=dev, seed=1)
    fstate = opt.init_opt_state(fresh, opt.OptimizerConfig())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = ckpt.save(tmp, GNN_TRAIN_STEPS, ckpt.training_tree(model, state))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, _ = ckpt.restore(path, ckpt.training_tree(fresh, fstate))
        ckpt.load_training_tree(tree, fresh, fstate)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
    got = leaves(ckpt.training_tree(fresh, fstate))
    check(got.keys() == saved.keys(), "the restored GNN tree has other leaves")
    unequal = [k for k in saved if not torch.equal(got[k].detach().cpu(), saved[k])]
    check(not unequal, f"restored GNN leaves differ from the saved ones: {unequal[:5]}")
    return {"param_leaves": sum(1 for _ in fresh.parameters()), "leaves": len(saved),
            "bytes": sum(v.numel() * v.element_size() for v in saved.values()),
            "save_s": save_s, "restore_s": restore_s, "bit_equal": True}


# ---------------------------------------------------------------------- #
# lm_sharded: the sharded LM on torch.distributed
# ---------------------------------------------------------------------- #

LM_SHARDED_BATCH, LM_SHARDED_SEQ, LM_SHARDED_STEPS = 8, 512, 2
#: part 2 puts four ranks on the one card: smollm-360m's 32 blocks cut to 2
LM_SHARDED_BLOCKS = 2
LM_SHARDED_WORLD, LM_SHARDED_RESTORE = (2, 2), (1, 4)
#: the (pod, data, model) meshes part 2's four ranks also build (the pod
#: axis pure data parallelism), and the one whose checkpoint is restored
#: on the LM_SHARDED_WORLD mesh
LM_SHARDED_POD_MESHES, LM_SHARDED_POD_SAVE = ((2, 1, 2), (2, 2, 1)), (2, 1, 2)
LM_SHARDED_MOE_ARCH, LM_SHARDED_MOE_SEQ = "qwen3-moe-235b-a22b", 32
#: meshes whose MoE train step is held at a capacity factor of n_experts /
#: top_k, where no token group drops a token: the 2 x 2 x 1 mesh's four
#: groups (G = pod x data) drop other tokens than the unsharded step's one
#: group, so with drops the two steps are different functions there (the
#: CPU tests hold that grouped step to the reference's under the same
#: groups, and ``moe_group_check`` holds its dispatch with drops per group)
LM_SHARDED_MOE_DROPLESS = ((2, 2, 1),)
LM_SHARDED_DEADLINE_S = 240  # part 2's world, from its spawn to its last rank's exit
#: the reference's sharded-step test: loss rtol 1e-5, parameters 5e-4 / 1e-5;
#: the gradient norm as the loss, and the f32 moments (which move with any
#: gradient off by a constant factor, as AdamW's update barely does) within
#: rtol 5e-4 and atol 1e-4 of the leaf's largest magnitude, as the CPU tests
LM_SHARDED_TOL = {"loss_rtol": 1e-5, "rtol": 5e-4, "atol": 1e-5, "moment_rtol": 5e-4,
                  "moment_atol_share": 1e-4}
#: the compressed all-reduce's error over max|g| / 127: rounding to the
#: shared scale errs by at most half a code step, so at most 0.5, and the
#: f32 sums of the exact mean add about 1e-5 of it
LM_SHARDED_COMPRESSED_LIMIT = 0.5 + 1e-3
#: the grouped MoE check: the router's pull to expert 0 (so that each group
#: drops tokens), and test (c)'s tolerance
LM_SHARDED_MOE_SKEW, LM_SHARDED_MOE_TOL = 0.3, {"rtol": 1e-5, "atol": 1e-6}


def hold_sharded(cfg, batch, plan, model, steps: int, dev) -> tuple[dict, object, dict]:
    """``steps`` AdamW steps (f32 moments) of the port's unsharded train
    step on ``model`` and of the sharded one on a copy cut to this rank's
    blocks under ``plan``, on the same global batch: per step both losses,
    gradient norms and ms (host clock ending in a synchronize), each run's
    peak memory, the bytes each collective call site sent per sharded
    step, and the largest excess of the losses, of the gradient norms, of
    this rank's parameter blocks and of its blocks of both moments over
    ``LM_SHARDED_TOL`` (at most 0 where they agree).  Returns the row, the
    sharded model and its optimizer state."""
    import copy

    from repro_torch.models.weights import named_specs, shard_model
    from repro_torch.shard import plans
    from repro_torch.shard.plans import local_shard
    from repro_torch.train import optimizer as opt, trainer

    ocfg = opt.OptimizerConfig()
    sharded = shard_model(copy.deepcopy(model), plan)
    runs = {}
    for name, mdl, p in (("plain", model, None), ("sharded", sharded, plan)):
        step = trainer.make_train_step(cfg, ocfg, plan=p)
        state = opt.init_opt_state(mdl, ocfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        # what is resident before the run: both models, and this run's moments
        resident = torch.cuda.memory_allocated(dev)
        plans.reset_exchanges()
        losses, norms, ms = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            m = step(mdl, state, batch)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        if name == "plain":  # its moments wait on the host, so that the sharded run's memory is its own
            state = {k: {n: t.cpu() for n, t in state[k].items()} for k in ("m", "v")}
        runs[name] = {"losses": losses, "norms": norms, "ms": ms,
                      "peak_bytes": torch.cuda.max_memory_allocated(dev), "resident_bytes": resident,
                      "state": state}
        del state
    sent = {k: v / steps for k, v in sorted(plans.exchanged.items())}
    calls = {k: v / steps for k, v in sorted(plans.exchange_calls.items())}
    tol = LM_SHARDED_TOL
    specs = named_specs(cfg, plan)
    whole = dict(model.named_parameters())
    param_excess = max(
        lm_excess(p.detach(), local_shard(whole[n].detach(), specs[n], plan), tol["rtol"], tol["atol"])
        for n, p in sharded.named_parameters())

    def moment_excess(key):
        worst = -float("inf")
        for n, got in runs["sharded"]["state"][key].items():
            want = local_shard(runs["plain"]["state"][key][n], specs[n], plan).to(got.device)
            atol = tol["moment_atol_share"] * runs["plain"]["state"][key][n].abs().max().item()
            worst = max(worst, lm_excess(got, want, tol["moment_rtol"], atol))
        return worst

    def scalar_excess(key):
        return max(abs(a - b) - tol["loss_rtol"] * abs(b)
                   for a, b in zip(runs["sharded"][key], runs["plain"][key]))

    m_excess, v_excess = moment_excess("m"), moment_excess("v")
    runs["plain"]["state"] = None  # of the plain run only the numbers above are kept
    row = {"mode": plan.attn_mode(cfg.n_heads, cfg.hd, False),
           "losses": runs["sharded"]["losses"], "plain_losses": runs["plain"]["losses"],
           "grad_norms": runs["sharded"]["norms"], "plain_grad_norms": runs["plain"]["norms"],
           "step_ms": runs["sharded"]["ms"], "plain_step_ms": runs["plain"]["ms"],
           "peak_bytes": runs["sharded"]["peak_bytes"], "plain_peak_bytes": runs["plain"]["peak_bytes"],
           "resident_bytes": runs["sharded"]["resident_bytes"],
           "plain_resident_bytes": runs["plain"]["resident_bytes"],
           "sent_bytes_per_step": sent, "calls_per_step": calls,
           "loss_excess": scalar_excess("losses"), "grad_norm_excess": scalar_excess("norms"),
           "param_excess": param_excess, "m_excess": m_excess, "v_excess": v_excess, "tol": tol}
    return row, sharded, runs["sharded"]["state"]


SHARDED_EXCESSES = ("loss_excess", "grad_norm_excess", "param_excess", "m_excess", "v_excess")


def sharded_agrees(row: dict) -> bool:
    """Whether every excess of a ``hold_sharded`` row is at most 0."""
    return all(row[k] <= 0 for k in SHARDED_EXCESSES)


def _blocks_match(tree, specs, plan, saved: dict) -> bool:
    """Whether every leaf of ``tree`` (a rank's blocks) is its block, under
    its spec, of the stored array of the same key, bit for bit."""
    from repro_torch.shard.plans import local_shard
    from repro_torch.train import checkpoint as ckpt

    leaf_specs = ckpt._flatten_specs(specs)
    return all(np.array_equal(t.detach().cpu().numpy(), local_shard(saved[k], leaf_specs[k], plan))
               for k, t in ckpt._flatten(tree).items())


def sharded_round_trip(model, state, cfg, path: str, restore_plan, dev) -> dict:
    """Save a sharded model's training tree (every leaf gathered, world rank
    0 writes), restore it onto ``restore_plan`` in a fresh model (another
    seed) and check it bit for bit: on the same plan the restored blocks
    against the live ones; on another, the live blocks and the restored
    ones each against their blocks of the stored arrays (read back, so
    that nothing is gathered for the check)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.weights import shard_model, training_specs
    from repro_torch.train import checkpoint as ckpt, optimizer as opt

    t0 = time.perf_counter()
    out = ckpt.save(path, int(state["step"]), ckpt.training_tree(model, state), plan=model.plan,
                    specs=training_specs(model, state))
    save_s = time.perf_counter() - t0
    same = restore_plan == model.plan
    saved = None
    if not same:
        with open(os.path.join(out, "meta.json")) as fh:
            manifest = json.load(fh)["manifest"]
        saved = {k: np.load(os.path.join(out, f)) for k, f in manifest.items()}
        saved_equal = _blocks_match(ckpt.training_tree(model, state), training_specs(model, state),
                                    model.plan, saved)
    fresh = shard_model(tf.Transformer(cfg, device=dev, seed=1), restore_plan)
    fstate = opt.init_opt_state(fresh, opt.OptimizerConfig())
    t0 = time.perf_counter()
    specs = training_specs(fresh, fstate)
    tree, _ = ckpt.restore(out, ckpt.training_tree(fresh, fstate), plan=restore_plan, specs=specs)
    ckpt.load_training_tree(tree, fresh, fstate)
    del tree
    restore_s = time.perf_counter() - t0
    got = ckpt.training_tree(fresh, fstate)
    if same:
        live = leaves(ckpt.training_tree(model, state))
        saved_equal = equal = all(torch.equal(t, live[k]) for k, t in leaves(got).items())
    else:
        equal = _blocks_match(got, specs, restore_plan, saved)
    return {"restored_on": [restore_plan.axis_size(a) for a in restore_plan.axes],
            "local_bytes": sum(t.numel() * t.element_size() for t in leaves(got).values()),
            "save_s": save_s, "restore_s": restore_s, "saved_equal": bool(saved_equal),
            "bit_equal": bool(equal)}


def compressed_check(model, cfg, batch, mesh, plan, dev, axis: str = "data") -> dict:
    """The unsharded model's gradient on this row rank's rows of the batch
    (a real gradient, different on each row rank) through the int8
    compressed all-reduce over ``axis`` (``data``, or ``pod``: the
    reference's cross-pod use), against the exact mean (a SUM all-reduce
    over ``axis``, divided): per leaf the error over the reference's
    one-shot bound max|g| / 127 (max over the ``axis`` group); the largest
    of them, which must be at most ``LM_SHARDED_COMPRESSED_LIMIT``."""
    from repro_torch.models import transformer as tf
    from repro_torch.shard import collectives, plans
    from repro_torch.train.compression import make_compressed_allreduce
    from repro_torch.train.trainer import to_device

    per = LM_SHARDED_BATCH // plan.row_size
    rows = {k: v[plan.row_rank * per:(plan.row_rank + 1) * per] for k, v in batch.items()}
    loss, _ = tf.loss_fn(model, to_device(rows, dev), cfg)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    plans.reset_exchanges()
    g_hat, _ = make_compressed_allreduce(mesh, axis)(grads, {n: torch.zeros_like(g) for n, g in grads.items()})
    sent = sum(plans.exchanged.values())
    worst = 0.0
    for n, g in grads.items():
        exact = collectives.all_reduce(g, plan, (axis,), "exact") / plan.axis_size(axis)
        gmax = collectives.all_reduce(g.abs().max(), plan, (axis,), "exact", op="max")
        err = (g_hat[n] - exact).abs().max()
        worst = max(worst, (err / torch.clamp(gmax / 127, min=1e-30)).item())
    return {"axis": axis, "ranks": plan.axis_size(axis), "leaves": len(grads), "sent_bytes": sent,
            "worst_error_over_bound": worst}


def moe_group_check(mcfg, plan, dev) -> dict:
    """The grouped MoE dispatch (``moe_apply`` with ``plan``: one token
    group per row rank, over ``(pod, data)`` or ``data``, capacity per
    group, the experts over ``model``) of a block of ``mcfg``'s widths, its
    router pulled to expert 0 so that every group drops tokens, on this
    row rank's rows of the
    ``LM_SHARDED_BATCH`` x ``LM_SHARDED_MOE_SEQ`` tokens, against the plain
    ``moe_apply`` (no plan) of those rows alone, which is that group's
    computation; ``aux`` against the plain call on the whole batch.  The
    largest excesses over ``LM_SHARDED_MOE_TOL`` (at most 0 where they
    agree), and whether the whole batch as one group drops other tokens
    (it must, or the check could not tell the groups apart)."""
    from repro_torch.models.moe import moe_apply, moe_params, moe_specs
    from repro_torch.shard.plans import local_shard

    m, d = mcfg.moe, mcfg.d_model
    gen = torch.Generator().manual_seed(11)
    p = moe_params(d, m, generator=gen, device="cpu")
    p["router"][:, 0] += LM_SHARDED_MOE_SKEW
    p = {k: v.to(dev) for k, v in p.items()}
    x = (torch.randn((LM_SHARDED_BATCH * LM_SHARDED_MOE_SEQ, d), generator=gen) + 0.5).to(dev)
    per = x.shape[0] // plan.row_size
    rows = x[plan.row_rank * per:(plan.row_rank + 1) * per]
    specs = moe_specs(d, m, plan)
    tol = LM_SHARDED_MOE_TOL
    with torch.no_grad():
        y, aux = moe_apply({k: local_shard(v, specs[k], plan) for k, v in p.items()}, rows, m, True, plan)
        y_group, _ = moe_apply(p, rows, m, True, None)
        y_all, aux_all = moe_apply(p, x, m, True, None)
    y_all = y_all[plan.row_rank * per:(plan.row_rank + 1) * per]
    return {"tokens": x.shape[0], "groups": plan.row_size, "experts_split": specs["we_gate"][0] is not None,
            "y_excess": lm_excess(y, y_group, tol["rtol"], tol["atol"]),
            "aux_excess": abs(aux.item() - aux_all.item()) - tol["rtol"] * abs(aux_all.item()),
            "groups_drop_other_tokens": not torch.allclose(y_group, y_all, rtol=1e-3), "tol": tol}


def probe_collectives(dev) -> None:
    """Each of the three collectives, once on a CUDA tensor over the
    world: raises naming the one the backend refuses."""
    import torch.distributed as dist

    from repro_torch.shard.plans import _all_gather

    x = torch.arange(4, dtype=torch.float32, device=dev)
    out = torch.empty(4 * dist.get_world_size(), dtype=torch.float32, device=dev)
    for name, call in (("all_gather", lambda: _all_gather(out, x, None)),
                       ("all_reduce SUM", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.SUM)),
                       ("all_reduce MAX", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX)),
                       ("broadcast", lambda: dist.broadcast(x.clone(), src=0))):
        try:
            call()
        except RuntimeError as e:
            raise RuntimeError(f"{dist.get_backend()} refused a CUDA tensor for {name}: {e}") from e


def mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def sharded_mesh_part(cfg, mcfg, batch, mesh, plan, dev, axis: str, restore_plan, path: str) -> dict:
    """One mesh of part 2's ranks: the compressed all-reduce of smollm's
    real gradients over ``axis``, smollm-360m (``cfg``) and the reduced MoE
    arch (``mcfg``; dropless on ``LM_SHARDED_MOE_DROPLESS``) held to their
    unsharded steps, smollm's checkpoint restored on ``restore_plan`` (none
    when None) and the grouped MoE dispatch against the plain one per
    group; this rank's coordinate on each mesh axis and the part's
    seconds."""
    import dataclasses

    from repro_torch.models import transformer as tf
    from repro_torch.train import data

    t0 = time.perf_counter()
    model = tf.Transformer(cfg, device=dev, seed=0)
    out = {"coords": {a: plan.axis_rank(a) for a in plan.axes},
           "compressed": compressed_check(model, cfg, batch, mesh, plan, dev, axis)}
    out["smollm"], sharded, state = hold_sharded(cfg, batch, plan, model, LM_SHARDED_STEPS, dev)
    del model
    if restore_plan is not None:
        out["checkpoint"] = sharded_round_trip(sharded, state, cfg, path, restore_plan, dev)
    del sharded, state
    # the MoE's weights are drawn on the CPU, whose draws the CPU tests can
    # hold: with them no group of this batch drops other tokens than the
    # whole batch does on two groups, so the grouped step equals the
    # unsharded one; moe_group_check holds a dispatch whose groups do drop
    # others
    shape = tuple(plan.axis_size(a) for a in plan.axes)
    held = mcfg
    if shape in LM_SHARDED_MOE_DROPLESS:
        m = mcfg.moe
        held = dataclasses.replace(mcfg, moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k))
    out["moe"], _, _ = hold_sharded(held, data.lm_batch(held, LM_SHARDED_BATCH, LM_SHARDED_MOE_SEQ, step=0),
                                    plan, tf.Transformer(held, device="cpu", seed=0).to(dev),
                                    LM_SHARDED_STEPS, dev)
    out["moe"]["capacity_factor"] = held.moe.capacity_factor
    out["moe_groups"] = moe_group_check(mcfg, plan, dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def lm_sharded_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of part 2's gloo world (spawned, on the one card): the
    collectives probed on CUDA tensors; on the ``LM_SHARDED_WORLD`` mesh
    (``sharded_mesh_part``) smollm-360m (f32, full width,
    ``LM_SHARDED_BLOCKS`` blocks) and the reduced MoE arch held to their
    unsharded steps, the compressed all-reduce of smollm's real gradients
    over ``data`` and smollm's checkpoint restored onto the
    ``LM_SHARDED_RESTORE`` mesh of the same ranks, and the grouped MoE
    dispatch against the plain one per group; then the same on each
    ``(pod, data, model)`` mesh of ``LM_SHARDED_POD_MESHES`` over the same
    ranks, the all-reduce over ``pod``, and the checkpoint of
    ``LM_SHARDED_POD_SAVE`` restored on the ``LM_SHARDED_WORLD`` mesh.
    Writes its row, or its traceback, as JSON to ``out % rank``."""
    import dataclasses
    import traceback
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.shard.plans import MeshPlan
    from repro_torch.train import data

    dev = torch.device("cuda", 0)
    # the card's host has 8 cores for the four ranks and the parent
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=120))
        probe_collectives(dev)
        # every mesh made up front, in the same order on every rank
        mesh = make_test_mesh(*LM_SHARDED_WORLD)
        plan = MeshPlan.from_mesh(mesh)
        restore = MeshPlan.from_mesh(make_test_mesh(*LM_SHARDED_RESTORE))
        pods = {}
        for shape in LM_SHARDED_POD_MESHES:
            pod_mesh = init_device_mesh("cuda", shape, mesh_dim_names=("pod", "data", "model"))
            pods[shape] = pod_mesh, MeshPlan.from_mesh(pod_mesh)
        cfg = dataclasses.replace(registry.get_config(LM_ARCH), dtype="float32", n_layers=LM_SHARDED_BLOCKS)
        mcfg = dataclasses.replace(reduce_config(registry.get_config(LM_SHARDED_MOE_ARCH)), dtype="float32")
        batch = data.lm_batch(cfg, LM_SHARDED_BATCH, LM_SHARDED_SEQ, step=0)
        tmp = os.path.dirname(store)
        parts = {mesh_name(LM_SHARDED_WORLD): sharded_mesh_part(
            cfg, mcfg, batch, mesh, plan, dev, "data", restore, os.path.join(tmp, "ckpt"))}
        for shape, (pod_mesh, pod_plan) in pods.items():
            parts[mesh_name(shape)] = sharded_mesh_part(
                cfg, mcfg, batch, pod_mesh, pod_plan, dev, "pod",
                plan if shape == LM_SHARDED_POD_SAVE else None, os.path.join(tmp, f"ckpt_{mesh_name(shape)}"))
        result = {"rank": rank, "parts": parts}
    except BaseException:
        result = {"rank": rank, "error": traceback.format_exc()}
        raise
    finally:
        with open(out % rank, "w") as fh:
            json.dump(result, fh)
        if dist.is_initialized():
            dist.destroy_process_group()


def run_gloo_world(tmp: str) -> list[dict]:
    """Part 2's ranks, spawned together (CUDA cannot be forked once it is
    initialised) and killed at ``LM_SHARDED_DEADLINE_S``: every rank's row;
    raises with the tracebacks of the ranks that failed or hung."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    world = LM_SHARDED_WORLD[0] * LM_SHARDED_WORLD[1]
    out = os.path.join(tmp, "rank%d.json")
    procs = [ctx.Process(target=lm_sharded_rank, args=(r, world, os.path.join(tmp, "store"), out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + LM_SHARDED_DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    rows = []
    for r in range(world):
        try:
            with open(out % r) as fh:
                rows.append(json.load(fh))
        except FileNotFoundError:
            rows.append({"rank": r, "error": "left no result"})
    errors = [f"rank {row['rank']}: {row['error']}" for row in rows if "error" in row]
    check(not hung and not errors, f"lm_sharded gloo world: ranks {hung} hung past "
          f"{LM_SHARDED_DEADLINE_S} s; " + "\n".join(errors))
    return rows


def phase_lm_sharded(dev) -> None:
    """The sharded LM on ``torch.distributed`` (``shard/collectives.py``,
    the plan branches of ``models/``, the sharded train step, the
    compressed all-reduce, elastic checkpoints), f32, on the global batch
    of ``LM_SHARDED_BATCH`` sequences of ``LM_SHARDED_SEQ``:

    (1) a one-rank NCCL world (``opt_mesh``, 1 x 1): smollm-360m at full
        width and depth, ``LM_SHARDED_STEPS`` sharded steps held to the
        unsharded port step on the same card, weights and batch (loss
        rtol 1e-5, parameters rtol 5e-4 / atol 1e-5), step ms beside the
        unsharded step's, peak memory; its checkpoint saved and restored
        bit for bit; then one step on a 1 x 1 x 1 ``(pod, data, model)``
        mesh, held likewise, so that NCCL carries the pod plan's groups;
    (2) a 2 x 2 gloo world of four spawned processes on the one card, with
        CUDA tensors (NCCL takes one rank per card): smollm-360m at full
        width ("seq" attention: 15 heads on 2 model ranks; vocabulary over
        ``model``; FSDP of d = 960 over ``data``) with its depth cut to
        ``LM_SHARDED_BLOCKS`` blocks, and the reduced MoE arch, each held
        to the unsharded step; the compressed all-reduce of real gradients
        within its one-shot bound; the checkpoint restored on a 1 x 4 mesh
        bit for bit.  The same four ranks then build the 2 x 1 x 2 and
        2 x 2 x 1 ``(pod, data, model)`` meshes (the batch over ``(pod,
        data)``, FSDP within a pod, every gradient summed across the
        pods) and run the same checks there, the compressed all-reduce
        over ``pod`` and the checkpoint saved on 2 x 1 x 2 restored on the
        2 x 2 mesh.  Per rank and mesh: step ms, the bytes and calls of
        each collective call site per step, peak memory.  Gloo stages
        CUDA tensors through host memory itself; the port adds no staging
        of its own."""
    import dataclasses
    import tempfile

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.shard.plans import MeshPlan
    from repro_torch.train import data

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config(LM_ARCH), dtype="float32")
    plan = MeshPlan.from_mesh(opt_mesh(dev))
    model = tf.Transformer(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == LM_PARAMS, f"{LM_ARCH}: {n_params} parameters, not {LM_PARAMS}")
    batch = data.lm_batch(cfg, LM_SHARDED_BATCH, LM_SHARDED_SEQ, step=0)
    row, sharded, state = hold_sharded(cfg, batch, plan, model, LM_SHARDED_STEPS, dev)
    del model
    torch.cuda.empty_cache()
    emit("lm_sharded", part="nccl_1x1", arch=LM_ARCH, params=n_params, world=[1, 1], backend="nccl",
         batch=LM_SHARDED_BATCH, seq=LM_SHARDED_SEQ, **row)
    check(sharded_agrees(row), "lm_sharded 1x1: the sharded step left the unsharded one's tolerance "
          f"({ {k: row[k] for k in SHARDED_EXCESSES} })")
    with tempfile.TemporaryDirectory() as tmp:
        trip = sharded_round_trip(sharded, state, cfg, tmp, plan, dev)
    del sharded, state
    torch.cuda.empty_cache()
    emit("lm_sharded", part="nccl_checkpoint", **trip)
    check(trip["bit_equal"], "lm_sharded 1x1: the restored checkpoint differs")
    # the same step once on a (1, 1, 1) pod mesh: NCCL carries the groups of
    # every set of the three axes
    pod_plan = MeshPlan.from_mesh(init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model")))
    row, _, _ = hold_sharded(cfg, batch, pod_plan, tf.Transformer(cfg, device=dev, seed=0), 1, dev)
    torch.cuda.empty_cache()
    emit("lm_sharded", part="nccl_1x1x1", arch=LM_ARCH, params=n_params, world=[1, 1, 1], backend="nccl",
         batch=LM_SHARDED_BATCH, seq=LM_SHARDED_SEQ, **row)
    check(sharded_agrees(row), "lm_sharded 1x1x1: the sharded step left the unsharded one's tolerance "
          f"({ {k: row[k] for k in SHARDED_EXCESSES} })")

    with tempfile.TemporaryDirectory() as tmp:
        rows = run_gloo_world(tmp)
    for r in rows:
        for name, part in r["parts"].items():
            check_gloo_part(r["rank"], name, part, cfg)
    emit("lm_sharded", part="phase", seconds=time.perf_counter() - t_phase)


def check_gloo_part(rank: int, name: str, part: dict, cfg) -> None:
    """Print and check one rank's ``sharded_mesh_part`` of the mesh
    ``name``: both archs within the unsharded steps' tolerance, the
    compressed all-reduce within its bound, the checkpoint bit for bit,
    the grouped MoE dispatch within the plain one's per group (whose
    groups must drop other tokens than the whole batch)."""
    for arch, key in ((LM_ARCH, "smollm"), (LM_SHARDED_MOE_ARCH, "moe")):
        row = part[key]
        emit("lm_sharded", part=f"gloo_{name}", rank=rank, coords=part["coords"], arch=arch,
             backend="gloo", staging="inside ProcessGroupGloo (CUDA tensors via host memory)",
             reduced={"n_layers": [cfg.n_layers, LM_SHARDED_BLOCKS]} if key == "smollm" else "reduce_config",
             **row)
        check(sharded_agrees(row), f"lm_sharded {name} rank {rank} {arch}: the sharded step left "
              f"the unsharded one's tolerance ({ {k: row[k] for k in SHARDED_EXCESSES} })")
    groups = part["moe_groups"]
    emit("lm_sharded", part=f"gloo_{name}_extras", rank=rank, compressed=part["compressed"],
         checkpoint=part.get("checkpoint"), moe_groups=groups, seconds=part["seconds"])
    check(groups["y_excess"] <= 0 and groups["aux_excess"] <= 0 and groups["groups_drop_other_tokens"],
          f"lm_sharded {name} rank {rank}: the grouped MoE dispatch left the plain one per group ({groups})")
    check(part["compressed"]["worst_error_over_bound"] <= LM_SHARDED_COMPRESSED_LIMIT,
          f"lm_sharded {name} rank {rank}: compressed all-reduce over "
          f"{part['compressed']['axis']} past half of max|g| / 127")
    trip = part.get("checkpoint")
    check(trip is None or (trip["saved_equal"] and trip["bit_equal"]),
          f"lm_sharded {name} rank {rank}: the saved or the restored state differs")


# ---------------------------------------------------------------------- #
# The dry run and the roofline
# ---------------------------------------------------------------------- #

ROOFLINE_WORKERS = 6  # worker processes counting the dry-run cells (the machine has 8 cores)
ROOFLINE_SHARE_LIMIT = 1.05  # bound / measured above this is a counting fault
ROOFLINE_REPS = 5
ROOFLINE_CFPQ_N = 65536  # closure_64k
ROOFLINE_CFPQ_REPS = 2  # about 5.4 s a call (PERF.md §6)


def roofline_components(dev) -> list[tuple]:
    """``(cell, build, reps)`` of the card phase: ``build(device)`` makes
    the cell's components, ``{name: run it once}``; the same builder on
    the card and on meta, so the counts are of the very work timed."""
    from repro_torch.configs import registry
    from repro_torch.core.closure import opt_step
    from repro_torch.launch import components, specs
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import deepfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step

    lm = registry.get_config(LM_ARCH)
    train = next(s for s in registry.get_shapes(LM_ARCH) if s.name == "train_4k")
    # 2 sequences: the 16 x 16 mesh's per-rank microbatch, 256 / 8 / 16
    mb = train.dim("global_batch") // specs.N_MICRO // 16

    def lm_train(device):
        # block_fwd, block_fwdbwd, head_fwdbwd and opt share their model
        return {c.name: c.fn for c in components.lm_components(
            lm, train, device=device, mb=mb, act_dtype="float32")}

    decode = next(s for s in registry.get_shapes(LM_ARCH) if s.name == "decode_32k")
    batch, seq = decode.dim("global_batch") // 16, decode.dim("seq_len")

    def lm_decode(device):
        model = tf.Transformer(lm, device=device).to(torch.bfloat16)
        cache = tf.init_cache(lm, batch, seq, dtype=torch.bfloat16, device=device)
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        return {"serve_step": lambda: tf.serve_step(model, cache, tokens, seq - 1, lm)}

    rs = registry.get_config("deepfm")
    examples = next(s for s in registry.get_shapes("deepfm") if s.name == "train_batch").dim("batch") // 16

    def deepfm_train(device):
        model = deepfm.DeepFM(rs, device=device)
        ocfg = opt.OptimizerConfig()
        state = opt.init_opt_state(model, ocfg)
        gen = None if torch.device(device).type == "meta" else torch.Generator(device=device).manual_seed(7)
        shape = (examples, rs.n_sparse, rs.multi_hot)

        def draw(fn, *a, dtype):
            if gen is None:
                return torch.empty(a[-1], dtype=dtype, device=device)
            return fn(*a, generator=gen, device=device).to(dtype)

        b = {"sparse_ids": draw(torch.randint, 0, rs.vocab_per_field, shape, dtype=torch.int32),
             "sparse_mask": draw(torch.rand, shape, dtype=torch.float32).round(),
             "dense_feat": draw(torch.randn, (examples, rs.n_dense), dtype=torch.float32),
             "labels": draw(torch.randint, 0, 2, (examples,), dtype=torch.int32)}
        step = make_train_step(rs, ocfg)
        return {"train_step": lambda: step(model, state, b)}

    g, tables = specs.cfpq_grammar_tables()
    n = ROOFLINE_CFPQ_N

    def cfpq_opt(device):
        # every bit set: the meta count is at full density (meta has no
        # data), and so is the work these words need
        Tp = torch.full((g.n_nonterms, n, n // 32), -1, dtype=torch.int32, device=device)
        return {"opt_step": lambda: opt_step(Tp, tables, n, None)}

    return [((LM_ARCH, "train_4k"), lm_train, ROOFLINE_REPS),
            ((LM_ARCH, "decode_32k"), lm_decode, ROOFLINE_REPS),
            (("deepfm", "train_batch"), deepfm_train, ROOFLINE_REPS),
            (("cfpq", "closure_64k"), cfpq_opt, ROOFLINE_CFPQ_REPS)]


def phase_roofline(dev) -> None:
    """The port's dry run and roofline (``launch/dryrun.py``,
    ``roofline/analysis.py``), then its counter held to the card.

    First the components of the card phase: each cell's built once on the
    card with whole parameters (1 x 1, no collectives) and once on
    ``meta`` with the same shapes; each component counted on meta (FLOPs
    by dtype, bytes, peak live bytes) and timed on the card (CUDA-event
    median of ``reps`` runs after a warm-up).  The bound is max(sum FLOPs
    / peak of their dtype, bytes / HBM); a share bound / measured above
    ``ROOFLINE_SHARE_LIMIT`` fails the phase (a count above what the card
    did is a counting fault).  The cfpq component launches ``repro_bitmm``.
    Then every single-pod cell and the multi-pod LM train and prefill cells
    (counted per rank, as on one pod) are counted on meta by
    ``dryrun.orchestrate`` in ``ROOFLINE_WORKERS`` spawned workers, into
    JSON under ``chiprun_out/roofline/``: one line per cell, a table per
    mesh, the named skips."""
    import shutil

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import production_plan
    from repro_torch.roofline import analysis
    from repro_torch.roofline.count import Counter

    for cell, build, reps in roofline_components(dev):
        on_meta = build("meta")  # built outside the count: only the runs are counted
        on_card = build(dev)
        for name, fn in on_card.items():
            t0 = time.perf_counter()
            with Counter() as c:
                on_meta[name]()
            counted = c.summary()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            launches = kops.launches
            ms = time_ms(fn, reps=reps, warmup=1)
            peak = torch.cuda.max_memory_allocated() - held
            bitmm = kops.launches - launches
            by = counted["flops_by_dtype"]
            ops_ms = analysis.compute_seconds(counted["flops"], by) * 1e3
            bytes_ms = counted["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
            bound = max(ops_ms, bytes_ms)
            share = bound / ms
            emit("roofline_component", arch=cell[0], shape=cell[1], component=name, ms=ms, reps=reps,
                 flops_by_dtype=by, bytes=counted["bytes_accessed"],
                 transcendentals=counted["transcendentals"], ops_ms=ops_ms, bytes_ms=bytes_ms,
                 bound_ms=bound, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                 share=share, meta_peak_bytes=counted["peak_bytes"], card_peak_extra_bytes=peak,
                 card_max_memory_allocated=peak + held,
                 bitmm_launches=bitmm, kernels_counted=counted["kernels"],
                 seconds=time.perf_counter() - t0)
            check(share <= ROOFLINE_SHARE_LIMIT,
                  f"roofline {cell} {name}: the count's bound {bound:.3f} ms exceeds the card's "
                  f"{ms:.3f} ms (share {share:.3f})")
            if cell[0] == "cfpq":
                check(bitmm > 0, "roofline: the cfpq component launched no repro_bitmm")
        del on_meta, on_card, fn
        torch.cuda.empty_cache()
    t_sweep = time.perf_counter()
    jobs, skips = dryrun.iter_jobs(meshes=("single",))
    pods = production_plan(multi_pod=True)
    jobs += [job for job in dryrun.iter_jobs(meshes=("multi",))[0]
             if specs.build_cell(job[0], job[1], pods).method == "per_rank"]
    out_dir = Path("chiprun_out") / "roofline" / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)  # a job whose JSON exists counts as done
    failures = dryrun.orchestrate(jobs, str(out_dir), ROOFLINE_WORKERS, timeout=120)
    check(not failures, f"roofline: cells failed to count: {failures}")
    results = [json.loads((out_dir / f"{'__'.join(job)}.json").read_text()) for job in jobs]
    rows = [analysis.compose_row(r, []) for r in results]
    for r, row in zip(results, rows):
        emit("roofline_cell", arch=r["arch"], shape=r["shape"], mesh=r["mesh"], method=r["method"],
             flops=row.get("flops_dev"), bytes=row.get("bytes_dev"),
             coll_bytes=row.get("coll_bytes_dev"), args_bytes=row["args_bytes_dev"],
             temp_bytes=row["hbm_bytes_dev"], fits=row["fits"], dominant=row.get("dominant"),
             count_s=r["compile_s"])
    for arch, shape, mesh, why in skips:
        emit("roofline_skip", arch=arch, shape=shape, mesh=mesh, reason=why)
    for mesh in ("single", "multi"):
        print(analysis.format_table([row for row in rows if row["mesh"] == mesh]), flush=True)
    check(all(r["cost"] is not None and r["cost"]["flops"] >= 0 for r in results),
          "roofline: a cell of either mesh was not counted")
    emit("roofline", cells=len(results), skips=len(skips), sweep_seconds=time.perf_counter() - t_sweep,
         workers=ROOFLINE_WORKERS, json_dir=str(out_dir))


def phase_packing(dev) -> None:
    """``pack_bits`` and ``unpack_bits`` on the main path's all-pairs state
    (Query 1 on pizza x 16: bool ``(7, 15872, 15872)``, 1.76 GB) against
    their 32-step forms: equal results, then device and event times in
    turns (library, loop, loop, library), peak memory above the operands,
    and the byte bound (the bool state read or written once)."""
    from repro_torch.core.grammar import query1_grammar
    from repro_torch.core.graph import paper_table_graph
    from repro_torch.core.matrices import init_matrix, pack_bits, unpack_bits

    g = query1_grammar().to_cnf()
    graph = paper_table_graph(BASE_GRAPH).repeat(PIZZA_COPIES)
    T = init_matrix(graph, g, device=dev)
    n = T.shape[-1]
    P = pack_bits(T)
    check(torch.equal(P, pack_loop(T)), "pack_bits != its 32-step form")
    check(torch.equal(unpack_bits(P, n), T), "unpack_bits(pack_bits(T)) != T")
    check(torch.equal(unpack_loop(P, n), T), "the 32-step unpack != T")
    forms = {
        "pack": {"library": lambda: pack_bits(T), "loop": lambda: pack_loop(T)},
        "unpack": {"library": lambda: unpack_bits(P, n),
                   "loop": lambda: unpack_loop(P, n)},
    }
    rows = {}
    for op, fns in forms.items():
        row = rows[op] = {"bound_ms": (T.numel() + P.numel() * 4) / HBM_BYTES_PER_MS}
        for form in ("library", "loop", "loop", "library"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            entry = row.setdefault(form, {"device_ms": [], "event_ms": []})
            entry["device_ms"].append(device_ms(fns[form], reps=10))
            entry["event_ms"].append(time_ms(fns[form], reps=10))
            entry["peak_extra_bytes"] = torch.cuda.max_memory_allocated() - held
    emit("packing", shape=list(T.shape), bool_bytes=T.numel(),
         packed_bytes=P.numel() * 4, **rows)


def load_baselines(bitmm_cu: Path):
    """Build another revision's kernels: its ``bitmm.cu`` and, where they
    lie beside it, its ``minplus.cu`` and ``count_mm.cu``.  Returns the
    bitmm library and ``{"minplus": lib, "count_mm": lib}``, and prints the
    build's registers and spills per instance."""
    from repro_torch.kernels import bitmm as kbitmm
    from repro_torch.kernels import count_mm as kcount
    from repro_torch.kernels import minplus as kminplus

    base, _ = kbitmm.load(bitmm_cu)
    libs, instances = {}, {}
    for name, mod, parse in (("minplus", kminplus, minplus_instances),
                             ("count_mm", kcount, count_instances)):
        source = bitmm_cu.parent / f"{name}.cu"
        if source.exists():
            libs[name], info = kbitmm.load(source, mod.ENTRIES)
            instances[name] = parse(info["log"])
    emit("baseline_build", source=str(bitmm_cu.parent), kernels=sorted(libs),
         instances=instances)
    return base, libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline-cu", type=Path, default=None,
        help="another revision's csrc/bitmm.cu: its kernels are also timed "
             "(device time) on the kernel_timing rows' operands, and the "
             "minplus.cu and count_mm.cu beside it on the minplus_timing and "
             "count_mm_timing rows' operands")
    parser.add_argument(
        "--packing", action="store_true",
        help="only time pack_bits and unpack_bits on the main path's state "
             "against their 32-step forms (no build, no result line)")
    args = parser.parse_args()

    t_script = time.perf_counter()
    info = timed("device", phase_device)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.packing:
        phase_packing(dev)
        return
    timed("build", phase_build)
    base, rows_base = None, {}
    if args.baseline_cu is not None:
        base, rows_base = timed("baseline_build", load_baselines, args.baseline_cu.resolve())
    timed("kernel_checks", phase_kernel_checks, dev)
    timed("bitmm_or_checks", phase_bitmm_or_checks, dev)
    tile_err = timed("tile_checks", phase_tile_checks, dev)
    minplus_err = timed("minplus_checks", phase_minplus_checks, dev)
    timed("count_checks", phase_count_checks, dev)
    T, tables, launches = timed("main_path", phase_main_path, dev)
    repair = timed("delta", phase_delta, dev)
    tile_launches = timed("blocksparse_engine", phase_blocksparse_engine, dev)
    state = timed("blocksparse_scale", phase_blocksparse_scale, dev)
    tile_err = max(tile_err, timed("tile_checks_scale", phase_tile_checks, dev, state))
    tile_row = timed("tile_timing", tile_timing, state, tile_launches, tile_err)
    del state
    torch.cuda.empty_cache()
    minplus_launches, minplus_row = 0, None
    for backend in ("dense", "frontier", "auto"):
        n, timing = timed(
            f"single_path_{backend}", phase_single_path,
            dev, backend, minplus_err if backend == "dense" else None,
            rows_base.get("minplus"))
        minplus_launches += n
        minplus_row = minplus_row or timing
    minplus_row["launches"] = minplus_launches
    timed("serve", phase_serve, dev)
    timed("conjunctive", phase_conjunctive, dev)
    _, count_rows = timed("count", phase_count, dev, rows_base.get("count_mm"))
    kernels = timed("kernel_timing", phase_kernel_timing, T, tables, launches, repair, base)
    del T
    torch.cuda.empty_cache()
    opt = timed("opt", phase_opt, dev)
    cal = timed("calibrate", phase_calibrate, dev)
    timed("lm_serve", phase_lm_serve, dev)
    timed("lm_train", phase_lm_train, dev)
    timed("deepfm_train", phase_deepfm_train, dev)
    timed("gnn_train", phase_gnn_train, dev)
    timed("lm_sharded", phase_lm_sharded, dev)
    timed("roofline", phase_roofline, dev)
    emit("script", phase_seconds=time.perf_counter() - t_script)
    # launches on the main paths: the earlier phases', the opt phase's and
    # the calibration's
    for more in (opt, cal):
        kernels[0]["launches"] += more["bitmm"]
        kernels[1]["launches"] += more["bitmm_or"]
        minplus_row["launches"] += more["minplus"]
    # the count row at the 16-source batch's shape: every number measured there
    print(json.dumps({"kernels": kernels + [tile_row, minplus_row, count_rows[-1]]}),
          flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()

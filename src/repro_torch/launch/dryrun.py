"""Dry run of the port: build every (arch x shape) cell on the production
meshes and count it on the ``meta`` device (the counterpart of the
reference's ``launch/dryrun.py``, which lowers and compiles with XLA).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 4

Needs no card: the cells' arguments are ``meta`` tensors and the counts
come from ``roofline/count.py``.  Single-cell mode writes
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
reference's keys: ``lower_s`` is the seconds the cell took to build,
``compile_s`` the seconds its count took, ``memory`` holds the per-rank
argument, output and aliased (donated) bytes from the specs and, as
``temp_bytes``, the counter's peak of live bytes (``code_bytes`` is
null); ``method`` says how the count was made (``launch/specs.py``).
``--all`` counts the cells in a pool of spawned worker processes
(``orchestrate``): a worker imports torch once and keeps its warm caches,
where a process per cell, as the reference runs its compiles, would pay
the imports and the first calls of every op again for each cell.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../artifacts/dryrun_torch")


def _json(x):
    if isinstance(x, dict):
        return {str(k): _json(v) for k, v in x.items()}
    if isinstance(x, float) and x.is_integer():
        return int(x)
    return x


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str | None, engine=None) -> dict:
    """Build and count one cell; write its JSON under ``out_dir`` (unless
    None) and return it."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import production_plan

    t0 = time.time()
    plan = production_plan(multi_pod=mesh_kind == "multi")
    kw = {"engine": engine} if engine else {}
    cell = specs.build_cell(arch, shape, plan, **kw)
    t_build = time.time() - t0
    args_bytes = sum(specs.per_rank_bytes(a, s, plan) for a, s in zip(cell.args, cell.in_specs))
    out_bytes = specs.per_rank_bytes(cell.out, cell.out_specs, plan)
    alias = sum(specs.per_rank_bytes(cell.args[i], cell.in_specs[i], plan) for i in cell.donate_argnums)
    counted = specs.count_cell(cell)
    cost = {"flops": counted["flops"], "bytes_accessed": counted["bytes_accessed"],
            "transcendentals": counted["transcendentals"],
            "flops_by_dtype": counted["flops_by_dtype"], "ops": counted["ops"],
            "kernels": counted["kernels"]}
    coll, temp, depth = counted["collectives"], counted["peak_bytes"], counted.get("depth")
    t_count = time.time() - t0 - t_build
    result = _json({
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "n_devices": plan.world,
        "engine": engine,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_count, 2),
        "memory": {
            "argument_bytes": args_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "code_bytes": None,
        },
        "cost": cost,
        "collectives": coll,
        "note": cell.note,
        "method": cell.method,
        "depth": depth,
    })
    tag = f"{arch}__{shape}__{mesh_kind}" + (f"__{engine}" if engine else "")
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as fh:
            json.dump(result, fh, indent=1)
    return result


def iter_jobs(meshes=("single", "multi")):
    from repro_torch.configs import registry

    jobs, skips = [], []
    for arch, shape, skip in registry.all_cells():
        for mesh_kind in meshes:
            if skip:
                skips.append((arch, shape.name, mesh_kind, skip))
            else:
                jobs.append((arch, shape.name, mesh_kind))
    # the paper's CFPQ workload on the production meshes
    for shape in ("closure_64k", "closure_256k"):
        for mesh_kind in meshes:
            jobs.append(("cfpq", shape, mesh_kind))
    return jobs, skips


def orchestrate(jobs, out_dir: str, n_jobs: int, timeout: float = 3600, log=None):
    """Count ``jobs`` in ``n_jobs`` spawned worker processes, each job's
    JSON written under ``out_dir``; a job whose JSON exists is done.
    Returns the failures, ``(job, why)``: a job that raised, with its
    traceback, and one not done ``timeout`` seconds after the sweep began
    (a worker that dies loses its job to that deadline; the workers are
    stopped on return).  ``log`` (a function of one string) hears of each
    job's end."""
    import multiprocessing as mp

    log = log or (lambda line: None)
    pending = [job for job in jobs
               if not os.path.exists(os.path.join(out_dir, "__".join(job) + ".json"))]
    done, failures = len(jobs) - len(pending), []
    if not pending:
        return failures
    deadline = time.monotonic() + timeout
    with mp.get_context("spawn").Pool(min(n_jobs, len(pending))) as pool:
        results = [(job, pool.apply_async(run_cell, (*job, out_dir))) for job in pending]
        for job, res in results:
            try:
                res.get(max(0.0, deadline - time.monotonic()))
            except mp.TimeoutError:
                failures.append((job, "timeout"))
                log(f"[dryrun] FAIL {job}: timeout")
            except Exception as e:  # the worker's error, its traceback attached
                why = "".join(traceback.format_exception(e))[-2000:]
                failures.append((job, why))
                log(f"[dryrun] FAIL {job}:\n{why}")
            else:
                done += 1
                log(f"[dryrun] done {job} ({done} total)")
    return failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--engine", default=None, help="cfpq engine override")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out_dir = args.out or os.path.normpath(OUT_DIR)
    if args.all:
        jobs, skips = iter_jobs()
        for s in skips:
            print(f"[dryrun] SKIP {s[0]} x {s[1]} ({s[2]}): {s[3]}")
        failures = orchestrate(jobs, out_dir, args.jobs, log=print)
        if failures:
            print(f"[dryrun] {len(failures)} FAILURES")
            for j, why in failures:
                print(" ", j, why.splitlines()[-1] if why else "")
            sys.exit(1)
        print(f"[dryrun] all {len(jobs)} cells passed; {len(skips)} noted skips")
    else:
        r = run_cell(args.arch, args.shape, args.mesh, out_dir, args.engine)
        tag = f"{args.arch}__{args.shape}__{args.mesh}" + (f"__{args.engine}" if args.engine else "")
        flops = None if r["cost"] is None else r["cost"]["flops"]
        print(f"[dryrun] OK {tag}  count={r['compile_s']:.1f}s method={r['method']} "
              f"temp={r['memory']['temp_bytes']}  flops={flops}")
        print(json.dumps(r["memory"]))


if __name__ == "__main__":
    main()

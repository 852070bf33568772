"""HLO text analysis: collective-traffic accounting for the roofline (a copy
of the reference's ``roofline/hlo.py``; the ring model is factored out as
:func:`moved_bytes`, which ``roofline/count.py`` prices the port's own
collectives with).

``cost_analysis()`` has FLOPs and HBM bytes but NOT collective bytes — we
parse the compiled module text and sum the data moved by every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute.

Per-device moved-bytes model (bidirectional ring over a group of k):
  all-gather       out_bytes * (k-1)/k     (receives everyone's shard)
  all-reduce       out_bytes * 2(k-1)/k    (reduce-scatter + all-gather)
  reduce-scatter   out_bytes * (k-1)      ~ in_bytes * (k-1)/k
  all-to-all       out_bytes * (k-1)/k
  collective-permute  out_bytes
"""
from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?P<type>\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([0-9, ]*)\}")
_GROUPS_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_V2_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        ids = [x for x in m.group(1).split(",") if x.strip()]
        return max(1, len(ids))
    return default


def moved_bytes(op: str, b: int, k: int) -> float:
    """Per-device bytes moved by one ``op`` whose output is ``b`` bytes on
    a group of ``k`` ranks (the ring model of the module's docstring)."""
    if op == "all-gather":
        return b * (k - 1) / k
    if op == "all-reduce":
        return b * 2 * (k - 1) / k
    if op == "reduce-scatter":
        return b * (k - 1)
    if op == "all-to-all":
        return b * (k - 1) / k
    return b  # collective-permute


def collective_stats(hlo_text: str, n_devices: int) -> dict:
    """-> {op: {"count": int, "out_bytes": int, "moved_bytes": float}} plus
    a "_total" entry.  moved_bytes is the per-device traffic estimate."""
    out: dict = defaultdict(lambda: {"count": 0, "out_bytes": 0, "moved_bytes": 0.0})
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue  # async pair: count the -start only
        m = _COLL_RE.search(line)
        if not m:
            continue
        op = m.group("op")
        b = _shape_bytes(m.group("type"))
        k = _group_size(line, n_devices)
        if k <= 1:
            continue
        moved = moved_bytes(op, b, k)
        rec = out[op]
        rec["count"] += 1
        rec["out_bytes"] += b
        rec["moved_bytes"] += moved
    total = {
        "count": sum(r["count"] for r in out.values()),
        "out_bytes": sum(r["out_bytes"] for r in out.values()),
        "moved_bytes": sum(r["moved_bytes"] for r in out.values()),
    }
    result = dict(out)
    result["_total"] = total
    return result


def op_histogram(hlo_text: str, top: int = 15) -> list[tuple[str, int]]:
    """Most frequent HLO opcodes — quick structural profile of the program."""
    counts: dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        m = re.search(r"=\s*(?:\([^)]*\)|[a-z0-9]+\[[^\]]*\][^ ]*)\s+([a-z0-9-]+)\(", line)
        if m:
            counts[m.group(1)] += 1
    return sorted(counts.items(), key=lambda kv: -kv[1])[:top]

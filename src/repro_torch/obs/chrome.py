"""Span tree → Chrome ``trace_event`` JSON (openable in Perfetto).

The format is the JSON Array flavor of the Trace Event spec: complete
spans become ``ph: "X"`` events (microsecond ``ts``/``dur``), point
events become ``ph: "i"`` instants bound to their span's thread.  Span
identity travels in ``args`` (``span_id``/``parent_id``) so tests — and
scripts post-processing a trace — can reconstruct the tree exactly
rather than inferring nesting from timestamp containment.

Perfetto nests by (pid, tid, time containment); spans keep the thread id
they were opened on, so the serving loop's asyncio spans and the engine
worker-thread spans land on separate tracks of one process, with the
parent links in ``args`` preserving causality across tracks.  See
OBSERVABILITY.md → "Reading a trace in Perfetto".
"""
from __future__ import annotations

import json
from pathlib import Path

from .trace import Tracer


def to_chrome_trace(tracer: Tracer, process_name: str = "repro-cfpq") -> dict:
    """The tracer's spans/events as a Chrome-trace dict (pure data; use
    :func:`write_chrome_trace` to put it on disk)."""
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "tid": 0,
            "args": {"name": process_name},
        }
    ]
    tids = sorted({s.tid for s in tracer.spans})
    # renumber real thread ids onto small stable track numbers
    track = {tid: i for i, tid in enumerate(tids)}
    for s in tracer.spans:
        t_end = s.t_end if s.t_end is not None else s.t_start
        events.append(
            {
                "name": s.name,
                "cat": s.cat or "span",
                "ph": "X",
                "pid": 1,
                "tid": track.get(s.tid, 0),
                "ts": s.t_start * 1e6,
                "dur": max(t_end - s.t_start, 0.0) * 1e6,
                "args": {
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    **s.attrs,
                },
            }
        )
        for ev in s.events:
            events.append(
                {
                    "name": ev["name"],
                    "cat": s.cat or "span",
                    "ph": "i",
                    "s": "t",  # thread-scoped instant
                    "pid": 1,
                    "tid": track.get(s.tid, 0),
                    "ts": ev["t"] * 1e6,
                    "args": {"span_id": s.span_id, **ev["args"]},
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_spans": tracer.dropped},
    }


def write_chrome_trace(
    path, tracer: Tracer, process_name: str = "repro-cfpq"
) -> dict:
    """Write :func:`to_chrome_trace` JSON to ``path``; returns the dict."""
    doc = to_chrome_trace(tracer, process_name)
    Path(path).write_text(json.dumps(doc) + "\n")
    return doc

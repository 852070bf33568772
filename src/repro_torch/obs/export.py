"""Metric exposition: Prometheus text format, JSON snapshots, HTTP endpoint.

Two render targets over one :class:`~repro_torch.obs.metrics.MetricsRegistry`
(a copy of ``repro.obs.export``):

* :func:`render_prometheus` — the text exposition format (version 0.0.4)
  that Prometheus/VictoriaMetrics scrape: ``# HELP``/``# TYPE`` headers,
  labeled samples, histogram ``_bucket{le=...}``/``_sum``/``_count``
  series with cumulative counts.
* :func:`snapshot` — a JSON-ready dict with the same data plus optional
  structured sections: ``serve`` (:class:`ServeStats.as_dict`) and
  ``queries`` (per-query :meth:`QueryStats.to_dict` rows — the stable
  schema tests/test_obs.py round-trips).

:class:`MetricsEndpoint` serves both from a minimal asyncio HTTP
listener (``GET /metrics`` → text, ``GET /metrics.json`` → snapshot);
``CFPQServer`` starts one when ``ServeConfig.metrics_port`` is set.  The
endpoint speaks just enough HTTP/1.0 for a scraper or ``curl`` — no
dependency beyond asyncio.
"""
from __future__ import annotations

import asyncio
import json
from pathlib import Path
from typing import Callable

from .metrics import MetricsRegistry, REGISTRY


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats without the trailing .0."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _labelstr(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """The registry as Prometheus text exposition (one trailing newline)."""
    registry = REGISTRY if registry is None else registry
    lines: list[str] = []
    for fam in registry.families():
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for child in fam.children:
            if fam.kind == "histogram":
                for bound, cum in zip(child.bounds, child.cumulative()):
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labelstr(child.labels, {'le': _fmt(bound)})} {cum}"
                    )
                lines.append(
                    f"{fam.name}_bucket"
                    f"{_labelstr(child.labels, {'le': '+Inf'})} {child.count}"
                )
                lines.append(
                    f"{fam.name}_sum{_labelstr(child.labels)} {_fmt(child.sum)}"
                )
                lines.append(
                    f"{fam.name}_count{_labelstr(child.labels)} {child.count}"
                )
            else:
                lines.append(
                    f"{fam.name}{_labelstr(child.labels)} {_fmt(child.value)}"
                )
    return "\n".join(lines) + "\n"


def snapshot(
    registry: MetricsRegistry | None = None,
    serve_stats=None,
    query_stats=None,
    extra: dict | None = None,
) -> dict:
    """JSON-ready state dump: the registry plus optional structured
    sections.  ``query_stats`` is an iterable of ``QueryStats`` (or
    anything with ``to_dict()``) — the serve-only fields are omitted by
    ``to_dict`` when unset, and the round-trip test pins that schema."""
    registry = REGISTRY if registry is None else registry
    snap: dict = {"schema": 1, "metrics": registry.collect()}
    if serve_stats is not None:
        snap["serve"] = serve_stats.as_dict()
    if query_stats is not None:
        snap["queries"] = [q.to_dict() for q in query_stats]
    if extra:
        snap.update(extra)
    return snap


def write_metrics_json(path, **kwargs) -> dict:
    """Write :func:`snapshot` to ``path``; returns the snapshot."""
    snap = snapshot(**kwargs)
    Path(path).write_text(json.dumps(snap, indent=2, sort_keys=True) + "\n")
    return snap


class MetricsEndpoint:
    """Tiny asyncio HTTP listener exposing one registry.

    Routes: ``/metrics`` (Prometheus text), ``/metrics.json`` (snapshot).
    ``snapshot_extra`` is polled per request so the JSON view can include
    live serve-loop state without the endpoint holding a server reference
    cycle.  ``port=0`` binds an ephemeral port (tests); the bound port is
    on ``.port`` after :meth:`start`.
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        snapshot_extra: Callable[[], dict] | None = None,
    ) -> None:
        self.registry = REGISTRY if registry is None else registry
        self.host = host
        self.port = port
        self.snapshot_extra = snapshot_extra
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> "MetricsEndpoint":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _respond(self, path: str) -> tuple[str, str, str]:
        if path in ("/metrics", "/"):
            return "200 OK", "text/plain; version=0.0.4", render_prometheus(
                self.registry
            )
        if path == "/metrics.json":
            extra = self.snapshot_extra() if self.snapshot_extra else None
            body = json.dumps(
                snapshot(self.registry, **(extra or {})), sort_keys=True
            )
            return "200 OK", "application/json", body + "\n"
        return "404 Not Found", "text/plain", "not found\n"

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            request = await reader.readline()
            parts = request.decode("latin-1").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain headers; GETs carry no body
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            status, ctype, body = self._respond(path)
            payload = body.encode()
            writer.write(
                (
                    f"HTTP/1.0 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode()
                + payload
            )
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # scraper went away mid-request; nothing to clean up
        finally:
            writer.close()

"""Stdlib-only asyncio HTTP front door (DESIGN.md §14).

No aiohttp/fastapi in the image — the gateway speaks a minimal but
correct HTTP/1.1 over ``asyncio.start_server``: keep-alive, chunked
transfer for streamed responses, Content-Length everywhere else.

Routes:

- ``POST /v1/<app>/submit``           — submit one request, wait for the
  outcome, return it as JSON (429 + reason when admission refuses).
- ``POST /v1/<app>/submit?stream=1``  — same, but stream one NDJSON line
  per hop/drop event as it happens, ending with the ``done`` line.
- ``GET /metrics``                    — Prometheus text exposition from
  the gateway's :class:`~repro_torch.obs.metrics.MetricsRegistry`.
- ``GET /trace``                      — Chrome-trace JSON from the
  per-request :class:`~repro_torch.obs.tracing.Tracer` (open in Perfetto).
- ``GET /alerts``                     — the SLO error-budget plane's
  burn-rate alert state as JSON (DESIGN.md §17).
- ``GET /audit``                      — the control-plane flight
  recorder as NDJSON; filter with ``?app=&kind=&root_id=&t0=&t1=``,
  or ``?explain=<root_id>`` for one request's full decision chain.
- ``GET /healthz``                    — liveness + fleet stats.

``python -m repro_torch.gateway.server`` boots a demo two-app deployment
(plan via the MILP, serve via SimBackend) — see the README quickstart
for the matching curl lines.

A copy of the JAX package's ``gateway/server.py``.
"""
from __future__ import annotations

import argparse
import asyncio
import json
from typing import Any, Dict, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlsplit

from repro_torch.gateway.core import AdmissionRejected, AsyncGateway
from repro_torch.obs import Instrumentation, Tracer

__all__ = ["GatewayHTTPServer", "build_demo_gateway"]

_MAX_HEADER = 64 * 1024


class _HTTPError(Exception):
    def __init__(self, status: int, msg: str) -> None:
        super().__init__(msg)
        self.status = status
        self.msg = msg


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 429: "Too Many Requests",
            500: "Internal Server Error"}


class GatewayHTTPServer:
    """One :class:`AsyncGateway` behind an asyncio socket server."""

    def __init__(self, gateway: AsyncGateway, hooks: Instrumentation,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.gateway = gateway
        self.hooks = hooks
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        # serializes start/stop: a concurrent double-start would rebind
        # the already-resolved ephemeral port (jigsaw-lint asyncio_race)
        self._lifecycle_lock = asyncio.Lock()

    async def start(self) -> None:
        async with self._lifecycle_lock:
            if self._server is not None:
                return
            await self.gateway.start()
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        async with self._lifecycle_lock:
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()
                self._server = None
            await self.gateway.stop()

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    # -- connection loop ------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, path, headers, body = req
                keep = headers.get("connection", "keep-alive") != "close"
                try:
                    await self._route(method, path, body, writer, keep)
                except _HTTPError as e:
                    self._respond(writer, e.status,
                                  {"error": e.msg}, keep)
                except Exception as e:   # noqa: BLE001 — surface, don't die
                    self._respond(writer, 500,
                                  {"error": f"{type(e).__name__}: {e}"},
                                  keep)
                await writer.drain()
                if not keep:
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[
            Tuple[str, str, Dict[str, str], bytes]]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > _MAX_HEADER:
            raise _HTTPError(400, "headers too large")
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise _HTTPError(400, f"bad request line: {lines[0]!r}")
        method, target, _version = parts
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if not ln:
                continue
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0") or "0")
        body = await reader.readexactly(length) if length else b""
        return method, target, headers, body

    # -- routing --------------------------------------------------------
    async def _route(self, method: str, target: str, body: bytes,
                     writer: asyncio.StreamWriter, keep: bool) -> None:
        url = urlsplit(target)
        path = url.path.rstrip("/") or "/"
        query = parse_qs(url.query)
        if path == "/healthz" and method == "GET":
            self._respond(writer, 200,
                          dict(status="ok", **self.gateway.stats()), keep)
        elif path == "/metrics" and method == "GET":
            self._respond_text(writer, 200,
                               self.hooks.registry.render(),
                               "text/plain; version=0.0.4", keep)
        elif path == "/trace" and method == "GET":
            tr = self.hooks.tracer
            if tr is None:
                raise _HTTPError(404, "tracing disabled")
            self._respond(writer, 200, tr.chrome_trace(), keep)
        elif path == "/alerts" and method == "GET":
            slo = self.hooks.slo
            if slo is None:
                self._respond(writer, 200,
                              {"alerts": [], "rules": [], "budgets": {}},
                              keep)
            else:
                self._respond(writer, 200,
                              slo.alerts_json(self.gateway.now()), keep)
        elif path == "/audit" and method == "GET":
            audit = self.hooks.audit
            if audit is None:
                raise _HTTPError(404, "audit log disabled")
            explain = query.get("explain", [None])[0]
            if explain is not None:
                events = audit.explain(int(explain))
            else:
                t0 = query.get("t0", [None])[0]
                t1 = query.get("t1", [None])[0]
                rr = query.get("root_id", [None])[0]
                events = audit.query(
                    app=query.get("app", [None])[0],
                    kind=query.get("kind", [None])[0],
                    t0=float(t0) if t0 is not None else None,
                    t1=float(t1) if t1 is not None else None,
                    root_id=int(rr) if rr is not None else None)
            text = "".join(json.dumps(e.to_dict(), sort_keys=True) + "\n"
                           for e in events)
            self._respond_text(writer, 200, text,
                               "application/x-ndjson", keep)
        elif path.startswith("/v1/") and path.endswith("/submit"):
            if method != "POST":
                raise _HTTPError(405, "submit is POST")
            app = path[len("/v1/"):-len("/submit")]
            opts = json.loads(body) if body else {}
            stream = bool(opts.get("stream")) or \
                query.get("stream", ["0"])[0] not in ("0", "")
            await self._submit(app, stream, writer, keep)
        else:
            raise _HTTPError(404, f"no route {method} {path}")

    async def _submit(self, app: str, stream: bool,
                      writer: asyncio.StreamWriter, keep: bool) -> None:
        try:
            gr = await self.gateway.submit(app)
        except KeyError as e:
            raise _HTTPError(404, str(e))
        except AdmissionRejected as e:
            raise _HTTPError(429, e.reason)
        if not stream:
            await gr.done.wait()
            self._respond(writer, 200, gr.outcome or {}, keep)
            return
        # chunked NDJSON: one line per hop/drop, closing with "done"
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n")
        while True:
            ev = await gr.events.get()
            data = (json.dumps(ev) + "\n").encode()
            writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            await writer.drain()
            if ev.get("event") == "done":
                break
        writer.write(b"0\r\n\r\n")

    # -- response helpers ------------------------------------------------
    def _respond(self, writer: asyncio.StreamWriter, status: int,
                 obj: dict, keep: bool) -> None:
        self._respond_text(writer, status, json.dumps(obj),
                           "application/json", keep)

    def _respond_text(self, writer: asyncio.StreamWriter, status: int,
                      text: str, ctype: str, keep: bool) -> None:
        data = text.encode()
        conn = "keep-alive" if keep else "close"
        writer.write(
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"Connection: {conn}\r\n\r\n".encode() + data)


# ----------------------------------------------------------------------
def build_demo_gateway(apps: Sequence[str] = ("social_media",
                                              "traffic_analysis"), *,
                       plan_rps: float = 30.0, s_avail: int = 64,
                       time_scale: float = 1.0, seed: int = 0,
                       sample_every: int = 1,
                       backend: Any = None,
                       quotas: Optional[Dict[str, float]] = None,
                       retry_drops: bool = False
                       ) -> Tuple[AsyncGateway, Instrumentation]:
    """Plan each app with the MILP and wrap the deployment in an
    instrumented gateway — the shared entry point for the CLI, the smoke
    job, the benchmarks, and the tests.  The instrumentation carries the
    full observability plane: tracer, SLO error-budget ledgers with the
    SRE burn-rate rules, and the control-plane flight recorder."""
    from repro_torch.core.apps import get_app
    from repro_torch.core.milp import Planner
    from repro_torch.core.profiler import Profiler
    from repro_torch.obs import AuditLog, SloPlane

    hooks = Instrumentation(tracer=Tracer(sample_every=sample_every),
                            slo=SloPlane(), audit=AuditLog())
    planned = {}
    for name in apps:
        g = get_app(name)
        prof = Profiler(g)
        cfg = Planner(g, prof, s_avail=s_avail, max_tuples_per_task=32,
                      bb_nodes=4, bb_time_s=1.0).plan(plan_rps)
        if cfg is None:
            raise RuntimeError(f"no feasible plan for {name} "
                               f"at {plan_rps} rps / {s_avail} slices")
        planned[name] = (g, cfg)
    gw = AsyncGateway(planned, backend, seed=seed, hooks=hooks,
                      time_scale=time_scale, quotas=quotas,
                      retry_drops=retry_drops)
    return gw, hooks


async def _amain(args: argparse.Namespace) -> None:
    gw, hooks = build_demo_gateway(
        tuple(args.apps.split(",")), plan_rps=args.plan_rps,
        s_avail=args.s_avail, time_scale=args.time_scale)
    srv = GatewayHTTPServer(gw, hooks, args.host, args.port)
    await srv.start()
    print(f"gateway listening on http://{srv.host}:{srv.port} "
          f"apps={sorted(gw._apps)}", flush=True)
    try:
        await srv.serve_forever()
    finally:
        await srv.stop()


def main() -> None:
    ap = argparse.ArgumentParser(description="serve planned apps over HTTP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8780)
    ap.add_argument("--apps", default="social_media,traffic_analysis")
    ap.add_argument("--plan-rps", type=float, default=30.0)
    ap.add_argument("--s-avail", type=int, default=64)
    ap.add_argument("--time-scale", type=float, default=1.0)
    try:
        asyncio.run(_amain(ap.parse_args()))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

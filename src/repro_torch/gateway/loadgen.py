"""Scripted load-generator client for the gateway (DESIGN.md §14).

Two standard shapes:

- **Open loop** (:func:`open_loop`): per-app Poisson arrival processes
  at a target rate, independent of response times — the honest way to
  measure a serving system (no coordinated omission).
- **Closed loop** (:func:`closed_loop`): N workers per app, each
  submitting again the moment its previous request resolves — the
  saturation probe.

Both drive an async ``submit(app) -> outcome`` callable, so the same
loop load-tests an in-process :class:`~repro_torch.gateway.core.AsyncGateway`
(:func:`direct_submitter`) or a remote HTTP gateway over sockets
(:func:`http_submitter`), and both return a :class:`LoadReport` with
per-app attainment, latency percentiles and achieved throughput.

CLI: ``python -m repro_torch.gateway.loadgen --url http://127.0.0.1:8780
--apps social_media --rps 20 --duration 5``.

A copy of the JAX package's ``gateway/loadgen.py``.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Mapping
from urllib.parse import urlsplit

import numpy as np

__all__ = ["LoadReport", "closed_loop", "direct_submitter",
           "http_submitter", "open_loop"]

Submit = Callable[[str], Awaitable[dict]]


@dataclass
class _AppStats:
    submitted: int = 0
    ok: int = 0
    dropped: int = 0
    rejected: int = 0
    errors: int = 0
    deadline_met: int = 0
    retried: int = 0          # hops resubmitted by the gateway's
    retry_ok: int = 0         # retry-on-drop door policy (informational:
    latencies_ms: List[float] = field(default_factory=list)   # not in
    # the ok+dropped+rejected == submitted invariant, which holds
    # unchanged — a retried hop still resolves to exactly one outcome)

    def to_dict(self, wall_s: float) -> dict:
        lat = sorted(self.latencies_ms)

        def pct(p: float) -> float:
            return lat[min(int(p * len(lat)), len(lat) - 1)] if lat else 0.0

        done = self.ok + self.dropped
        return {
            "submitted": self.submitted, "ok": self.ok,
            "dropped": self.dropped, "rejected": self.rejected,
            "errors": self.errors,
            "deadline_met": self.deadline_met,
            "retried": self.retried, "retry_ok": self.retry_ok,
            "attainment": self.deadline_met / done if done else 0.0,
            "p50_ms": pct(0.50), "p99_ms": pct(0.99),
            "achieved_rps": done / wall_s if wall_s > 0 else 0.0,
        }


@dataclass
class LoadReport:
    """Aggregated load-run outcome (per app + totals)."""
    wall_s: float
    per_app: Dict[str, _AppStats]

    def to_dict(self) -> dict:
        apps = {a: s.to_dict(self.wall_s)
                for a, s in sorted(self.per_app.items())}
        tot = _AppStats()
        for s in self.per_app.values():
            tot.submitted += s.submitted
            tot.ok += s.ok
            tot.dropped += s.dropped
            tot.rejected += s.rejected
            tot.errors += s.errors
            tot.deadline_met += s.deadline_met
            tot.retried += s.retried
            tot.retry_ok += s.retry_ok
            tot.latencies_ms.extend(s.latencies_ms)
        return {"wall_s": self.wall_s, "apps": apps,
                "total": tot.to_dict(self.wall_s)}


def _account(st: _AppStats, outcome: dict) -> None:
    status = outcome.get("status")
    st.retried += int(outcome.get("retries", 0) or 0)
    st.retry_ok += int(outcome.get("retry_ok", 0) or 0)
    if status == "ok":
        st.ok += 1
        st.latencies_ms.append(float(outcome.get("latency_ms", 0.0)))
        if outcome.get("deadline_met"):
            st.deadline_met += 1
    elif status == "dropped":
        st.dropped += 1
    elif status == "rejected":
        st.rejected += 1
    else:
        st.errors += 1


async def _run(submit: Submit, app: str, st: _AppStats) -> None:
    st.submitted += 1
    try:
        outcome = await submit(app)
    except Exception:       # noqa: BLE001 — a load test keeps going
        st.errors += 1
        return
    _account(st, outcome)


async def open_loop(submit: Submit, rates: Mapping[str, float],
                    duration_s: float, *, seed: int = 0,
                    time_scale: float = 1.0) -> LoadReport:
    """Poisson arrivals per app at ``rates[app]`` requests per SIMULATED
    second for ``duration_s`` simulated seconds (wall duration =
    ``duration_s * time_scale``), never waiting on responses."""
    rng = np.random.default_rng(seed)
    stats = {a: _AppStats() for a in rates}
    pending: List[asyncio.Task] = []
    t0 = time.monotonic()

    async def arrivals(app: str, rate: float) -> None:
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / max(rate, 1e-9)))
            if t >= duration_s:
                return
            delay = t * time_scale - (time.monotonic() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            pending.append(asyncio.ensure_future(
                _run(submit, app, stats[app])))

    await asyncio.gather(*(arrivals(a, r) for a, r in rates.items()))
    if pending:
        await asyncio.gather(*pending)
    return LoadReport(time.monotonic() - t0, stats)


async def closed_loop(submit: Submit, workers: Mapping[str, int],
                      duration_s: float, *,
                      time_scale: float = 1.0) -> LoadReport:
    """``workers[app]`` concurrent workers per app, each re-submitting
    the moment its previous request resolves, for ``duration_s``
    simulated seconds."""
    stats = {a: _AppStats() for a in workers}
    t0 = time.monotonic()
    t_end = t0 + duration_s * time_scale

    async def worker(app: str) -> None:
        while time.monotonic() < t_end:
            await _run(submit, app, stats[app])

    await asyncio.gather(*(worker(a)
                           for a, n in workers.items()
                           for _ in range(n)))
    return LoadReport(time.monotonic() - t0, stats)


# ----------------------------------------------------------------------
def direct_submitter(gateway: Any) -> Submit:
    """Submit straight into an in-process AsyncGateway."""
    from repro_torch.gateway.core import AdmissionRejected

    async def submit(app: str) -> dict:
        try:
            gr = await gateway.submit(app)
        except AdmissionRejected as e:
            return {"status": "rejected", "reason": e.reason}
        await gr.done.wait()
        return dict(gr.outcome or {})

    return submit


def http_submitter(url: str) -> Submit:
    """Submit over HTTP (one short-lived connection per request — the
    closed-loop worker count bounds concurrency)."""
    u = urlsplit(url)
    host, port = u.hostname, u.port or 80

    async def submit(app: str) -> dict:
        reader, writer = await asyncio.open_connection(host, port)
        try:
            req = (f"POST /v1/{app}/submit HTTP/1.1\r\n"
                   f"Host: {host}\r\nContent-Length: 0\r\n"
                   f"Connection: close\r\n\r\n")
            writer.write(req.encode())
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        head, _, body = raw.partition(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1])
        if status == 429:
            return {"status": "rejected",
                    "reason": json.loads(body).get("error", "admission")}
        if status != 200:
            return {"status": "error", "http": status}
        return json.loads(body)

    return submit


# ----------------------------------------------------------------------
async def _amain(args: argparse.Namespace) -> None:
    apps = args.apps.split(",")
    submit = http_submitter(args.url)
    if args.closed > 0:
        report = await closed_loop(submit, {a: args.closed for a in apps},
                                   args.duration)
    else:
        report = await open_loop(submit, {a: args.rps for a in apps},
                                 args.duration, seed=args.seed)
    print(json.dumps(report.to_dict(), indent=2))


def main() -> None:
    ap = argparse.ArgumentParser(description="gateway load generator")
    ap.add_argument("--url", default="http://127.0.0.1:8780")
    ap.add_argument("--apps", default="social_media")
    ap.add_argument("--rps", type=float, default=10.0,
                    help="per-app open-loop Poisson rate")
    ap.add_argument("--closed", type=int, default=0,
                    help="closed-loop workers per app (overrides --rps)")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    asyncio.run(_amain(ap.parse_args()))


if __name__ == "__main__":
    main()

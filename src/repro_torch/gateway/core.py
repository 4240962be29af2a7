"""Live asyncio serving core (DESIGN.md §14).

:class:`AsyncGateway` promotes the simulator's control-plane rules to
the wall clock: the same per-``app::task`` queues, task-level batching
(``batch_ready`` / ``early_drop`` / ``next_poll_time`` from
``core/dispatch.py``), :class:`~repro_torch.runtime.metrics.Server` fleet and
per-app :class:`~repro_torch.core.frontend.Frontend` deadline stamping as
:class:`~repro_torch.runtime.cluster.ClusterRuntime` — but requests arrive by
``await gw.submit(app)`` instead of a Scenario, dispatchers are asyncio
tasks, and service times from the :class:`ExecutionBackend` are slept
in real time.

The gateway clock runs in the runtime's *simulated* seconds: ``now()``
is wall time divided by ``time_scale``, and sleeps multiply back.  All
profiled quantities (batch timeouts, SLOs, service times) therefore
apply unchanged, and ``time_scale < 1`` runs a deployment faster than
real time (load tests), ``1.0`` serves live.

Admission control literally reuses the chaos ladder's level-1 logic:
a :class:`~repro_torch.chaos.degrade.DegradationLadder` held at level >= 1
gates every submit against the SLO-feasible entry-queue depth
(``_entry_cap``), and the gateway duck-types the runtime attributes the
ladder reads (``queues``, ``by_task``, ``_apps``, ``rng``).  Two more
door policies stack in front of it (DESIGN.md §17):

* **Per-app rps quotas** — an optional token bucket per app
  (``quotas=``) refuses arrivals beyond a contracted rate with reason
  ``"quota"``, BEFORE the ladder's load-dependent gate: a noisy
  neighbour's excess is refused even when the cluster has headroom.
* **Retry-on-drop** — with ``retry_drops=True`` a queued hop that the
  early-drop scan sheds (deadline still feasible) is resubmitted ONCE
  at the back of its queue instead of failing the root request.

A copy of the JAX package's ``gateway/core.py``.
"""
from __future__ import annotations

import asyncio
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from repro_torch.chaos.degrade import DegradationLadder
from repro_torch.core.dispatch import (QueuedRequest, batch_ready,
                                       early_drop, next_poll_time)
from repro_torch.core.frontend import Frontend
from repro_torch.core.milp import PlanConfig
from repro_torch.core.taskgraph import TaskGraph, qualify, split_qualified
from repro_torch.runtime.backend import ExecutionBackend, SimBackend
from repro_torch.runtime.cluster import _AppState
from repro_torch.runtime.metrics import Server

__all__ = ["AdmissionRejected", "AsyncGateway", "GatewayRequest"]

# floor on dispatcher timer waits: below this asyncio timer resolution
# costs more than the wait buys
_MIN_WAIT_S = 0.001


class AdmissionRejected(Exception):
    """Submit refused at the door (quota / ladder admission / shed)."""

    def __init__(self, app: str, reason: str) -> None:
        super().__init__(f"{app}: {reason}")
        self.app = app
        self.reason = reason


@dataclass
class _TokenBucket:
    """Per-app rps quota: ``rate`` tokens/s, up to ``burst`` banked."""
    rate: float
    burst: float
    tokens: float = 0.0
    t_last: float = 0.0

    def take(self, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens < 1.0:
            return False
        self.tokens -= 1.0
        return True


@dataclass
class GatewayRequest:
    """One accepted root request: streamed hop events + final outcome."""
    root_id: int
    app: str
    arrival_s: float
    deadline_s: float
    events: "asyncio.Queue" = field(default_factory=asyncio.Queue)
    done: "asyncio.Event" = field(default_factory=asyncio.Event)
    outstanding: int = 1
    completed: int = 0
    dropped: int = 0
    retries: int = 0
    retry_ok: int = 0
    finished_s: float = math.nan
    outcome: Optional[dict] = None

    def _finalize(self, now: float) -> dict:
        lat_ms = (now - self.arrival_s) * 1e3
        self.finished_s = now
        self.outcome = {
            "event": "done", "root_id": self.root_id, "app": self.app,
            "status": "ok" if self.dropped == 0 else "dropped",
            "latency_ms": lat_ms,
            "deadline_met": (self.dropped == 0
                             and now <= self.deadline_s + 1e-9),
            "completions": self.completed, "dropped": self.dropped,
            "retries": self.retries, "retry_ok": self.retry_ok}
        self.events.put_nowait(self.outcome)
        self.done.set()
        return self.outcome


class AsyncGateway:
    """Serve one or several planned apps live over asyncio."""

    def __init__(self, apps: Mapping[str, Tuple[TaskGraph, PlanConfig]],
                 backend: Optional[ExecutionBackend] = None, *,
                 seed: int = 0, staleness_ms: float = 20.0,
                 time_scale: float = 1.0, hooks: Any = None,
                 ladder: Optional[DegradationLadder] = None,
                 quotas: Optional[Mapping[str, float]] = None,
                 quota_burst: float = 10.0,
                 retry_drops: bool = False) -> None:
        if not apps:
            raise ValueError("need at least one app")
        self._apps: Dict[str, _AppState] = {
            name: _AppState(name, g, cfg, Frontend(g, app=name))
            for name, (g, cfg) in apps.items()}
        self.backend = backend if backend is not None else SimBackend()
        self.rng = np.random.default_rng(seed)
        self.staleness_ms = staleness_ms
        self.time_scale = float(time_scale)
        self.hooks = hooks
        # admission control IS the chaos ladder's level-1 rung: held at
        # level 1 it refuses arrivals beyond the SLO-feasible queue depth
        self.ladder = ladder if ladder is not None \
            else DegradationLadder(level=1)
        unknown = set(quotas or ()) - set(self._apps)
        if unknown:
            raise ValueError(f"quota for unknown app(s) {sorted(unknown)}")
        # per-app contracted rps: buckets start full (one burst banked)
        self._quota: Dict[str, _TokenBucket] = {
            name: _TokenBucket(rate=float(rps), burst=float(quota_burst),
                               tokens=float(quota_burst))
            for name, rps in (quotas or {}).items()}
        self.retry_drops = bool(retry_drops)
        self._retried: Set[int] = set()
        self.servers: List[Server] = []
        for name, st in self._apps.items():
            for tup, m in st.config.instances():
                for _ in range(m * tup.streams):
                    self.servers.append(
                        Server(tup, len(self.servers), app=name))
        self.by_task: Dict[str, List[Server]] = {}
        for s in self.servers:
            self.by_task.setdefault(qualify(s.app, s.tup.task),
                                    []).append(s)
        self.queues: Dict[str, List[QueuedRequest]] = {
            qualify(name, t): []
            for name, st in self._apps.items() for t in st.graph.tasks}
        self._timeout = {qualify(name, t): st.config.lhat(t)
                         for name, st in self._apps.items()
                         for t in st.graph.tasks}
        self._fastest = self._fastest_remaining()
        self._ids = itertools.count()
        self._roots: Dict[int, GatewayRequest] = {}
        # wake events exist from construction so submit() before start()
        # queues work instead of KeyError-ing; dispatchers attach later
        self._wake: Dict[str, asyncio.Event] = {
            qt: asyncio.Event() for qt in self.queues}
        self._tasks: List[asyncio.Task] = []
        self._running = False
        self._t0 = time.monotonic()
        if len(self._apps) == 1 and "" in self._apps:
            st = self._apps[""]
            self.backend.bind(st.graph, st.config)
        else:
            for name, st in self._apps.items():
                self.backend.bind(st.graph, st.config, app=name)

    # -- clock ---------------------------------------------------------
    def now(self) -> float:
        """Gateway time in SIMULATED seconds (wall / time_scale)."""
        return (time.monotonic() - self._t0) / self.time_scale

    def _fastest_remaining(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, st in self._apps.items():
            fastest_inst = {
                t: min(s.tup.latency_ms
                       for s in self.by_task[qualify(name, t)])
                for t in st.graph.tasks
                if self.by_task.get(qualify(name, t))}

            def rec(t: str) -> float:
                qt = qualify(name, t)
                if qt in out:
                    return out[qt]
                tail = max((rec(n) for n in st.graph.successors(t)),
                           default=0.0)
                out[qt] = fastest_inst.get(t, 0.0) + tail
                return out[qt]

            for t in st.graph.tasks:
                rec(t)
        return out

    # -- lifecycle -----------------------------------------------------
    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._t0 = time.monotonic()
        for qt in self.queues:
            self._tasks.append(
                asyncio.create_task(self._dispatch_loop(qt),
                                    name=f"dispatch:{qt}"))

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    # -- intake --------------------------------------------------------
    async def submit(self, app: str) -> GatewayRequest:
        """Admit one request for ``app``; raises
        :class:`AdmissionRejected` when the quota or ladder refuses it."""
        st = self._apps.get(app)
        if st is None:
            raise KeyError(f"unknown app {app!r} "
                           f"(gateway serves {sorted(self._apps)})")
        now = self.now()
        entry = st.graph.entry
        qt = qualify(app, entry)
        # contracted-rate quota FIRST: independent of cluster load, so a
        # noisy neighbour is refused even when the ladder would admit it
        bucket = self._quota.get(app)
        if bucket is not None and not bucket.take(now):
            if self.hooks is not None:
                self.hooks.on_admission_reject(app, "quota", now)
            raise AdmissionRejected(app, "quota")
        reason = self.ladder.gate(self, qt, now)
        if reason is not None:
            if self.hooks is not None:
                self.hooks.on_admission_reject(app, reason, now)
            raise AdmissionRejected(app, reason)
        meta = st.frontend.submit(now)
        rid = next(self._ids)
        # frontend deadlines carry the per-hop comm allowance; keep the
        # slo budget, re-anchored on the gateway clock
        gr = GatewayRequest(rid, app, now,
                            now + (meta.deadline_s - meta.arrival_s))
        self._roots[rid] = gr
        req = QueuedRequest(rid, rid, qt, now, gr.deadline_s)
        self.queues[qt].append(req)
        if self.hooks is not None:
            self.hooks.on_arrival(app, entry, now, len(self.queues[qt]))
        self._wake[qt].set()
        return gr

    # -- dispatch ------------------------------------------------------
    async def _dispatch_loop(self, qt: str) -> None:
        """One task-queue dispatcher: the asyncio twin of the runtime's
        ``try_dispatch`` — early-drop scan, greedy batch launch, then
        sleep until the head's batch timeout or a wake (new arrival /
        server freed)."""
        ev = self._wake[qt]
        while self._running:
            now = self.now()
            self._drop_scan(qt, now)
            self._try_launch(qt, now)
            q = self.queues[qt]
            delay = None
            if q:
                alive = [s for s in self.by_task.get(qt, ())
                         if s.retire_at > now]
                if alive:
                    t_poll = next_poll_time(
                        q[0].enqueue_t, self._timeout[qt],
                        min(s.busy_until for s in alive))
                    delay = max((t_poll - self.now()) * self.time_scale,
                                _MIN_WAIT_S)
            try:
                await asyncio.wait_for(ev.wait(), timeout=delay)
            except asyncio.TimeoutError:
                pass
            ev.clear()

    def _drop_scan(self, qt: str, now: float) -> None:
        q = self.queues[qt]
        if not q:
            return
        keep = []
        fastest = self._fastest.get(qt, 0.0)
        timeout = self._timeout[qt]
        for req in q:
            reason = early_drop(req, now, fastest, self.staleness_ms,
                                timeout)
            if reason is None:
                keep.append(req)
            else:
                rkey = ("deadline" if reason == "deadline_unreachable"
                        else reason)
                retry = self._drop(req, qt, rkey, now)
                if retry is not None:
                    keep.append(retry)
        self.queues[qt] = keep

    def _try_launch(self, qt: str, now: float) -> None:
        q = self.queues[qt]
        while q:
            idle = [s for s in self.by_task.get(qt, ())
                    if s.busy_until <= now + 1e-12
                    and s.retire_at > now + 1e-12]
            if not idle:
                return
            head_wait = (now - q[0].enqueue_t) * 1e3
            srv = max(idle, key=lambda s: s.tup.batch)
            if not batch_ready(len(q), srv.tup.batch, head_wait,
                               self._timeout[qt]):
                return
            if len(q) < srv.tup.batch:
                srv = min(idle, key=lambda s: s.tup.batch)
            batch = q[: srv.tup.batch]
            del q[: srv.tup.batch]
            service = self.backend.service_s(srv, batch, now, self.rng)
            srv.busy_until = now + service
            srv.served += len(batch)
            if self.hooks is not None:
                self.hooks.on_dispatch(srv, batch, now, service, len(q))
            asyncio.get_running_loop().create_task(
                self._serve(srv, qt, batch, service))

    async def _serve(self, srv: Server, qt: str,
                     batch: List[QueuedRequest], service: float) -> None:
        await asyncio.sleep(service * self.time_scale)
        now = self.now()
        srv.busy_until = now
        for req in batch:
            self._complete_hop(req, srv, now)
        self._wake[qt].set()

    def _complete_hop(self, req: QueuedRequest, srv: Server,
                      now: float) -> None:
        app, task = srv.app, srv.tup.task
        g = self._apps[app].graph
        gr = self._roots.get(req.root_id)
        if req.req_id in self._retried:        # the second chance paid off
            self._retried.discard(req.req_id)
            if gr is not None:
                gr.retry_ok += 1
            if self.hooks is not None:
                self.hooks.on_retry_success(app, now, root_id=req.root_id)
        if gr is not None:
            gr.events.put_nowait({
                "event": "hop", "root_id": req.root_id, "task": task,
                "variant": srv.tup.variant, "t": now,
                "hop_latency_ms": (now - req.enqueue_t) * 1e3})
        succ = g.successors(task)
        if not succ:
            if gr is not None:
                gr.completed += 1
                gr.outstanding -= 1
                if gr.outstanding <= 0:
                    out = gr._finalize(now)
                    if self.hooks is not None:
                        self.hooks.on_complete(
                            app, req.root_id, out["latency_ms"],
                            not out["deadline_met"], now)
                    self._roots.pop(req.root_id, None)
            return
        for t2 in succ:
            qt2 = qualify(app, t2)
            f = g.factor(task, srv.tup.variant, t2)
            base = int(math.floor(f))
            fan = base + (1 if self.rng.random() < (f - base) else 0)
            if gr is not None:
                gr.outstanding += fan
            for _ in range(fan):
                child = QueuedRequest(next(self._ids), req.root_id, qt2,
                                      now, req.deadline,
                                      req.path_done + (task,))
                self.queues[qt2].append(child)
            self._wake[qt2].set()
        if gr is not None:
            gr.outstanding -= 1
            if gr.outstanding <= 0:       # zero-fan on every successor
                gr._finalize(now)
                self._roots.pop(req.root_id, None)

    def _drop(self, req: QueuedRequest, qt: str, reason: str,
              now: float) -> Optional[QueuedRequest]:
        """Shed one queued hop.  With ``retry_drops`` and deadline budget
        left, the FIRST shed of a hop resubmits it instead (returned for
        the caller's keep-list); admission refusals never reach here, so
        only genuine queue drops are retried."""
        app, task = split_qualified(qt)
        gr = self._roots.get(req.root_id)
        if (self.retry_drops and gr is not None
                and req.req_id not in self._retried
                and now < req.deadline - 1e-9):
            self._retried.add(req.req_id)
            gr.retries += 1
            if self.hooks is not None:
                self.hooks.on_retry(app, now, root_id=req.root_id)
            gr.events.put_nowait({
                "event": "retry", "root_id": req.root_id, "task": task,
                "reason": reason, "t": now})
            # re-enqueue from 'now': staleness restarts, deadline keeps
            return QueuedRequest(req.req_id, req.root_id, qt, now,
                                 req.deadline, req.path_done)
        self._retried.discard(req.req_id)
        if self.hooks is not None:
            self.hooks.on_drop(app, task, reason, 1, now,
                               root_id=req.root_id)
        if gr is None:
            return None
        gr.dropped += 1
        gr.outstanding -= 1
        gr.events.put_nowait({
            "event": "drop", "root_id": req.root_id, "task": task,
            "reason": reason, "t": now})
        if gr.outstanding <= 0:
            gr._finalize(now)
            self._roots.pop(req.root_id, None)
        return None

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        return {
            "apps": sorted(self._apps),
            "servers": len(self.servers),
            "inflight_roots": len(self._roots),
            "queue_depth": {qt: len(q) for qt, q in self.queues.items()
                            if q},
            "time_scale": self.time_scale,
            "now_s": self.now(),
        }

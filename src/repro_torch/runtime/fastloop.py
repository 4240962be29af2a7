"""The vectorized event-calendar loop (DESIGN.md §16).

``run_fast`` is the port's one event loop, behind
:meth:`repro_torch.runtime.cluster.ClusterRuntime.run`.  It produces
field-exact-identical :class:`~repro_torch.runtime.metrics.SimMetrics` to the
per-event loop of the reference's ``repro.runtime.ClusterRuntime``
("the legacy loop" below, the differential oracle) —
same RNG draw ordering (arrival processes, SimBackend service draws,
fan-out coins), same event ordering, same hook call sequence — while
processing events several times faster:

* **Arrival calendar**: every arrival is generated once into a
  struct-of-arrays numpy calendar (times, seqs, ids, deadlines, entry
  queues), ``np.lexsort``-ordered by ``(t, seq)`` and merged with the
  dynamic heap at pop time — zero heap traffic for the dominant static
  arrival load.
* **Queue shards**: each qualified task owns a :class:`_TaskQueue` with
  a head cursor (O(1) batch removal instead of ``del q[:b]``), cached
  server / fastest-remaining / timeout state invalidated by the
  runtime's ``_fleet_epoch`` counter, and O(1) early-drop guards — a
  stale-head bound via the min enqueue time and a min-deadline lower
  bound — that fall back to the exact per-row legacy scan only when a
  drop is actually possible.  Both bounds are maintained stale-LOW
  (append-min, exact after every scan), so a guard can fire spuriously
  (one wasted exact scan) but can never miss a drop the legacy loop
  would have made.
* **Poll dedup**: a duplicate poll — same queue, identical fire time —
  is a pure no-op in the legacy loop: ``try_dispatch`` is idempotent at
  quiescence (no dispatch means no RNG draw, no metric, and the same
  re-poll time), and every event handler leaves its touched queues
  quiescent.  Each shard tracks its pending poll times and skips
  pushing an exact duplicate, which removes most of the legacy loop's
  heap traffic.  Skipping only deletes elements of the ``(t, seq)``
  event sequence; the implied seq renumbering is monotone, so every
  surviving pair of events keeps its relative order and the replay
  stays bit-identical.

The per-batch metric counters (``traffic``, ``served``,
``degraded_served``) accumulate once per batch instead of once per
request; this is invisible because nothing observes ``SimMetrics``
mid-batch — the monitor reads it only at ``mon`` events and the
instrumentation hooks receive values, not the ledger.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import TYPE_CHECKING, Dict, List, Tuple

import numpy as np

from repro_torch.core.dispatch import QueuedRequest
from repro_torch.core.taskgraph import qualify, split_qualified
from repro_torch.runtime.metrics import SimMetrics

if TYPE_CHECKING:   # pragma: no cover — typing only
    from repro_torch.runtime.cluster import ClusterRuntime
    from repro_torch.runtime.scenario import Scenario

__all__ = ["run_fast"]

_INF = math.inf
# queue sweep cadence while chaos events are in play: dead-task queues
# get no poll events, so without a periodic scan their requests would
# never be counted as dropped (accounting hole, not a serving change)
_CHAOS_SCAN_S = 0.5


class _TaskQueue:
    """One qualified task's queue shard.

    ``rows[head:]`` is the live queue; appends go to the tail and batch
    removal advances the cursor.  ``min_dl`` / ``min_enq`` lower-bound
    the live rows' deadlines / enqueue times for the O(1) drop guards
    (stale-low is safe: a spurious guard hit triggers the exact scan,
    which recomputes both).  ``pending`` holds poll times already in
    the heap for this shard.  The server-view caches (``servers``,
    ``fastest``, ``timeout``, ``free_t``) are valid while ``epoch``
    matches the runtime's ``_fleet_epoch``.

    Foreign readers (the degradation ladder's admission gate) see the
    shard through ``runtime.queues`` mid-run, so it exposes the small
    read-only surface of the list it replaces.
    """

    __slots__ = ("qt", "app", "task", "graph", "rows", "head", "min_dl",
                 "min_enq", "fan", "succ", "fan_cache", "pending",
                 "servers", "fastest", "timeout", "free_t", "min_batch",
                 "mortal", "allb1", "epoch", "quiet_now", "quiet_len")

    def __init__(self, qt: str, graph, rows: List[QueuedRequest]):
        self.qt = qt
        self.app, self.task = split_qualified(qt)
        self.graph = graph
        self.rows = rows
        self.head = 0
        # leftover rows from a prior run may be arbitrarily old /
        # urgent: force the first touch through the exact scan
        self.min_dl = -_INF if rows else _INF
        self.min_enq = -_INF if rows else _INF
        # per-drop fan weight (legacy account_drop computes this per
        # drop; it only depends on the static graph)
        task = self.task
        self.fan = max(1, round(sum(
            graph.factor(task, graph.tasks[task].most_accurate.name, t2)
            for t2 in graph.successors(task)) or 1))
        self.succ: Tuple[Tuple[str, "_TaskQueue"], ...] = ()
        # per-variant successor fan splits (Q2, floor, frac) — the
        # graph's multiplicity table is static, so never invalidated
        self.fan_cache: Dict[str, list] = {}
        self.pending: set = set()
        self.servers: List = []
        self.fastest = 0.0
        self.timeout = 0.0
        self.free_t = 0.0
        # smallest batch size across the shard's servers: a queue
        # shorter than this with a fresh head cannot launch on ANY
        # idle server (the picked batch is at least this large)
        self.min_batch = 0
        # True while any cached server carries a retire_at stamp: the
        # poll clock must then re-derive the ALIVE min-busy per call
        self.mortal = False
        # every server takes batches of exactly one (and none retire):
        # a lone arrival on an empty shard launches immediately on the
        # first idle server — the arrive loop's express lane
        self.allb1 = False
        self.epoch = -1
        # quiescence stamp: a repeat try_dispatch at the same (time,
        # fleet epoch, row count) is a proven no-op and is skipped
        self.quiet_now = -1.0
        self.quiet_len = -1

    # -- read-only list surface for foreign readers --------------------
    def __len__(self) -> int:
        return len(self.rows) - self.head

    def __bool__(self) -> bool:
        return len(self.rows) > self.head

    def __iter__(self):
        return iter(self.rows[self.head:])

    def __getitem__(self, i):
        return self.rows[self.head:][i]


def run_fast(rt: "ClusterRuntime", scenario: "Scenario") -> SimMetrics:
    """Serve ``scenario`` on ``rt`` with the event-calendar loop.

    Field-exact parity contract with the per-event loop of the
    reference's ``repro.runtime.ClusterRuntime``:
    identical SimMetrics (including latency append order), identical
    RNG draw order, identical hook call sequence.
    """
    m = SimMetrics()
    hooks = rt.hooks
    ladder = rt._ladder
    windows: List[Tuple[float, float]] = []
    if rt._transition is not None:
        windows.append((0.0, rt._transition.makespan_s))
    if (rt._transition is not None or scenario.transitions
            or rt._monitor is not None):
        m.window = SimMetrics()

    def in_window(t: float) -> bool:
        return any(a <= t < b for a, b in windows)

    domain_open: Dict[str, float] = {}
    ids = rt._ids
    seq = itertools.count()
    events: List[Tuple[float, int, str, object]] = []
    duration_s, warmup_s = scenario.duration_s, scenario.warmup_s
    slo_s = {name: st.graph.slo_latency_ms / 1e3 * scenario.slo_scale
             for name, st in rt._apps.items()}
    drain_s = duration_s + max(10.0, 2.0 * max(slo_s.values()))
    root_t = rt._root_t
    rng = rt.rng
    backend = rt.backend
    staleness = rt.staleness_ms
    heappush = heapq.heappush
    heappop = heapq.heappop

    def push(t, kind, payload):
        heappush(events, (t, next(seq), kind, payload))

    def sub(app: str) -> SimMetrics:
        return m if app == "" else m.app(app)

    # -- queue shards ---------------------------------------------------
    # built over the runtime's queue dict (keeps construction order for
    # the try-dispatch-all sweeps) and installed as ``rt.queues`` so the
    # ladder's admission gate sees live depths; restored on exit
    queues: Dict[str, _TaskQueue] = {}
    for name, st in rt._apps.items():
        for t in st.graph.tasks:
            qt = qualify(name, t)
            queues[qt] = _TaskQueue(qt, st.graph, rt.queues[qt])
    for Q in queues.values():
        Q.succ = tuple((t2, queues[qualify(Q.app, t2)])
                       for t2 in Q.graph.successors(Q.task))
    all_q = list(queues.values())
    # (app, task) -> shard: tuple hashing beats rebuilding the
    # qualified-name string per done event
    qmap = {(Q.app, Q.task): Q for Q in all_q}
    saved_queues = rt.queues
    rt.queues = queues          # type: ignore[assignment]

    def account_drop(Q: _TaskQueue, rt0: float, reason: str,
                     root_id: int = -1):
        """Legacy ``account_drop`` with the shard's cached fan weight."""
        in_main = rt0 >= warmup_s
        win = m.window
        in_win = win is not None and in_window(rt0)
        if not (in_main or in_win) and not domain_open:
            return
        fan = Q.fan
        app = Q.app
        if in_main:
            m.count_drop(fan, reason)
            if app:
                sub(app).count_drop(fan, reason)
            if hooks is not None:
                hooks.on_drop(app, Q.task, reason, fan, rt0,
                              root_id=root_id)
        if in_win:
            win.count_drop(fan, reason)
        for d, tf in domain_open.items():
            if rt0 >= tf:
                m.domain(d).count_drop(fan, reason)

    def full_scan(Q: _TaskQueue, now: float):
        """The exact legacy per-row early-drop pass (paper §3.3) — the
        O(1) guards fall back here; recomputes both lower bounds."""
        rows = Q.rows
        lossy = Q.qt in rt.lost_capacity
        thresh = 2.0 * Q.timeout + staleness
        dl_cut = now + Q.fastest / 1e3
        keep: List[QueuedRequest] = []
        mdl = menq = _INF
        for i in range(Q.head, len(rows)):
            req = rows[i]
            if (now - req.enqueue_t) * 1e3 > thresh:
                reason = "stale"
            elif dl_cut > req.deadline:
                reason = "deadline_unreachable"
            else:
                keep.append(req)
                if req.deadline < mdl:
                    mdl = req.deadline
                if req.enqueue_t < menq:
                    menq = req.enqueue_t
                continue
            # attribution: a task that lost streams to a kill or
            # preemption drops because capacity failed, not because the
            # request was inherently unserviceable
            rkey = ("failed_capacity" if lossy
                    else "deadline"
                    if reason == "deadline_unreachable" else reason)
            account_drop(Q, root_t[req.root_id], rkey,
                         root_id=req.root_id)
        Q.rows = keep
        Q.head = 0
        Q.min_dl = mdl
        Q.min_enq = menq

    nseq = seq.__next__

    def try_dispatch(Q: _TaskQueue, now: float):
        rows = Q.rows
        n = len(rows)
        # quiescence skips: the previous call at this exact (time,
        # fleet epoch) ran to quiescence.  Nothing appended since => a
        # repeat is a no-op in the legacy loop too (no dispatch => no
        # rng draw, no metric, and a deduped re-poll).  Append-only
        # since => still a no-op provided no server is free (a longer
        # queue cannot launch), neither drop guard fires (no append is
        # droppable), and the head row predates the appends (queue was
        # non-empty, and with no dispatch or scan the head — hence the
        # already-scheduled poll time — is unchanged); same instant, so
        # every time-dependent comparison is literally identical.
        if Q.quiet_now == now and Q.epoch == rt._fleet_epoch:
            ql = Q.quiet_len
            if ql == n:
                return
            if (ql > 0 and Q.free_t > now + 1e-12
                    and (now - Q.min_enq) * 1e3
                    <= 2.0 * Q.timeout + staleness
                    and now + Q.fastest / 1e3 <= Q.min_dl):
                Q.quiet_len = n
                return
        if Q.epoch != rt._fleet_epoch:
            srvs = rt.by_task.get(Q.qt)
            Q.servers = srvs if srvs is not None else []
            Q.fastest = rt._fastest[Q.qt]
            Q.timeout = rt._timeout[Q.qt]
            ft = _INF
            mb = _INF
            xb = 0
            mortal = False
            for s in Q.servers:
                if s.busy_until < ft:
                    ft = s.busy_until
                b = s.tup.batch
                if b < mb:
                    mb = b
                if b > xb:
                    xb = b
                if s.retire_at != _INF:
                    mortal = True
            Q.free_t = ft
            Q.min_batch = mb
            Q.mortal = mortal
            Q.allb1 = xb == 1 and mb == 1 and not mortal
            Q.epoch = rt._fleet_epoch
        h = Q.head
        if h >= n:
            Q.quiet_now = now
            Q.quiet_len = n
            return
        timeout = Q.timeout
        # O(1) drop guards: min_enq bounds the stalest wait, min_dl the
        # tightest deadline — identical float comparisons to early_drop
        if ((now - Q.min_enq) * 1e3 > 2.0 * timeout + staleness
                or now + Q.fastest / 1e3 > Q.min_dl):
            full_scan(Q, now)
            rows = Q.rows
            h = 0
            n = len(rows)
            if n == 0:
                Q.quiet_now = now
                Q.quiet_len = 0
                return
        servers = Q.servers
        if not servers:
            # legacy: no idle, no alive — no dispatch, no poll
            Q.quiet_now = now
            Q.quiet_len = n
            return
        eps = now + 1e-12
        dispatched = False
        # launch precheck: any picked batch size is >= min_batch, so a
        # shorter queue with an un-aged head cannot launch on anyone —
        # skip forming the idle set (the legacy loop would break on its
        # first batch_ready test with no observable effect)
        if Q.free_t <= eps and (
                n - h >= Q.min_batch
                or (now - rows[h].enqueue_t) * 1e3 >= timeout - 1e-9):
            # a drained (retired) stream takes no NEW batches; an
            # incoming stream's warm-up is its initial busy_until
            idle = ([s for s in servers
                     if s.busy_until <= eps and s.retire_at > eps]
                    if Q.mortal else
                    [s for s in servers if s.busy_until <= eps])
            while idle and h < n:
                head_wait = (now - rows[h].enqueue_t) * 1e3
                # pick the idle server that can drain the most
                # (first-max, like the legacy max())
                srv = idle[0]
                b = srv.tup.batch
                for j in range(1, len(idle)):
                    s = idle[j]
                    if s.tup.batch > b:
                        srv = s
                        b = s.tup.batch
                qlen = n - h
                if not (qlen >= b or head_wait >= timeout - 1e-9):
                    break
                if qlen < b:
                    # partial launch on the smallest-batch idle server
                    srv = idle[0]
                    b = srv.tup.batch
                    for j in range(1, len(idle)):
                        s = idle[j]
                        if s.tup.batch < b:
                            srv = s
                            b = s.tup.batch
                batch = rows[h:h + b]
                h += b
                service = backend.service_s(srv, batch, now, rng)
                srv.busy_until = now + service
                idle.remove(srv)
                dispatched = True
                if hooks is not None:
                    hooks.on_dispatch(srv, batch, now, service,
                                      n - h if h < n else 0)
                heappush(events, (srv.busy_until, nseq(), "done",
                                  (srv.idx, batch)))
            if dispatched:
                ft = _INF
                for s in servers:
                    if s.busy_until < ft:
                        ft = s.busy_until
                Q.free_t = ft
        if h >= n:
            if rows:
                del rows[:]
            Q.head = 0
            Q.min_dl = _INF
            Q.min_enq = _INF
            Q.quiet_now = now
            Q.quiet_len = 0
            return
        if h != Q.head:
            if h > 512 and h * 2 >= n:
                del rows[:h]
                n -= h
                h = 0
            Q.head = h
        Q.quiet_now = now
        Q.quiet_len = n
        if Q.mortal:
            # retired streams must not feed the poll clock: their stale
            # busy_until would pin min-busy in the past
            min_busy = _INF
            alive = False
            for s in servers:
                if s.retire_at > eps:
                    alive = True
                    if s.busy_until < min_busy:
                        min_busy = s.busy_until
            if not alive:
                return
        else:
            # no retire stamps in this fleet: every server is alive and
            # min-busy is exactly the cached free time
            min_busy = Q.free_t
        t_head = rows[h].enqueue_t + timeout / 1e3
        t_poll = t_head if t_head >= min_busy else min_busy
        if t_poll > now + 1e-9:
            pend = Q.pending
            if t_poll not in pend:
                pend.add(t_poll)
                heappush(events, (t_poll, nseq(), "poll", Q))

    try:
        # -- arrivals: one independent process per app ------------------
        if scenario.apps:
            missing = [a.app for a in scenario.apps
                       if a.app not in rt._apps]
            if missing:
                raise ValueError(f"scenario names unknown apps {missing} "
                                 f"(runtime has {list(rt._apps)})")
            workloads = [(a.app, a.arrivals) for a in scenario.apps]
        else:
            if rt._single is None:
                raise ValueError("multi-app runtime needs Scenario.multi "
                                 "(per-app arrival processes)")
            workloads = [("", scenario.arrivals)]
        # struct-of-arrays calendar: (t, seq, root id, deadline, entry
        # queue index), generation consumes rng / frontend / id streams
        # in the exact legacy order, then one lexsort replaces A heap
        # pushes + A heap pops
        arr_t: List[float] = []
        arr_seq: List[int] = []
        arr_rid: List[int] = []
        arr_dl: List[float] = []
        arr_qi: List[int] = []
        entry_qs: List[_TaskQueue] = []
        time_base_s = rt.time_base_s
        single = rt._single
        for app, proc in workloads:
            st = rt._apps[app]
            qi = len(entry_qs)
            entry_qs.append(queues[qualify(app, st.graph.entry)])
            frontend = st.frontend
            app_slo = slo_s[app]
            ts = proc.times(rng, duration_s)
            if frontend is None:
                # vectorized fill: the id and seq streams are plain
                # counters, so one bulk range consumes them exactly as
                # the legacy per-arrival next() calls would; truncation
                # matches the legacy break at the first time past the
                # drain horizon
                tarr = np.asarray(ts, dtype=np.float64)
                over = np.nonzero(tarr > drain_s)[0]
                if over.size:
                    tarr = tarr[:over[0]]
                n_a = int(tarr.size)
                if n_a:
                    tlist = tarr.tolist()
                    rid0 = next(ids)
                    ids = itertools.count(rid0 + n_a)
                    rt._ids = ids
                    seq0 = next(seq)
                    seq = itertools.count(seq0 + n_a)
                    nseq = seq.__next__
                    rids = range(rid0, rid0 + n_a)
                    root_t.update(zip(rids, tlist))
                    arr_t.extend(tlist)
                    arr_seq.extend(range(seq0, seq0 + n_a))
                    arr_rid.extend(rids)
                    arr_dl.extend([t + app_slo for t in tlist])
                    arr_qi.extend(itertools.repeat(qi, n_a))
                continue
            for t in ts:
                if t > drain_s:
                    # past the drain horizon the loop never processes it
                    break
                meta = frontend.submit(time_base_s + t)
                deadline = t + (meta.deadline_s
                                - (time_base_s + t)
                                ) * scenario.slo_scale
                rid = meta.req_id if single is not None \
                    else next(ids)
                root_t[rid] = t
                arr_t.append(t)
                arr_seq.append(next(seq))
                arr_rid.append(rid)
                arr_dl.append(deadline)
                arr_qi.append(qi)
        cal_n = len(arr_t)
        if cal_n:
            order = np.lexsort((np.asarray(arr_seq, dtype=np.int64),
                                np.asarray(arr_t, dtype=np.float64)))
            cal_t = np.asarray(arr_t, dtype=np.float64)[order].tolist()
            cal_seq = np.asarray(arr_seq, dtype=np.int64)[order].tolist()
            cal_rid = np.asarray(arr_rid, dtype=np.int64)[order].tolist()
            cal_dl = np.asarray(arr_dl, dtype=np.float64)[order].tolist()
            cal_qi = np.asarray(arr_qi, dtype=np.int64)[order].tolist()
        else:
            cal_t = cal_seq = cal_rid = cal_dl = cal_qi = []
        cal_i = 0

        # -- static events, exact legacy push order ---------------------
        for ev in scenario.failures:
            push(ev.at_s, "fail", ev)
        for ev in scenario.capacity:
            push(ev.at_s, "capacity", ev)
        for ev in scenario.transitions:
            push(ev.at_s, "transition", ev.plan)
        for ev in scenario.domain_failures:
            push(ev.at_s, "domain_fail", ev)
        for ev in scenario.preemptions:
            push(ev.at_s, "preempt", ev)
        chaos_events = scenario.domain_failures or scenario.preemptions \
            or any(f.pool is not None for f in scenario.failures)
        if chaos_events:
            t0 = min(e.at_s for e in (scenario.domain_failures
                                      + scenario.preemptions
                                      + scenario.failures))
            t_scan = t0 + _CHAOS_SCAN_S
            while t_scan <= drain_s:
                push(t_scan, "chaos_scan", None)
                t_scan += _CHAOS_SCAN_S
        if rt._monitor is not None:
            begin = getattr(rt._monitor, "begin_run", None)
            if begin is not None:
                begin(rt)
            interval = float(getattr(rt._monitor, "interval_s", 0.5))
            t_mon = interval
            while t_mon <= duration_s:
                push(t_mon, "mon", None)
                t_mon += interval
        if rt._transition is not None:
            for t_r in sorted({a.retire_s
                               for a in rt._transition.drains}):
                push(t_r, "retire_sweep", None)
        for Q in all_q:
            if Q:                   # leftover work from a prior run
                Q.pending.add(0.0)
                push(0.0, "poll", Q)

        srv_by_idx = {s.idx: s for s in rt.servers}
        bulk_ok = ladder is None and hooks is None

        # -- merged calendar + heap event loop --------------------------
        while True:
            if cal_i < cal_n:
                now = cal_t[cal_i]
                if events:
                    e0 = events[0]
                    take = (now < e0[0] or (now == e0[0]
                                            and cal_seq[cal_i] < e0[1]))
                else:
                    take = True
            else:
                take = False
            if take:
                rid = cal_rid[cal_i]
                Q = entry_qs[cal_qi[cal_i]]
                req = QueuedRequest(rid, rid, Q.qt, now, cal_dl[cal_i])
                cal_i += 1
                if ladder is not None:
                    shed = ladder.gate(rt, Q.qt, now, req=req)
                    if shed is not None:
                        account_drop(Q, root_t[rid], shed, root_id=rid)
                        continue
                rows = Q.rows
                # express lane: on an empty all-batch-1 immortal shard
                # with an idle server, the legacy loop launches exactly
                # [req] on the first idle server (all batch picks tie at
                # one) and leaves the queue drained — no scan (a fresh
                # request keeps the stale guard quiet; the deadline
                # guard is checked here), no poll — so dispatch inline
                # and skip the append/compaction round-trip
                if (bulk_ok and Q.allb1 and len(rows) == Q.head
                        and Q.epoch == rt._fleet_epoch
                        and Q.free_t <= now + 1e-12
                        and now + Q.fastest / 1e3 <= req.deadline):
                    eps = now + 1e-12
                    for srv in Q.servers:
                        if srv.busy_until <= eps:
                            break
                    service = backend.service_s(srv, [req], now, rng)
                    srv.busy_until = now + service
                    heappush(events, (srv.busy_until, nseq(), "done",
                                      (srv.idx, [req])))
                    ft = _INF
                    for s in Q.servers:
                        if s.busy_until < ft:
                            ft = s.busy_until
                    Q.free_t = ft
                    continue
                rows.append(req)
                if req.deadline < Q.min_dl:
                    Q.min_dl = req.deadline
                if now < Q.min_enq:
                    Q.min_enq = now
                if hooks is not None:
                    hooks.on_arrival(Q.app, Q.task, now,
                                     len(rows) - Q.head)
                try_dispatch(Q, now)
                # bulk span: with no admission gate and no hooks, each
                # following arrival for this same shard that cannot
                # trigger a launch — the queue (with it) stays shorter
                # than the smallest batch size and the head is younger
                # than the batching timeout, the only two ways
                # batch_ready fires — cannot drop (both guards quiet
                # against the running min-deadline) and precedes the
                # next heap event is append-only: the legacy
                # per-arrival try_dispatch would draw no rng, touch no
                # metric, and dedup its re-poll (no dispatch or scan,
                # so the head row — hence the poll time and the alive
                # min-busy — is unchanged), so it is skipped wholesale.
                # try_dispatch above just synced the epoch caches, and
                # nothing in the span can invalidate them.
                if (bulk_ok and cal_i < cal_n and not Q.mortal
                        and len(Q.rows) > Q.head):
                    bound = events[0][0] if events else _INF
                    rows = Q.rows
                    qtn = Q.qt
                    live = len(rows) - Q.head
                    head_enq = rows[Q.head].enqueue_t
                    age_cut = Q.timeout - 1e-9
                    min_b = Q.min_batch
                    thresh = 2.0 * Q.timeout + staleness
                    fast_ms = Q.fastest / 1e3
                    mdl = Q.min_dl
                    menq = Q.min_enq
                    while cal_i < cal_n:
                        t = cal_t[cal_i]
                        if (t > bound
                                or live + 1 >= min_b
                                or (t - head_enq) * 1e3 >= age_cut
                                or (t - menq) * 1e3 > thresh
                                or t + fast_ms > mdl
                                or entry_qs[cal_qi[cal_i]] is not Q):
                            break
                        rid = cal_rid[cal_i]
                        dl = cal_dl[cal_i]
                        rows.append(QueuedRequest(rid, rid, qtn, t, dl))
                        live += 1
                        if dl < mdl:
                            mdl = dl
                        cal_i += 1
                    Q.min_dl = mdl
                continue
            if not events:
                break
            now, _sq, kind, payload = heappop(events)
            if now > drain_s:
                break
            if kind == "done":
                idx, batch = payload
                srv = srv_by_idx.get(idx)
                if srv is None:
                    continue
                app = srv.app
                tup = srv.tup
                task, variant = tup.task, tup.variant
                Q = qmap[(app, task)]
                nb = len(batch)
                srv.served += nb
                if srv.degraded:
                    m.degraded_served += nb
                    if app:
                        sub(app).degraded_served += nb
                agg_key = (Q.qt, variant)
                m.traffic[agg_key] = m.traffic.get(agg_key, 0) + nb
                if app:
                    ms = sub(app)
                    tv = (task, variant)
                    ms.traffic[tv] = ms.traffic.get(tv, 0) + nb
                succ = Q.succ
                if not succ:
                    win = m.window
                    if win is None and not domain_open:
                        # specialized leaf path: aggregate (+ per-app)
                        # ledgers only — the common case; counters
                        # accumulate per batch (nothing reads the
                        # ledger mid-batch)
                        ms_app = sub(app) if app else None
                        mlat = m.latencies_ms
                        alat = (ms_app.latencies_ms
                                if ms_app is not None else None)
                        comp = miss = 0
                        for req in batch:
                            rt0 = root_t[req.root_id]
                            if rt0 < warmup_s:
                                continue
                            lat = (now - rt0) * 1e3
                            missed = now > req.deadline + 1e-9
                            mlat.append(lat)
                            comp += 1
                            if missed:
                                miss += 1
                            if alat is not None:
                                alat.append(lat)
                            if hooks is not None:
                                hooks.on_complete(app, req.root_id,
                                                  lat, missed, now)
                        m.completions += comp
                        m.missed += miss
                        if ms_app is not None:
                            ms_app.completions += comp
                            ms_app.missed += miss
                    else:
                        for req in batch:
                            rt0 = root_t[req.root_id]
                            in_win = win is not None and in_window(rt0)
                            doms = tuple(m.domain(d)
                                         for d, tf in domain_open.items()
                                         if rt0 >= tf)
                            if rt0 >= warmup_s or in_win or doms:
                                lat = (now - rt0) * 1e3
                                missed = now > req.deadline + 1e-9
                                sinks = (((m,) if app == ""
                                          else (m, sub(app)))
                                         if rt0 >= warmup_s else ())
                                for mm in (sinks + ((win,) if in_win
                                                    else ()) + doms):
                                    mm.latencies_ms.append(lat)
                                    mm.completions += 1
                                    if missed:
                                        mm.missed += 1
                                if sinks and hooks is not None:
                                    hooks.on_complete(app, req.root_id,
                                                      lat, missed, now)
                else:
                    # per-variant constants: the factor (and its floor
                    # split) is deterministic and the multiplicity
                    # table static, so cache per variant; the coin is
                    # NOT deterministic — one rng.random() per
                    # (request, successor), in order
                    fans = Q.fan_cache.get(variant)
                    if fans is None:
                        g = Q.graph
                        fans = []
                        for t2, Q2 in succ:
                            f = g.factor(task, variant, t2)
                            base = int(math.floor(f))
                            fans.append((Q2, base, f - base))
                        Q.fan_cache[variant] = fans
                    rnd = rng.random
                    nid = ids.__next__
                    ep = rt._fleet_epoch
                    for req in batch:
                        rootid = req.root_id
                        dl = req.deadline
                        pd = req.path_done + (task,)
                        for Q2, base, frac in fans:
                            fan = base + (1 if rnd() < frac else 0)
                            if fan:
                                rows2 = Q2.rows
                                for _ in range(fan):
                                    rows2.append(QueuedRequest(
                                        nid(), rootid, Q2.qt, now, dl,
                                        pd))
                                if dl < Q2.min_dl:
                                    Q2.min_dl = dl
                                if now < Q2.min_enq:
                                    Q2.min_enq = now
                        for fq in fans:
                            Q2 = fq[0]
                            # inline successor fast path (hot: per
                            # request, per successor).  With fresh
                            # epoch caches and no retire stamps, a
                            # queue that cannot launch (shorter than
                            # the smallest batch, head younger than the
                            # batching timeout) and cannot drop (both
                            # guards quiet) makes the legacy
                            # try_dispatch equivalent to the O(1)
                            # deduped head-poll push — done inline.
                            if (Q2.epoch == ep and not Q2.mortal
                                    and Q2.servers):
                                rows2 = Q2.rows
                                h2 = Q2.head
                                live2 = len(rows2) - h2
                                if not live2:
                                    continue
                                tmo2 = Q2.timeout
                                henq = rows2[h2].enqueue_t
                                if (live2 < Q2.min_batch
                                        and (now - henq) * 1e3
                                        < tmo2 - 1e-9
                                        and (now - Q2.min_enq) * 1e3
                                        <= 2.0 * tmo2 + staleness
                                        and now + Q2.fastest / 1e3
                                        <= Q2.min_dl):
                                    t_head = henq + tmo2 / 1e3
                                    mb2 = Q2.free_t
                                    t_poll = (t_head if t_head >= mb2
                                              else mb2)
                                    if t_poll > now + 1e-9:
                                        pend = Q2.pending
                                        if t_poll not in pend:
                                            pend.add(t_poll)
                                            heappush(events,
                                                     (t_poll, nseq(),
                                                      "poll", Q2))
                                    continue
                            try_dispatch(Q2, now)
                if srv.retire_at <= now + 1e-12:
                    # drained stream went idle past its hand-over point:
                    # its in-flight batch just completed — retire it
                    rt._sweep_retired(now)
                    del srv_by_idx[idx]
                # on an empty queue try_dispatch is a no-op in both
                # loops (no dispatch, no poll) — skip the call
                if len(Q.rows) > Q.head:
                    try_dispatch(Q, now)
            elif kind == "poll":
                payload.pending.discard(now)
                try_dispatch(payload, now)
            elif kind == "mon":
                plan = rt._monitor.check(rt, now, m)
                if plan is not None:
                    rt.apply_transition(plan, now)
                    windows.append((now, now + plan.makespan_s))
                    for a in plan.drains:
                        push(now + a.retire_s, "retire_sweep", None)
                    if hooks is not None:
                        hooks.on_transition(now, plan.makespan_s,
                                            emergency=True, plan=plan)
                if hooks is not None:
                    if ladder is not None:
                        hooks.on_ladder_level(ladder.level)
                    hooks.on_dead_units(rt.dead_units())
                srv_by_idx = {s.idx: s for s in rt.servers}
                for Q2 in all_q:
                    if len(Q2.rows) > Q2.head:
                        try_dispatch(Q2, now)
            else:
                if kind == "fail":
                    rt._apply_failure(payload)
                elif kind == "capacity":
                    rt._apply_capacity(payload, now)
                elif kind == "transition":
                    rt.apply_transition(payload, now)
                    windows.append((now, now + payload.makespan_s))
                    for a in payload.drains:
                        push(now + a.retire_s, "retire_sweep", None)
                    if hooks is not None:
                        hooks.on_transition(now, payload.makespan_s,
                                            emergency=False, plan=payload)
                elif kind == "domain_fail":
                    rt._apply_domain_failure(payload)
                    domain_open.setdefault(payload.domain, now)
                elif kind == "preempt":
                    rt._apply_preemption(payload, now, push)
                elif kind == "chaos_scan":
                    pass        # the shared try_dispatch pass below
                else:
                    rt._sweep_retired(now)
                srv_by_idx = {s.idx: s for s in rt.servers}
                for Q2 in all_q:
                    if len(Q2.rows) > Q2.head:
                        try_dispatch(Q2, now)

        # summed span of the UNION of windows (overlaps merged)
        span, end = 0.0, -_INF
        for a, b in sorted(windows):
            span += max(0.0, b - max(a, end))
            end = max(end, b)
        m.transition_window_s = span
        for name, st in rt._apps.items():
            if st.frontend is not None:
                ms = sub(name)
                st.frontend.record_bin_outcome(ms.total_requests,
                                               ms.violations)
        return m
    finally:
        # hand the live rows back as plain lists — a re-run (either
        # path) or a mid-run failure must leave ``rt.queues`` exactly
        # shaped like the legacy loop does
        for qt, Q in queues.items():
            saved_queues[qt] = Q.rows[Q.head:]
        rt.queues = saved_queues

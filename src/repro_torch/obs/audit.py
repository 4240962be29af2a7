"""Control-plane flight recorder (DESIGN.md §17).

Every control-plane decision in the serving stack — re-plans,
transitions, detector dead-unit updates, ladder moves, emergency
re-plans, admission / shed / quota refusals, burn-rate alerts — lands
in one bounded :class:`AuditLog` with its *why* (trigger, solve time,
action counts, reason).  Data-plane events are recorded only when they
represent an SLO outcome worth explaining: a missed completion carries
its trace ``root_id``, so :meth:`AuditLog.explain` resolves a violated
request to the full chain of decisions that preceded it.

The log is a ``deque(maxlen=...)``: recording never blocks and never
grows; evictions are counted, not silent.  :meth:`to_ndjson` /
:meth:`from_ndjson` round-trip the log as newline-delimited JSON (the
gateway's ``/audit`` download format).

A copy of the JAX package's ``obs/audit.py``.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Mapping, Optional

__all__ = ["AuditEvent", "AuditLog", "CONTROL_KINDS"]

# decision kinds that form the "why" chain for any affected request
CONTROL_KINDS = frozenset({
    "replan", "emergency_replan", "transition", "dead_units", "ladder",
    "spike", "alert", "admission", "shed", "retry",
})


@dataclass(frozen=True)
class AuditEvent:
    """One recorded decision / outcome."""
    seq: int
    t_s: float
    kind: str
    app: str = ""
    root_id: Optional[int] = None
    detail: Mapping[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "seq": self.seq, "t_s": round(self.t_s, 6),
            "kind": self.kind, "app": self.app,
        }
        if self.root_id is not None:
            out["root_id"] = self.root_id
        if self.detail:
            out["detail"] = dict(self.detail)
        return out


class AuditLog:
    """Bounded, queryable structured event log."""

    def __init__(self, maxlen: int = 4096) -> None:
        if maxlen <= 0:
            raise ValueError("maxlen must be positive")
        self.maxlen = int(maxlen)
        self._events: Deque[AuditEvent] = deque(maxlen=self.maxlen)
        self._seq = 0
        self.evicted = 0

    def record(self, kind: str, t_s: float, *, app: str = "",
               root_id: Optional[int] = None,
               **detail: object) -> AuditEvent:
        ev = AuditEvent(self._seq, float(t_s), kind, app, root_id, detail)
        self._seq += 1
        if len(self._events) == self.maxlen:
            self.evicted += 1
        self._events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> List[AuditEvent]:
        return list(self._events)

    # -- queries ---------------------------------------------------------
    def query(self, *, app: Optional[str] = None,
              kind: Optional[str] = None, t0: Optional[float] = None,
              t1: Optional[float] = None,
              root_id: Optional[int] = None) -> List[AuditEvent]:
        """Filter by (app, kind, time range, root_id); any filter left
        None matches everything.  App-filtering keeps app-less
        cluster-wide decisions (transitions, dead units) visible."""
        out: List[AuditEvent] = []
        for ev in self._events:
            if app is not None and ev.app not in ("", app):
                continue
            if kind is not None and ev.kind != kind:
                continue
            if t0 is not None and ev.t_s < t0 - 1e-12:
                continue
            if t1 is not None and ev.t_s > t1 + 1e-12:
                continue
            if root_id is not None and ev.root_id != root_id:
                continue
            out.append(ev)
        return out

    def explain(self, root_id: int) -> List[AuditEvent]:
        """The decision chain for one request: its own events plus every
        control-plane decision recorded up to its last event — the
        end-to-end 'why was this request violated' answer."""
        own = [ev for ev in self._events if ev.root_id == root_id]
        if not own:
            return []
        t_last = max(ev.t_s for ev in own)
        return [ev for ev in self._events
                if ev.root_id == root_id
                or (ev.kind in CONTROL_KINDS
                    and ev.t_s <= t_last + 1e-9)]

    # -- NDJSON round-trip ----------------------------------------------
    def to_ndjson(self) -> str:
        if not self._events:
            return ""
        return "\n".join(json.dumps(ev.to_dict(), sort_keys=True)
                         for ev in self._events) + "\n"

    @classmethod
    def from_ndjson(cls, text: str) -> "AuditLog":
        rows = [json.loads(line) for line in text.splitlines() if line]
        log = cls(maxlen=max(len(rows), 1))
        for row in rows:
            ev = AuditEvent(int(row["seq"]), float(row["t_s"]),
                            str(row["kind"]), str(row.get("app", "")),
                            row.get("root_id"),
                            dict(row.get("detail", {})))
            log._events.append(ev)
            log._seq = max(log._seq, ev.seq + 1)
        return log

"""Batching and early dropping primitives (paper §3.3).

Queues are task-level and live in :class:`repro_torch.runtime.cluster.
ClusterRuntime`; this module holds the shared dispatch rules: the launch
condition (a batch launches when full OR the oldest request has waited the
task's batch-formation timeout L̂(t)), the re-poll time, and the early-drop
rule — drop requests that (a) cannot meet their deadline even if the
*fastest* variants of all remaining tasks serve them instantly, or (b)
have gone stale in the queue.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class QueuedRequest:
    req_id: int
    root_id: int
    task: str
    enqueue_t: float
    deadline: float
    path_done: Tuple[str, ...] = ()


def batch_ready(queue_len: int, batch_size: int, head_wait_ms: float,
                timeout_ms: float) -> bool:
    """Launch condition: full batch, or head-of-line waited >= L̂(t)."""
    return queue_len >= batch_size or head_wait_ms >= timeout_ms - 1e-9


def next_poll_time(head_enqueue_t: float, timeout_ms: float,
                   min_busy_until: float) -> float:
    """When the dispatcher must re-examine a non-empty task queue: the
    head's batch-formation timeout, or the first server to free up —
    whichever is LATER (before that, nothing can change the decision)."""
    return max(head_enqueue_t + timeout_ms / 1e3, min_busy_until)


def early_drop(req: QueuedRequest, now: float,
               fastest_remaining_ms: float, staleness_ms: float,
               timeout_ms: float = 0.0) -> Optional[str]:
    """Returns a drop reason or None (paper §3.3).

    * stale: the request waited past one batch-formation window PLUS one
      in-flight batch (the 2·L̂ the latency model budgets per task,
      Eq. 3) by more than the staleness allowance — i.e. every instance
      kept its batches full and never picked the request up;
    * deadline_unreachable: even the fastest variants of all remaining
      tasks with zero batch-formation delay would miss the deadline."""
    wait_ms = (now - req.enqueue_t) * 1e3
    if wait_ms > 2.0 * timeout_ms + staleness_ms:
        return "stale"
    if now + fastest_remaining_ms / 1e3 > req.deadline:
        return "deadline_unreachable"
    return None

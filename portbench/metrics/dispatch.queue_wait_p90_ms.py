"""dispatch.queue_wait_p90_ms: 90th percentile (nearest rank) of the
gateway ``Tracer``'s queue spans (a hop's enqueue to its batch's launch)."""
from portbench.harness import percentile


def read(run):
    waits = [(s.end_s - s.start_s) * 1e3 for s in run.spans
             if s.cat == "queue"]
    return percentile(waits, 90.0)

"""e2e_p90_ms: 90th percentile (nearest rank) of the latency of every
root sent, each timed at the client from the moment it was due to be sent
to the end of its HTTP response (host clock).  A root that did not come
back ``ok`` (dropped, refused, failed) counts as infinitely late, so a
change that drops more late roots cannot read as a shorter tail; where
such roots reach the percentile there is no finite reading and none is
reported."""
import math

from portbench.harness import percentile


def read(run):
    lat = [r["latency_ms"] if r.get("outcome") == "ok" else math.inf
           for r in run.requests]
    p = percentile(lat, 90.0)
    return p if p is not None and math.isfinite(p) else None

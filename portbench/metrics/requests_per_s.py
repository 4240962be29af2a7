"""requests_per_s: requests completed over the window, the window running
from the first batch's start to the end of the batch in flight when the
run's seconds had passed (host clock)."""


def read(run):
    if not run.batches or not run.window_s > 0:
        return None
    return sum(b["B"] for b in run.batches) / run.window_s

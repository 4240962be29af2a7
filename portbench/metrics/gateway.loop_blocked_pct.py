"""gateway.loop_blocked_pct: share of the window the gateway's event loop
spent inside ``service_s`` (the hops run inline on the loop), host clock."""


def read(run):
    if not run.hops or not run.window_s > 0:
        return None
    return 100.0 * sum(h["end"] - h["start"] for h in run.hops) / run.window_s

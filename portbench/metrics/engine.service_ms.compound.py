"""engine.service_ms.compound: mean synchronised wall of one hop's
``Engine.generate`` in the window, host clock."""


def read(run):
    if not run.hops:
        return None
    return 1e3 * sum(h["end"] - h["start"] for h in run.hops) / len(run.hops)

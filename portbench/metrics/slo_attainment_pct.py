"""slo_attainment_pct: roots sent that completed ``ok`` within the cell's
deadline, timed from when each was due; a dropped, refused or failed root
is a miss (host clock)."""


def read(run):
    if not run.requests:
        return None
    return 100.0 * sum(1 for r in run.requests if r["met"]) / len(run.requests)

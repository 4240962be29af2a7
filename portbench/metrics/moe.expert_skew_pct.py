"""moe.expert_skew_pct: how far the busiest expert stretches a grouped
product: for each MoE layer, its busiest expert's routed rows over the
mean of its experts' rows, minus 100, averaged over the layers; from the
program's device tally ``repro_torch.models.moe.expert_rows`` (rows per
expert and layer, summed by the dropless route from the counts its sort
makes), read once after the run.  The tally starts at the process's
first MoE call, so it holds the warm-up batch and the judged window
alike.  No reading off the card or where the program keeps no tally.

The skew belongs to the seeded weights: the router's random columns send
rows unevenly, by seed, and no change to the program moves it short of
changing the routing arithmetic.  It is kept to explain the spread of the
grouped products' device time between seeds, not as a target."""
import sys


def read(run):
    if not run.on_cuda:
        return None
    moe = sys.modules.get("repro_torch.models.moe")
    tally = getattr(moe, "expert_rows", None)
    if not tally:
        return None
    skews = []
    for rows in tally.values():
        rows = rows.double()
        mean = float(rows.mean())
        if mean > 0:
            skews.append(100.0 * (float(rows.max()) / mean - 1.0))
    return sum(skews) / len(skews) if skews else None

"""engine.prefill_ms: mean wall of ``Engine.prefill`` over the window's
batches, host clock between two ``synchronize`` calls (the profiled batch
left out)."""


def read(run):
    t = [b["prefill_s"] for b in run.batches
         if "prefill_s" in b and not b["traced"]]
    return 1e3 * sum(t) / len(t) if t else None

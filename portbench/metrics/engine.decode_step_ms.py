"""engine.decode_step_ms: all decode time of the window's batches (from the
end of each synchronised prefill to the tokens on the host) over all their
decode steps (``new_tokens - 1`` a batch), host clock (the profiled batch
left out)."""


def read(run):
    bs = [b for b in run.batches
          if "decode_s" in b and b["new"] > 1 and not b["traced"]]
    steps = sum(b["new"] - 1 for b in bs)
    return 1e3 * sum(b["decode_s"] for b in bs) / steps if steps else None

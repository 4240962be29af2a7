"""batcher.pad_pct: left-pad tokens over all prompt positions of the
batches ``Batcher.pump`` formed in the window, counted (program counter
of the harness: the batch's padded length against each prompt's)."""


def read(run):
    pos = sum(b["B"] * b["S"] for b in run.batches)
    if not pos:
        return None
    pad = sum(b["S"] - n for b in run.batches for n in b["prompt_lens"])
    return 100.0 * pad / pos

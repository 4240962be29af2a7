"""mfu.offline: model FLOPs of the requests the window's batches completed
(unpadded prompts, attention at true lengths) over the batches' wall times
the card's bf16 peak; in a traced run the profiled batch is left out."""
from portbench.count import mfu_pct as read  # noqa: F401

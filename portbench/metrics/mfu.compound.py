"""mfu.compound: model FLOPs of the hops served in the window over the
window times the card's bf16 peak."""
from portbench.count import mfu_pct as read  # noqa: F401

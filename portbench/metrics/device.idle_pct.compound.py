"""device.idle_pct.compound: share of the traced stretch (the last
``trace_s`` seconds of arrivals) in which no operation ran on the device
(profiler trace)."""
from portbench.trace import idle_pct as read  # noqa: F401

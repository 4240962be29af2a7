"""device.idle_pct.offline: share of the traced stretch (one whole batch)
in which no operation ran on the device (profiler trace)."""
from portbench.trace import idle_pct as read  # noqa: F401

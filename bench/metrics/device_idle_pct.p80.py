"""device_idle_pct.p80 (%): the share of the traced stretch in which no
kernel, copy or set ran on the card (``torch.profiler`` trace).
"""

from bench.metrics.common import idle_pct as read  # noqa: F401

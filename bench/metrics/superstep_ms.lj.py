"""superstep_ms.lj (ms): host-clock wall time of the window's untraced
runs divided by their supersteps (``Engine.run``'s count).
"""

from bench.metrics.common import superstep_ms as read  # noqa: F401

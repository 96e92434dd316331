"""supersteps_per_run.lj (count): the mean superstep count of the
window's untraced runs, as ``Engine.run`` returns it.
"""

from bench.metrics.common import supersteps_per_run as read  # noqa: F401

"""plane_fill.p80 (%): queries dispatched over dispatches x the plane
width, in the window outside the traced stretch.
"""

from bench.metrics.common import plane_fill as read  # noqa: F401

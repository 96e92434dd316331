"""dispatch_ms.over (ms): the server's summed ``last_dispatch_s`` over its
dispatches in the window, outside the traced stretch.
"""

from bench.metrics.common import dispatch_ms as read  # noqa: F401

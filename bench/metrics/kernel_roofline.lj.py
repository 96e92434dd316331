"""kernel_roofline.lj (%): the traced runs' least time at the card's peaks
(``bench/roofline.py``) over the time the card's kernels ran in the traced
stretch.  Copies and sets (the init state's upload, the result's copy)
are not kernel work: they count as busy in ``device_idle_pct`` and are
listed in the breakdown's device operations.
"""

from bench.metrics.common import kernel_roofline as read  # noqa: F401

"""The port's disk layout cache (``store``).  The tensor-tree checkpoint of
``repro.checkpoint`` is not ported yet (ROADMAP queue 1, item 11)."""

from repro_torch.checkpoint.store import (LAYOUT_CACHE_VERSION,
                                          layout_fingerprint,
                                          open_layout_cache,
                                          save_layout_cache)

"""The port's checkpoint store (``store``): atomic, async-capable
tensor-tree checkpoints and the disk layout cache, in the reference's file
formats."""

from repro_torch.checkpoint.store import (LAYOUT_CACHE_VERSION,
                                          AsyncCheckpointer, latest_step,
                                          layout_fingerprint,
                                          open_layout_cache,
                                          restore_checkpoint,
                                          save_checkpoint,
                                          save_layout_cache)

"""Minimal optax-style optimizer substrate over trees of tensors (the twin
of ``repro.optim``).

Public API:
    adamw / sgd                     transforms (init, update)
    chain, clip_by_global_norm      composition
    wsd_schedule, cosine_schedule   lr schedules
    compressed_psum, error feedback int8 gradient compression
"""

from repro_torch.optim.transforms import (adamw, sgd, chain,
                                          clip_by_global_norm,
                                          scale_by_schedule, apply_updates,
                                          global_norm, Optimizer)
from repro_torch.optim.schedule import (wsd_schedule, cosine_schedule,
                                        constant_schedule)
from repro_torch.optim.compress import (quantize_int8, dequantize_int8,
                                        compressed_psum, make_error_feedback)

"""xLSTM-350M [arXiv:2405.04517] -- sLSTM + mLSTM recurrent blocks.

Assigned: 24L d_model=1024 4H (kv=4, used as mLSTM head count) d_ff=0
vocab=50304.  d_ff=0: xLSTM blocks carry their own up/down projection
(ssm_expand=2); there is no separate FFN.  Block ratio ~7:1 mLSTM:sLSTM
(xLSTM[7:1]) -> period of 8.
"""

from repro_torch.models.config import ModelConfig

_PATTERN = (("mlstm", "none"),) * 7 + (("slstm", "none"),)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=_PATTERN,
    ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=8,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    layer_pattern=_PATTERN,
    ssm_expand=2,
    tie_embeddings=True,
)

"""Granite-20B-Code [arXiv:2405.04324; hf] -- dense MQA code model.

Assigned: 52L d_model=6144 48H (GQA kv=1, i.e. multi-query) d_ff=24576
vocab=49152; llama-style blocks.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    layer_pattern=(("attn", "dense"),),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=8,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    layer_pattern=(("attn", "dense"),),
    tie_embeddings=True,
)

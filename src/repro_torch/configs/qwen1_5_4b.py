"""Qwen1.5-4B [hf:Qwen/Qwen1.5-*] -- dense MHA with QKV bias.

Assigned: 40L d_model=2560 20H (GQA kv=20, i.e. full MHA) d_ff=6912
vocab=151936, QKV bias.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    layer_pattern=(("attn", "dense"),),
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen-smoke",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    layer_pattern=(("attn", "dense"),),
    qkv_bias=True,
    tie_embeddings=True,
)

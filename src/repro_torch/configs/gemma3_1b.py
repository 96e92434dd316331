"""Gemma3-1B [hf:google/gemma-3-1b-pt] -- dense, 5:1 local:global attention.

Assigned: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
Sliding window 512 for local layers (hf config); head_dim=256 (hf; not
d_model/heads).  26 layers = 4 x (5 local + 1 global) + (local, global) tail.
"""

from repro_torch.models.config import ModelConfig

_PATTERN = (("local", "dense"),) * 5 + (("attn", "dense"),)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    layer_pattern=_PATTERN,
    tail_pattern=(("local", "dense"), ("attn", "dense")),
    head_dim=256,
    window=512,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=8,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    layer_pattern=_PATTERN,
    tail_pattern=(("local", "dense"), ("attn", "dense")),
    head_dim=32,
    window=16,
    tie_embeddings=True,
)

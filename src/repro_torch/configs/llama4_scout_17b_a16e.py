"""Llama-4 Scout 17B-A16E [hf:meta-llama/Llama-4-Scout-17B-16E] -- MoE top-1.

Assigned: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 16 experts top-1, interleaved MoE (every other layer), early fusion
(text-only backbone here; fusion enters via the token stream).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=(("attn", "dense"), ("attn", "moe")),
    num_experts=16,
    top_k=1,
    moe_d_ff=8192,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    family="moe",
    num_layers=4,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    layer_pattern=(("attn", "dense"), ("attn", "moe")),
    num_experts=4,
    top_k=1,
    moe_d_ff=256,
    tie_embeddings=False,
)

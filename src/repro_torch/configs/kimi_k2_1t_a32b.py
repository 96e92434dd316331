"""Kimi K2 1T-A32B [arXiv:2501.kimi2 (paper-table)] -- trillion-param MoE.

Assigned: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per-expert) vocab=163840,
MoE 384 experts top-8.  DeepSeek-V3-style: one dense-FFN layer (width 18432),
the remaining 60 MoE.  Our block assembler places the dense layer as the tail
slot (position differs from K2's layer 0; identical compute/communication).

This is the paper-technique stress case: 384 destination "chares" in the
sort-by-expert dispatch.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=18432,                 # the single dense layer's FFN width
    vocab_size=163840,
    layer_pattern=(("attn", "moe"),),
    tail_pattern=(("attn", "dense"),),
    num_experts=384,
    top_k=8,
    moe_d_ff=2048,
    tie_embeddings=False,
    serve_zero=True,  # weights exceed TP-sharded HBM; fsdp-gather per layer
    opt_moment_dtype="bfloat16",  # 4 B/param optimizer state, not 8
)

SMOKE = ModelConfig(
    name="kimi-smoke",
    family="moe",
    num_layers=3,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    layer_pattern=(("attn", "moe"),),
    tail_pattern=(("attn", "dense"),),
    num_experts=8,
    top_k=2,
    moe_d_ff=64,
    tie_embeddings=False,
)

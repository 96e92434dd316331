"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] -- hybrid Mamba+attention MoE.

Assigned: 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
MoE 16 experts top-2, Mamba:attn 1:7 interleave.

Jamba period = 8 layers: one attention layer per 7 Mamba layers, MoE on
every other layer (e/2 spacing, per the paper's "MoE is applied every other
layer").  The paper's technique (sort-destination dispatch) is exercised by
the MoE all_to_all AND by the ZeRO grad reduce-scatter.
"""

from repro_torch.models.config import ModelConfig

_PATTERN = (
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("attn", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,                    # 9 repeats of the 8-layer Jamba period
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=_PATTERN,
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=False,
    serve_zero=True,  # weights exceed TP-sharded HBM; fsdp-gather per layer
    opt_moment_dtype="bfloat16",  # 4 B/param optimizer state, not 8
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    layer_pattern=_PATTERN,
    num_experts=4,
    top_k=2,
    moe_d_ff=256,
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=False,
)

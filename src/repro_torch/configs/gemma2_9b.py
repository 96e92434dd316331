"""Gemma2-9B [arXiv:2408.00118; hf] -- local/global alternating + softcaps.

Assigned: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Sliding window 4096 on local layers, attn softcap 50, final softcap 30,
head_dim=256 (hf; not d_model/heads).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern=(("local", "dense"), ("attn", "dense")),
    head_dim=256,
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    layer_pattern=(("local", "dense"), ("attn", "dense")),
    head_dim=32,
    window=16,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
)

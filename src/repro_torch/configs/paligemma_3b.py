"""PaLiGemma-3B [arXiv:2407.07726; hf] -- VLM: SigLIP frontend + Gemma decoder.

Assigned: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
Frontend is a STUB per the brief: input_specs() provides 256 precomputed
SigLIP patch embeddings [B, 256, d_model] prepended to the text tokens.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    layer_pattern=(("attn", "dense"),),
    frontend="vision",
    frontend_len=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="paligemma-smoke",
    family="vlm",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    layer_pattern=(("attn", "dense"),),
    frontend="vision",
    frontend_len=16,
    tie_embeddings=True,
)

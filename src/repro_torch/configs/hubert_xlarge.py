"""HuBERT-XLarge [arXiv:2106.07447] -- encoder-only audio transformer.

Assigned: 48L d_model=1280 16H (kv=16, full MHA) d_ff=5120 vocab=504
(k-means cluster units).  Encoder-only: bidirectional attention, per-frame
unit prediction, NO decode step (decode shape cells are skipped).  The conv
feature extractor is a STUB per the brief: input_specs() provides
precomputed frame embeddings [B, S, d_model].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    layer_pattern=(("attn", "dense"),),
    encoder_only=True,
    frontend="audio",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=64,
    layer_pattern=(("attn", "dense"),),
    encoder_only=True,
    frontend="audio",
    tie_embeddings=False,
)

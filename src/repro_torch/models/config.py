"""Model configuration schema for the assigned architectures.

The port's copy of ``repro/models/config.py`` (pure Python; the port
imports nothing of the reference).  A model is a cycle of *block
patterns*; each block is (mixer, mlp):

    mixer: "attn" | "local" (sliding-window attn) | "mamba" | "mlstm" | "slstm"
    mlp:   "dense" | "moe" | "none"

``layer_pattern`` is repeated ``num_layers / len(layer_pattern)`` times,
then the unscanned ``tail_pattern``.  The reference runs each pattern slot
as one ``lax.scan`` over its repeats; the port's model runs the same
blocks as a Python loop over repeats x pattern, then the tail.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

Block = Tuple[str, str]  # (mixer, mlp)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[Block, ...] = (("attn", "dense"),)
    tail_pattern: Tuple[Block, ...] = ()  # unscanned remainder blocks
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    window: int = 0  # sliding window for "local" mixers (0 = no local layers)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert FFN width (defaults to d_ff)
    capacity_factor: float = 1.25
    # SSM / xLSTM
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # structure
    encoder_only: bool = False  # no causal mask, no decode step
    frontend: str = ""  # "vision" | "audio": stub supplies embeddings
    frontend_len: int = 0  # prefix length of frontend embeddings
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # memory/distribution knobs (overridable per shape/hillclimb)
    zero: bool = True  # True: FSDP/"sortdest" grad sync; False: replicated DP
    serve_zero: bool = False  # serve cells: also fsdp-shard params (for archs
    #                           whose weights exceed TP-sharded HBM)
    remat: str = "dots"  # none | dots | full
    scan_layers: bool = True
    opt_moment_dtype: str = "float32"  # bf16: halve optimizer state (1T archs)

    def __post_init__(self):
        body = self.num_layers - len(self.tail_pattern)
        if body % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by "
                f"pattern length {len(self.layer_pattern)}")
        for mixer, mlp in self.layer_pattern + self.tail_pattern:
            assert mixer in ("attn", "local", "mamba", "mlstm", "slstm"), mixer
            assert mlp in ("dense", "moe", "none"), mlp

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def repeats(self) -> int:
        return (self.num_layers - len(self.tail_pattern)) \
            // len(self.layer_pattern)

    @property
    def has_attention(self) -> bool:
        return any(m in ("attn", "local") for m, _ in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no block needs an unbounded full-attention KV cache."""
        return all(m != "attn" for m, _ in self.layer_pattern)

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility per the brief: SSM/hybrid/linear-attn archs
        (any non-attention mixer) and local-attention archs run; *pure*
        full-attention archs and encoder-only archs skip."""
        if self.encoder_only:
            return False
        mixers = {m for m, _ in self.layer_pattern + self.tail_pattern}
        return bool(mixers - {"attn"})

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.hd
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        n += self._pattern_params(self.layer_pattern) * self.repeats
        n += self._pattern_params(self.tail_pattern)
        return n

    def _pattern_params(self, pattern) -> int:
        d, hd = self.d_model, self.hd
        per_pattern = 0
        for mixer, mlp in pattern:
            if mixer in ("attn", "local"):
                per_pattern += d * self.num_heads * hd  # wq
                per_pattern += 2 * d * self.num_kv_heads * hd  # wk, wv
                per_pattern += self.num_heads * hd * d  # wo
            elif mixer == "mamba":
                di = self.ssm_expand * d
                per_pattern += d * 2 * di + di * d  # in/out proj
                per_pattern += di * (self.ssm_conv + 2 * self.ssm_state + 2)
            elif mixer in ("mlstm", "slstm"):
                di = self.ssm_expand * d
                per_pattern += d * di * 4 + di * d  # qkv+gates, out
            if mlp == "dense":
                per_pattern += 3 * d * self.d_ff  # swiglu
            elif mlp == "moe":
                per_pattern += d * self.num_experts  # router
                per_pattern += self.num_experts * 3 * d * self.expert_ff
            per_pattern += 2 * d  # norms
        return per_pattern

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts experts)."""
        if self.num_experts == 0:
            return self.param_count()
        d = self.d_model
        moe_blocks = sum(1 for _, m in self.layer_pattern if m == "moe") \
            * self.repeats + sum(1 for _, m in self.tail_pattern if m == "moe")
        inactive = (self.num_experts - self.top_k) * 3 * d * self.expert_ff
        return self.param_count() - inactive * moe_blocks


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (seq_len x global_batch, train or serve)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

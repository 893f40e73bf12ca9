"""Model / run configuration schema.

One `ModelConfig` describes any of the assigned architectures; family-specific
sub-configs (MoE / SSM / recurrent / enc-dec) are optional blocks.  Layer
heterogeneity (gemma3 5:1 local:global, recurrentgemma 2:1 rec:attn) is a
`pattern` of block kinds that repeats; models scan over stacked *super-block*
params (one pattern period per scan step) plus an explicit remainder.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_chunk: int = 512          # chunked GShard dispatch (memory-safe)
    aux_loss_weight: float = 0.01
    impl: str = "onehot"             # "onehot" (GShard baseline) | "gather"


@dataclasses.dataclass(frozen=True)
class SSDConfig:               # Mamba2 (state-space duality)
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:         # Griffin / RecurrentGemma RG-LRU block
    rnn_width: int = 0          # 0 -> d_model
    conv_width: int = 4
    c_constant: float = 8.0


@dataclasses.dataclass(frozen=True)
class EncDecConfig:            # Whisper-style
    encoder_layers: int = 24
    encoder_len: int = 1500     # conv-frontend output frames (stubbed input)


# Block kinds usable in `pattern`:
#   "attn"   full causal self-attention + FFN
#   "local"  sliding-window self-attention + FFN
#   "global" full attention (alias of attn, named for 5:1 patterns)
#   "rec"    RG-LRU recurrent block + FFN
#   "ssd"    Mamba2 SSD mixer (no separate FFN)
BLOCK_KINDS = ("attn", "local", "global", "rec", "ssd")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    pattern: Tuple[str, ...] = ("attn",)   # repeats to cover n_layers
    window: int = 1024                     # for "local" blocks
    rope_theta: float = 1e4
    rope_theta_local: float = 0.0          # 0 -> same as rope_theta
    mrope_sections: Optional[Tuple[int, int, int]] = None   # qwen2-vl M-RoPE
    qk_norm: bool = False
    sandwich_norm: bool = False            # gemma3 pre+post block norms
    norm: str = "rms"                      # rms | ln | ln_nonparam
    gated_mlp: bool = True
    act: str = "silu"
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssd: Optional[SSDConfig] = None
    rec: Optional[RecurrentConfig] = None
    encdec: Optional[EncDecConfig] = None
    dtype: str = "bfloat16"                # activation dtype
    param_dtype: str = "bfloat16"
    kv_dtype: str = ""                     # "" -> dtype; "int8" -> quantized
    #   KV cache (per-(pos,head) absmax scales; decode cells are memory-
    #   bound on cache reads, int8 halves that traffic)
    # which shapes this arch skips and why (assignment rules)
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    # ---- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Physical vocab rounded to a multiple of 128 so the embedding /
        head tables shard evenly on any model-axis width that divides 128
        (granite 49155, whisper 51865, mamba2 50280 are not 16-divisible).
        Loss and sampling mask columns >= vocab_size."""
        return -(-self.vocab_size // 128) * 128

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers % len(self.pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssd" for k in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.hd
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        total = self.vocab_size * d                         # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                    # lm head
        per_kind = {}
        attn = d * n_q + 2 * d * n_kv + n_q * d
        ffn_mult = 3 if self.gated_mlp else 2
        if self.moe:
            ffn = (self.moe.n_experts * ffn_mult * d * self.d_ff
                   + d * self.moe.n_experts)                # experts + router
        else:
            ffn = ffn_mult * d * self.d_ff
        per_kind["attn"] = per_kind["local"] = per_kind["global"] = attn + ffn
        if self.rec:
            w = self.rec.rnn_width or d
            rec = (2 * d * w                 # two input branches
                   + self.rec.conv_width * w  # conv
                   + 2 * w                    # gates' diagonal params
                   + 2 * w * w                # gate projections (lru)
                   + w * d)                   # out proj
            per_kind["rec"] = rec + ffn
        if self.ssd:
            di = self.ssd.expand * d
            nh = di // self.ssd.head_dim
            g = self.ssd.n_groups
            ssd = (d * (2 * di + 2 * g * self.ssd.d_state + nh)  # in_proj
                   + self.ssd.conv_width * (di + 2 * g * self.ssd.d_state)
                   + 2 * nh                                       # A_log, D
                   + di * d)                                      # out_proj
            per_kind["ssd"] = ssd
        for i in range(self.n_layers):
            kind = self.pattern[i % len(self.pattern)]
            total += per_kind[kind]
        if self.encdec:
            # encoder self-attn + ffn, decoder adds cross-attn.
            total += self.encdec.encoder_layers * (attn + ffn)
            total += self.n_layers * attn                   # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        ffn_mult = 3 if self.gated_mlp else 2
        dense_ffn = self.moe.n_experts * ffn_mult * d * self.d_ff
        active_ffn = self.moe.top_k * ffn_mult * d * self.d_ff
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if self.pattern[i % len(self.pattern)] in
            ("attn", "local", "global", "rec"))
        return int(self.param_count() - n_moe_layers * (dense_ffn - active_ffn))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

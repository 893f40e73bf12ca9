"""Moonshot-v1-16B-A3B (Moonlight) — MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    pattern=("attn",), rope_theta=5e4,
    norm="rms", gated_mlp=True, act="silu",
    moe=MoEConfig(n_experts=64, top_k=6),
    skip_shapes=(("long_500k", "pure full-attention arch"),),
)

"""Granite-MoE 3B-a800m — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    pattern=("attn",), rope_theta=1e4,
    norm="rms", gated_mlp=True, act="silu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8),
    skip_shapes=(("long_500k", "pure full-attention arch"),),
)

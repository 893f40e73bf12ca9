"""Qwen2-VL-72B — VLM text backbone with M-RoPE; vision frontend stubbed
[arXiv:2409.12191; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    pattern=("attn",), rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    norm="rms", gated_mlp=True, act="silu",
    skip_shapes=(("long_500k", "pure full-attention arch"),),
)

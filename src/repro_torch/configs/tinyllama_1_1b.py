"""TinyLlama-1.1B — llama2-arch small dense LM [arXiv:2401.02385; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab_size=32000,
    pattern=("attn",), rope_theta=1e4,
    norm="rms", gated_mlp=True, act="silu",
    skip_shapes=(("long_500k", "pure full-attention arch"),),
)

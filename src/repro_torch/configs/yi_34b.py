"""Yi-34B — llama-arch GQA dense LM [arXiv:2403.04652; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    pattern=("attn",), rope_theta=5e6,
    norm="rms", gated_mlp=True, act="silu",
    skip_shapes=(("long_500k", "pure full-attention arch"),),
)

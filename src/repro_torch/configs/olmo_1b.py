"""OLMo-1B — dense LM with non-parametric LayerNorm [arXiv:2402.00838; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    pattern=("attn",), rope_theta=1e4,
    norm="ln_nonparam", gated_mlp=True, act="silu",
    tie_embeddings=True,
    skip_shapes=(("long_500k", "pure full-attention arch"),),
)

"""Gemma3-27B — dense LM, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt scaled per assignment; unverified]."""

from repro_torch.configs.base import ModelConfig

# 62 layers = 10 x (5 local + 1 global) + 2 local remainder.
CONFIG = ModelConfig(
    name="gemma3-27b",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, rope_theta=1e6, rope_theta_local=1e4,
    qk_norm=True, sandwich_norm=True,
    norm="rms", gated_mlp=True, act="gelu",
    tie_embeddings=True,
)

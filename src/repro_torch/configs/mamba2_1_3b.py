"""Mamba2-1.3B — attention-free SSM with SSD [arXiv:2405.21060; unverified]."""

from repro_torch.configs.base import ModelConfig, SSDConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    pattern=("ssd",), rope_theta=0.0,
    norm="rms", gated_mlp=False, act="silu",
    tie_embeddings=True,
    ssd=SSDConfig(d_state=128, head_dim=64, expand=2, chunk=256,
                  conv_width=4, n_groups=1),
)

"""Whisper-medium — enc-dec audio backbone, conv frontend stubbed
[arXiv:2212.04356; unverified]."""

from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    pattern=("attn",), rope_theta=0.0,        # sinusoidal/absolute positions
    norm="ln", gated_mlp=False, act="gelu",
    encdec=EncDecConfig(encoder_layers=24, encoder_len=1500),
    skip_shapes=(("long_500k", "full-attention enc-dec"),),
)

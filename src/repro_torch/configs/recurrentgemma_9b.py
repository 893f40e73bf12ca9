"""RecurrentGemma-9B — Griffin: RG-LRU + local attention, 1 attn : 2 rec
[arXiv:2402.19427; unverified]."""

from repro_torch.configs.base import ModelConfig, RecurrentConfig

# 38 layers = 12 x (rec, rec, attn) + 2 rec remainder.
CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    pattern=("rec", "rec", "attn"),
    window=2048, rope_theta=1e4,
    norm="rms", gated_mlp=True, act="gelu",
    tie_embeddings=True,
    rec=RecurrentConfig(rnn_width=4096, conv_width=4),
)

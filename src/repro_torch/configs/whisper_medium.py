"""whisper-medium [audio]: enc-dec, 24L each side, d_model=1024 16H
d_ff=4096 vocab=51865 [arXiv:2212.04356] — the numbers of
``repro.configs.whisper_medium``.

The conv frontend is a stub: callers hand in precomputed (B, 1500,
d_model) frame embeddings.  The encoder adds learned positions and runs
bidirectional attention; the decoder is causal, with cross-attention to
the encoder's output, and its positions use RoPE (the reference's
adaptation of whisper's learned 448-position table).
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51_865,
    enc_dec=True, n_enc_layers=24, n_frames=1500,
    mlp_kind="gelu", norm_kind="layernorm",
    tie_embeddings=True,
)

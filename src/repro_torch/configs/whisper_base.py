"""whisper-base [audio]: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.

Encoder-decoder whose convolutional audio frontend is a stub, as in the
reference: a batch carries precomputed mel-frame embeddings ``enc_emb``
(B, S_src, d); only the transformer backbone is modelled (LayerNorm
blocks, GELU MLPs, cross-attention in every decoder block).
[arXiv:2212.04356]
"""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="whisper-base", family="encdec", n_layers=6, d_model=512,
    n_heads=8, n_kv=8, head_dim=64, d_ff=2048, vocab=51865,
    act="gelu", norm="ln", rope_theta=1e4, qk_norm=False, kv_repeat=1,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke", family="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv=4, head_dim=16, d_ff=128, vocab=384,
    act="gelu", norm="ln", rope_theta=1e4,
)

"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 blocks and ONE shared full-attention
block applied every 6 layers (weights shared, one KV cache per
application).  [arXiv:2411.15242; hf]
"""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b", family="zamba2", n_layers=38, d_model=2048,
    n_heads=32, n_kv=32, head_dim=64, d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, attn_every=6, act="gelu",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="zamba2", n_layers=5, d_model=64,
    n_heads=4, n_kv=4, head_dim=16, d_ff=128, vocab=384,
    ssm_state=16, ssm_head_dim=16, attn_every=2, act="gelu", lin_chunk=8,
)

"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2, gelu experts.  [hf:xai-org/grok-1;
unverified]

kv_repeat=2 gives 16 cached KV heads (a group of 3).
"""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv=8, head_dim=128, d_ff=32768, vocab=131072,
    moe_experts=8, moe_top_k=2, act="gelu", kv_repeat=2, remat="dots",
)

SMOKE = ModelConfig(
    name="grok-1-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=384,
    moe_experts=4, moe_top_k=2, act="gelu",
)

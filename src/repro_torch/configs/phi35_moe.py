"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, head_dim=128, d_ff=6400, vocab=32064,
    moe_experts=16, moe_top_k=2, act="swiglu", kv_repeat=2, remat="dots",
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, head_dim=16, d_ff=96, vocab=384,
    moe_experts=4, moe_top_k=2, act="swiglu",
)

"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA, explicit head_dim=128.  [hf:Qwen/Qwen3-4B]
"""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
    n_heads=32, n_kv=8, head_dim=128, d_ff=9728, vocab=151936,
    act="swiglu", qk_norm=True, kv_repeat=2,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, head_dim=16, d_ff=256, vocab=384,
    act="swiglu", qk_norm=True,
)

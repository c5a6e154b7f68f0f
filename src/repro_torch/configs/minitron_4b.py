"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — width/depth-pruned nemotron, squared-ReLU MLP.
[arXiv:2407.14679; hf]
"""
from repro_torch.models.model import ModelConfig

# kv_repeat=1: 24 q heads over 8 KV heads, a group of 3 (the reference
# replicates attention rather than shard 24 heads 16 ways)
FULL = ModelConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv=8, head_dim=128, d_ff=9216, vocab=256000,
    act="relu2", rope_theta=1e4, kv_repeat=1,
)

SMOKE = ModelConfig(
    name="minitron-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, head_dim=16, d_ff=192, vocab=384, act="relu2",
)

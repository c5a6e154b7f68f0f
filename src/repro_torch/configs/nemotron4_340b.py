"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU MLP; head_dim = 18432 / 96 = 192.
[arXiv:2402.16819; unverified]

At full width it does not fit one card (its head alone is 4.7 G
weights).
"""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-340b", family="dense", n_layers=96, d_model=18432,
    n_heads=96, n_kv=8, head_dim=192, d_ff=73728, vocab=256000,
    act="relu2", rope_theta=1e4, kv_repeat=2, remat="dots",
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv=2, head_dim=16, d_ff=384, vocab=384, act="relu2",
)

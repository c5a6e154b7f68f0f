"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.

RWKV6 "Finch": a linear RNN with data-dependent decay, head size 64 (40
heads); decode carries O(1) state.  [arXiv:2404.05892; hf]
"""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="rwkv6-3b", family="rwkv6", n_layers=32, d_model=2560,
    d_ff=8960, vocab=65536, ssm_head_dim=64, lin_chunk=16,
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke", family="rwkv6", n_layers=2, d_model=64,
    d_ff=224, vocab=384, ssm_head_dim=16, lin_chunk=8,
)

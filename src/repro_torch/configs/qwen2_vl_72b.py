"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

The vision frontend is a stub, as in the reference: a batch carries
precomputed patch embeddings ``vis_emb`` (B, P, d) merged in front of
the tokens, and (t, h, w) M-RoPE position ids ``positions_thw`` (B,
P + S, 3) for the whole sequence.  The reference's ``remat`` (a training
field) is not carried.
"""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv=8, head_dim=128, d_ff=29568, vocab=152064,
    act="swiglu", kv_repeat=2,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm", n_layers=2, d_model=96,
    n_heads=6, n_kv=2, head_dim=16, d_ff=192, vocab=384,
)

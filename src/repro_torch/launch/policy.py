"""Launch policy tables shared by the dry run and its tools.

Kept free of import side effects, so analysis code can read these
tables without starting anything.
"""
from __future__ import annotations

# microbatch accumulation per arch for the train cells; constraint:
# (global_batch / microbatches) stays divisible by the DP extent.
MICROBATCHES = {
    "whisper_base": 16, "rwkv6_3b": 4, "grok1_314b": 8, "phi35_moe": 8,
    "qwen2_vl_72b": 8, "qwen3_4b": 4, "nemotron4_340b": 8,
    "minitron_4b": 16, "qwen3_8b": 8, "zamba2_1p2b": 4,
}

# optimizer-state / grad-accumulator storage precision per arch (the
# >= 300B cells cannot hold float32 AdamW triples on one pod).
TRAIN_DTYPES = {
    "grok1_314b": ("bfloat16", "bfloat16"),
    "nemotron4_340b": ("bfloat16", "bfloat16"),
    "qwen2_vl_72b": ("bfloat16", "float32"),
}

# archs whose train cells shard the residual-stream sequence dim over
# "model" (Megatron-style sequence parallelism).
TRAIN_SEQ_PARALLEL = {"nemotron4_340b", "qwen2_vl_72b", "grok1_314b"}


def microbatches_for(arch: str, shape_kind: str, global_batch: int,
                     multi_pod: bool) -> int:
    if shape_kind != "train":
        return 1
    mb = MICROBATCHES.get(arch, 1)
    dp = 32 if multi_pod else 16
    return min(mb, max(1, global_batch // dp))

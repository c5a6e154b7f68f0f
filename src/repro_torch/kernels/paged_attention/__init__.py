"""Paged ragged decode attention: two CUDA lanes + plain PyTorch oracles.

``paged_attention`` (ops.py) dispatches between the gather-then-SDPA
**scratch** lane and the online-softmax **streamed** lane; dispatches
land in ``crossstack_dispatch_total{path=paged_*}`` and
``paged_path_calls`` is the summed view.
"""
from repro_torch.kernels.paged_attention.kernel import (
    paged_attention_scratch,
    paged_attention_streamed,
)
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_path_calls,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_attention_split_ref,
    paged_attention_streamed_ref,
    resolve_block_pages,
)

__all__ = [
    "paged_attention", "paged_attention_ref", "paged_attention_scratch",
    "paged_attention_split_ref",
    "paged_attention_streamed", "paged_attention_streamed_ref",
    "paged_path_calls", "resolve_block_pages",
]

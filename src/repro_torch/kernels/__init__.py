"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``).  A wrapper given CUDA tensors launches its kernel
(or raises); given CPU tensors it runs the plain version."""
from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by kernel: the ``LAUNCHES``
    of each kernel module, merged.  A launch recorded into a CUDA graph
    counts once, when it is recorded; the graph's replays run it again
    and count nothing."""
    from repro_torch.kernels.crossbar_mac import kernel as mac
    from repro_torch.kernels.deepnet_stream import kernel as ds
    from repro_torch.kernels.ir_solve import kernel as ir
    from repro_torch.kernels.paged_attention import kernel as pa
    out: Dict[str, int] = {}
    for counts in (mac.LAUNCHES, pa.LAUNCHES, ds.LAUNCHES, ir.LAUNCHES):
        out.update(counts)
    return out

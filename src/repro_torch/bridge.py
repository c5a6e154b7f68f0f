"""Carry parameters from the reference package into the port.

``params_from_numpy(tree, device)`` takes params as nested dicts of
numpy arrays — what ``jax.device_get`` returns for the
reference's params — and returns the same tree of torch tensors on
``device``.  Layouts are unchanged (``wq`` stays ``(d, h, hd)``, ``wo``
``(h, hd, d)``, layer stacks keep their leading axis), so both packages
program and compute from identical weights.  bfloat16 arrays (numpy's
``ml_dtypes`` extension type) arrive bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # the port owns its copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of torch tensors on
    ``device`` (CUDA by default)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(np.asarray(node), dev)

    return conv(tree)

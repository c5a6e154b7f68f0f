"""Device resolution for the port's entry points.

``None`` and ``"cuda"`` mean the card; ``"cpu"`` must be asked for by
name.  A request for the card on a machine without one raises: the port
never moves to the CPU behind the caller's back.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> that CUDA device (raises when
    CUDA is absent); ``"cpu"`` -> the CPU; anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: want 'cuda' "
                         f"(the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev

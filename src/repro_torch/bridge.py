"""Carry parameters from the reference package into the port.

``params_from_numpy(tree, device)`` takes params as nested dicts of
numpy arrays — what ``jax.device_get`` returns for the
reference's params — and returns the same tree of torch tensors on
``device``.  Layouts are unchanged (``wq`` stays ``(d, h, hd)``, ``wo``
``(h, hd, d)``, layer stacks keep their leading axis), so both packages
program and compute from identical weights.  bfloat16 and
float8_e4m3fn arrays (numpy's ``ml_dtypes`` extension types, which this
module does not import) arrive bit for bit: they cross as their raw
bytes.  ``torch_dtype`` maps a reference dtype (``jnp.float8_e4m3fn``,
by its numpy name) to the port's.  ``mode_state_from_numpy`` carries a
reference ``modes.StackState`` or ``BankState`` (as ``jax.device_get``
returns it) into the port's, planes, selector and index alike.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import modes
from repro_torch.device import DeviceLike, resolve_device

#: numpy dtype names of the reference's float types -> torch dtypes
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float8_e4m3fn": torch.float8_e4m3fn}
#: extension types numpy cannot hand to torch: carried as raw bits
_RAW = {"bfloat16": np.int16, "float8_e4m3fn": np.uint8}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a reference (numpy or JAX) float dtype."""
    return _TORCH_DTYPES[np.dtype(dtype).name]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # the port owns its copy
    raw = _RAW.get(a.dtype.name)
    if raw is not None:
        return torch.from_numpy(a.view(raw)).view(
            torch_dtype(a.dtype)).to(device)
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


def mode_state_from_numpy(state: Any, device: DeviceLike = None):
    """A reference ``StackState`` (``g_top``, ``g_bot``, ``read_top``) or
    ``BankState`` (``g``, ``read_idx``) of numpy arrays -> the port's on
    ``device`` (CUDA by default): float32 planes, a 0-d bool
    ``read_top``, a 0-d int32 ``read_idx``."""
    dev = resolve_device(device)
    if hasattr(state, "g_top"):
        return modes.StackState(
            _tensor(state.g_top, dev), _tensor(state.g_bot, dev),
            _tensor(np.asarray(state.read_top, dtype=np.bool_), dev))
    return modes.BankState(
        _tensor(state.g, dev),
        _tensor(np.asarray(state.read_idx, dtype=np.int32), dev))

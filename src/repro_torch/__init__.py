"""CrossStack on PyTorch and CUDA: the crossbar inference engine served on
an NVIDIA Hopper card.

The package mirrors ``repro`` (the JAX/Pallas reference) module for
module: ``core/`` (quantization, the crossbar engine, plane banks, the
weight-resident executor), ``kernels/`` (hand-written CUDA kernels with
their plain PyTorch versions), ``models/``, ``serve/``, ``obs/`` and
``launch/``.  It imports neither JAX nor anything of ``repro``.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); there is no silent CPU
fallback.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

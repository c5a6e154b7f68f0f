"""Binding of the CUDA Jacobi-sweep kernel (``csrc/ir_solve.cu``).

``jacobi_sweeps`` launches the kernel for CUDA tensors and runs the plain
version (``ref.jacobi_sweep_ref``, ``sweeps`` times) for CPU tensors; a
CUDA call the kernel cannot take raises.  ``LAUNCHES["jacobi_sweeps"]``
counts calls that launched the kernel (one call is one launch that
forms the denominators plus one launch per sweep) and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ir_solve import ref

#: kernel calls since the count was last set to 0
LAUNCHES = {"jacobi_sweeps": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("ir_solve")
    if lib.jacobi_sweeps_launch.argtypes is None:
        lib.jacobi_sweeps_launch.argtypes = (
            [_P] * 10 + [_I, _I, _F, _F, _I, _P])
        lib.jacobi_sweeps_launch.restype = _I
    return lib


def jacobi_sweeps(g, v_in, v_row, v_col, *, g_w: float, omega: float = 1.0,
                  sweeps: int = 8):
    """Run ``sweeps`` damped-Jacobi iterations.  g, v_row, v_col: (n, m)
    float32; v_in: (n, 1) source voltages.  Returns the new (v_row,
    v_col); the inputs are not modified."""
    if g.device.type == "cpu":
        vin = v_in.reshape(-1)
        for _ in range(sweeps):
            v_row, v_col = ref.jacobi_sweep_ref(v_row, v_col, g, vin, g_w,
                                                omega)
        return v_row, v_col
    dev = g.device
    if g.dim() != 2:
        raise ValueError(f"g must be (n, m), got {tuple(g.shape)}")
    n, m = g.shape
    if n < 2 or m < 2:
        raise ValueError(f"the network needs n, m >= 2, got {n} x {m}")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    for name, t, shape in (("g", g, (n, m)), ("v_row", v_row, (n, m)),
                           ("v_col", v_col, (n, m)), ("v_in", v_in, (n, 1))):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32 {shape} on "
                            f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
    den_r = torch.empty_like(g)
    den_c = torch.empty_like(g)
    # ping-pong buffers: sweep s reads (a) and writes (b), then they swap;
    # the result lands in the pair the last sweep wrote
    bufs = [torch.empty_like(g) for _ in range(4)]
    out_row = bufs[0] if sweeps % 2 else bufs[2]
    out_col = bufs[1] if sweeps % 2 else bufs[3]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().jacobi_sweeps_launch(
            g.data_ptr(), v_in.data_ptr(), v_row.data_ptr(),
            v_col.data_ptr(), den_r.data_ptr(), den_c.data_ptr(),
            *(t.data_ptr() for t in bufs), n, m, float(g_w), float(omega),
            sweeps, stream)
    build.check(err, "jacobi_sweeps")
    LAUNCHES["jacobi_sweeps"] += 1
    return out_row, out_col

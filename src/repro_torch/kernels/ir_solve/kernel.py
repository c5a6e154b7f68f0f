"""Binding of the CUDA Jacobi-sweep kernel (``csrc/ir_solve.cu``).

``jacobi_sweeps`` launches the kernel for CUDA tensors and runs the plain
version (``ref.jacobi_sweep_ref``, ``sweeps`` times) for CPU tensors; a
CUDA call the kernel cannot take raises, before any launch.
``LAUNCHES["jacobi_sweeps"]`` counts calls that launched the kernel (one
call is one kernel launch, whatever the number of sweeps; a plan of more
than one band zeroes its halo buffer with a memset just before it) and
nothing else.

:func:`band_plan` chooses, for an n x m network, how the kernel splits
the rows into bands (one CTA each, every node on chip for all sweeps);
neighbouring bands exchange their edge rows through L2 in one
cooperative launch (at most one band per SM).  It is a pure function of
the shape, so the CPU tests check it against the card's limits.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ir_solve import ref

#: kernel calls since the count was last set to 0
LAUNCHES = {"jacobi_sweeps": 0}

#: the H100 SXM's limits the plan keeps to
SMS = 132                      # co-resident bands of a cooperative launch
MAX_THREADS = 1024
PER_THREAD = (1, 2, 4, 8)      # nodes a thread, each compiled
SMEM_LIMIT = 232_448           # shared-memory bytes one CTA may take
#: the plan's targets, measured on an H100 (PERF.md, §6): a sweep is
#: fastest at about 256 nodes a band, one node a thread, and at 128 bands
#: rather than all 132
TARGET_NODES = 256
MAX_BANDS = 128
CAPACITY = (f"{SMS} co-resident bands of at most "
            f"{MAX_THREADS * PER_THREAD[-1]} nodes and {SMEM_LIMIT} bytes "
            f"of shared memory each")


@dataclass(frozen=True)
class BandPlan:
    """One launch: ``bands`` CTAs, band b holding rows [b n // bands,
    (b + 1) n // bands) (at most ``rows``), each of ``threads`` threads
    owning ``per_thread`` nodes, with ``smem_bytes`` of shared memory."""
    bands: int
    rows: int
    threads: int
    per_thread: int
    smem_bytes: int

    @property
    def cooperative(self) -> bool:
        """More than one band: a cooperative launch with a halo buffer."""
        return self.bands > 1


def band_smem_bytes(rows: int, m: int) -> int:
    """Shared memory of a band of ``rows`` x m nodes: v_row with a ghost
    column each side and v_col with a ghost row above and below
    (``band_smem_floats`` in ``csrc/ir_solve.cu``)."""
    return 4 * (rows * (m + 2) + (rows + 2) * m)


def _fit(n: int, m: int, bands: int) -> Optional[BandPlan]:
    rows = -(-n // bands)
    nodes = rows * m
    per = next((k for k in PER_THREAD if k * MAX_THREADS >= nodes), None)
    smem = band_smem_bytes(rows, m)
    if per is None or smem > SMEM_LIMIT:
        return None
    threads = -(-nodes // per)
    threads = -(-threads // 32) * 32
    return BandPlan(bands, rows, threads, per, smem)


@functools.lru_cache(maxsize=256)
def band_plan(n: int, m: int) -> BandPlan:
    """The launch plan of an n x m network: about ``TARGET_NODES`` nodes
    per band, at most one band per row and ``MAX_BANDS`` bands, or more
    bands (up to ``SMS``) where a band would not fit.  Raises
    ``ValueError`` past the card's capacity."""
    if n < 2 or m < 2:
        raise ValueError(f"the network needs n, m >= 2, got {n} x {m}")
    top = min(n, SMS)
    want = max(1, min(n, MAX_BANDS, -(-(n * m) // TARGET_NODES)))
    for bands in range(want, top + 1):
        plan = _fit(n, m, bands)
        if plan is not None:
            return plan
    raise ValueError(f"an {n} x {m} network is past the capacity of the "
                     f"Jacobi kernel: {CAPACITY}")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("ir_solve")
    if lib.jacobi_sweeps_launch.argtypes is None:
        lib.jacobi_sweeps_launch.argtypes = (
            [_P] * 7 + [_I] * 7 + [_F, _F, _I, _P])
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
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    plan = band_plan(n, m)
    for name, t, shape in (("g", g, (n, m)), ("v_row", v_row, (n, m)),
                           ("v_col", v_col, (n, m)), ("v_in", v_in, (n, 1))):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32 {shape} on "
                            f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
    out_row = torch.empty_like(g)
    out_col = torch.empty_like(g)
    halo = None
    if plan.cooperative:
        # edge rows [parity][band][top, bottom][m], each value beside the
        # number of the sweep that made it in one 64-bit word
        scratch = torch.empty(4 * plan.bands * m, dtype=torch.int64,
                              device=dev)
        halo = scratch.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().jacobi_sweeps_launch(
            g.data_ptr(), v_in.data_ptr(), v_row.data_ptr(),
            v_col.data_ptr(), out_row.data_ptr(), out_col.data_ptr(), halo,
            n, m, plan.bands, plan.rows, plan.threads, plan.per_thread,
            plan.smem_bytes, float(g_w), float(omega), sweeps, stream)
    build.check(err, "jacobi_sweeps")
    LAUNCHES["jacobi_sweeps"] += 1
    return out_row, out_col

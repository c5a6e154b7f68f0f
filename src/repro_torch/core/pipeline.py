"""Deep-net mode: the in-situ read/write pipeline (paper §III-B, §V).

The counterpart of ``repro.core.pipeline``.  A conventional crossbar
runs a deep net as

    write W_l -> read layer l -> write W_{l+1} -> read layer l+1 -> ...

serialized, because the single array cannot be read and programmed at
once.  CrossStack's deep-net mode keeps the two stacked planes isolated
(complementary RE), so while plane A produces layer l's read-out, plane
B is *simultaneously* programmed with W_{l+1}: the (shorter) read time
is subsumed within the programming time — 29 % faster per 10-bit
convolution (t_read = 10 ns/pulse, t_write = 250 ns).

This module provides the event-level schedule builder (validated for
overlap-correctness) and the closed-form speedup, both pure Python; the
functional executor ``deepnet_mlp``, which runs an MLP through the
engine layer by layer (the pipeline reorders *time*, not *math*); and
the same schedule algebra applied to weight streaming
(``streaming_speedup``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Sequence

import torch

from repro_torch.core import engine as eng
from repro_torch.core.timing import PAPER, CrossStackParams, read_time


class Phase(NamedTuple):
    layer: int
    kind: str      # "write" | "read"
    start: float
    end: float
    plane: int     # 0 | 1


@dataclasses.dataclass(frozen=True)
class Schedule:
    phases: List[Phase]
    total: float

    def validate(self) -> None:
        """Structural invariants of a legal deep-net schedule."""
        by_layer = {}
        for ph in self.phases:
            by_layer.setdefault(ph.layer, {})[ph.kind] = ph
        for layer, d in by_layer.items():
            w, r = d["write"], d["read"]
            assert r.start >= w.end - 1e-15, (
                f"layer {layer}: read before its write completed")
            assert w.plane == r.plane, (
                f"layer {layer}: read/write plane mismatch")
            if layer > 0:
                prev_r = by_layer[layer - 1]["read"]
                assert r.start >= prev_r.end - 1e-15, (
                    f"layer {layer}: read before its input was produced")
        # no plane is read and written at the same instant
        for a in self.phases:
            for b in self.phases:
                if (a.plane == b.plane and a.kind == "read"
                        and b.kind == "write" and a.layer != b.layer):
                    assert (a.end <= b.start + 1e-15
                            or b.end <= a.start + 1e-15), (
                        f"plane {a.plane}: overlapping read (L{a.layer}) "
                        f"and write (L{b.layer})")


def serial_schedule(n_layers: int, in_bits: int,
                    p: CrossStackParams = PAPER) -> Schedule:
    """Conventional 2-D array: write then read, strictly alternating."""
    t, phases = 0.0, []
    t_r = read_time(in_bits, p)
    for l in range(n_layers):
        phases.append(Phase(l, "write", t, t + p.t_write, 0))
        t += p.t_write
        phases.append(Phase(l, "read", t, t + t_r, 0))
        t += t_r
    return Schedule(phases, t)


def deepnet_schedule(n_layers: int, in_bits: int,
                     p: CrossStackParams = PAPER) -> Schedule:
    """Pipelined schedule: write of layer l+1 overlaps read of layer l.

    Layer l lives on plane l % 2.  The write of layer l+1 may start as
    soon as its plane is free (the read of layer l-1 finished); the read
    of layer l starts when both its own write and the previous read are
    done.
    """
    t_r = read_time(in_bits, p)
    phases: List[Phase] = []
    write_end = [0.0] * n_layers
    read_end = [0.0] * n_layers
    for l in range(n_layers):
        plane = l % 2
        # plane free once the read two layers back has finished
        plane_free = read_end[l - 2] if l >= 2 else 0.0
        w_start = max(plane_free,
                      write_end[l - 1] if l >= 1 else 0.0)  # one write port
        w_end = w_start + p.t_write
        write_end[l] = w_end
        r_start = max(w_end, read_end[l - 1] if l >= 1 else 0.0)
        r_end = r_start + t_r
        read_end[l] = r_end
        phases.append(Phase(l, "write", w_start, w_end, plane))
        phases.append(Phase(l, "read", r_start, r_end, plane))
    return Schedule(phases, read_end[-1])


def speedup(n_layers: int, in_bits: int,
            p: CrossStackParams = PAPER) -> float:
    """Fractional latency reduction of deep-net over serial execution."""
    s = serial_schedule(n_layers, in_bits, p)
    d = deepnet_schedule(n_layers, in_bits, p)
    d.validate()
    return 1.0 - d.total / s.total


# ---------------------------------------------------------------------------
# Functional executor: MLP through the plane ping-pong
# ---------------------------------------------------------------------------

def deepnet_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
                cfg: eng.EngineConfig,
                act: Callable[[torch.Tensor], torch.Tensor] = torch.relu
                ) -> torch.Tensor:
    """Run an MLP through the deep-net state machine.

    Layer l's programmed tiles live on plane l % 2 while plane (l+1) % 2
    is being loaded with layer l+1 — functionally identical to the
    sequential net; the gain is temporal and is accounted by
    ``deepnet_schedule``, so the layers program and read in order here
    (``engine.program``, then ``engine.matmul``: the CUDA MAC under
    ``cfg.use_kernel``).  Engine mode must be "deepnet" so each ADC
    conversion spans a single plane.
    """
    if cfg.mode != "deepnet":   # the reference's assert, kept under -O
        raise AssertionError("deepnet_mlp requires deep-net engine mode")
    h = x
    n = len(weights)
    for l, w in enumerate(weights):
        pw = eng.program(w, cfg)    # "write" of plane l % 2
        h = eng.matmul(h, pw, cfg)  # "read" concurrent with write l+1
        if l < n - 1:
            h = act(h)
    return h


def latency_report(n_layers: int, in_bits: int,
                   p: CrossStackParams = PAPER) -> dict:
    s = serial_schedule(n_layers, in_bits, p)
    d = deepnet_schedule(n_layers, in_bits, p)
    d.validate()
    return {
        "n_layers": n_layers,
        "in_bits": in_bits,
        "t_serial_us": s.total * 1e6,
        "t_deepnet_us": d.total * 1e6,
        "speedup_frac": 1.0 - d.total / s.total,
        "steady_state_frac": 1.0 - max(p.t_write, read_time(in_bits, p))
        / (p.t_write + read_time(in_bits, p)),
    }


# ---------------------------------------------------------------------------
# The same schedule algebra for weight streaming
# ---------------------------------------------------------------------------

def streaming_speedup(t_compute: float, t_dma: float, n_tiles: int) -> float:
    """Deep-net schedule applied to weight streaming.

    read  == compute of tile l             (t_compute)
    write == transfer of tile l+1's weights (t_dma)

    Serial: n * (t_dma + t_compute); pipelined: t_dma + n * max(...).
    """
    serial = n_tiles * (t_dma + t_compute)
    piped = t_dma + n_tiles * max(t_dma, t_compute)
    return 1.0 - piped / serial

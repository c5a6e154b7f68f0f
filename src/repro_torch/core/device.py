"""TiO2/TiO2-x bilayer memristor device model (PyTorch).

The counterpart of ``repro.core.device``: the stack geometry the
executor needs (``DeviceConfig``), and the linear-ion-drift memristor
with a Biolek window, calibrated to the paper's Table-I corners
(R_on = R_s = 10 kOhm, R_off = R_r = 100 kOhm).  Used for

* the pinched-hysteresis-loop reproduction (paper Fig. 3a, 50 Hz drive),
* SET/RESET programming dynamics (t_write = 250 ns at V_write = 1.2 V),
* stochastic conductance sampling for Monte-Carlo fidelity studies.

The reference's ``lax.scan`` transients are Python loops here, over
fixed blocks of Euler steps, each step one set of elementwise ops on any
tensor of cells; on the card each block after the first replays one
CUDA graph (``_run_blocks``).  Random draws come from an explicit
``torch.Generator`` on the cells' device, through :func:`_normal`.
"""
from __future__ import annotations

import dataclasses
import math
import string
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.quant import true_div
from repro_torch.core.timing import PAPER, CrossStackParams
from repro_torch.graphs import GraphStep, resolve_capture


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Vertical geometry of one crossbar cell site.

    The paper's 10x10x2 array stacks exactly two TiO2/TiO2-x planes per
    cell; ``stack_planes`` generalizes that height.  The default of 2 is
    the classic ping-pong pair.
    """
    stack_planes: int = 2

    def __post_init__(self):
        if self.stack_planes < 2:
            raise ValueError(
                f"stack_planes must be >= 2 (a read plane plus at least "
                f"one write/twin plane); got {self.stack_planes}")

    @property
    def tenant_names(self) -> Tuple[str, ...]:
        """One addressable tenant name per plane slot: "A", "B", ..."""
        letters = string.ascii_uppercase
        return tuple(letters[i] if i < len(letters) else f"T{i}"
                     for i in range(self.stack_planes))


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard-normal float32 draws from ``generator``: every noisy path
    of the port (``sample_conductances``, ``crossbar.mac_noisy``,
    ``engine.matmul_analog``) draws through here, one call per draw of
    the reference's split keys, in the reference's order."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for a positive int ``y`` by repeated squaring, the
    products ``jax.lax.integer_pow`` lowers to."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _state(w0: torch.Tensor) -> torch.Tensor:
    """The cells' state tensor ``w0`` as float32 (no copy when it is
    already); the dynamics run on its device."""
    if not torch.is_tensor(w0):
        raise TypeError("w0 must be a tensor on the device the cells "
                        f"live on, not {type(w0).__name__}")
    return w0.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class MemristorModel:
    """Linear ion drift + Biolek window, bilayer TiO2/TiO2-x stack."""

    r_on: float = PAPER.r_set
    r_off: float = PAPER.r_reset
    # mobility constant chosen so a 1.2 V write pulse of 250 ns fully
    # switches the device: integral(k * i) dt = 1 over t_write at
    # i = v_write / r_avg
    k_drift: Optional[float] = None  # filled in __post_init__
    p_window: int = 2      # Biolek window exponent
    v_th_pos: float = 0.0  # drift threshold (TiO2 devices are threshold-free)
    v_th_neg: float = 0.0

    def __post_init__(self):
        if self.k_drift is None:
            r_avg = 0.5 * (self.r_on + self.r_off)
            k = r_avg / (PAPER.v_write * PAPER.t_write)
            object.__setattr__(self, "k_drift", k)

    # -- static I/V ---------------------------------------------------------
    def resistance(self, w: torch.Tensor) -> torch.Tensor:
        """Memristance at internal state w in [0, 1] (1 = fully SET)."""
        return self.r_on * w + self.r_off * (1.0 - w)

    def conductance(self, w: torch.Tensor) -> torch.Tensor:
        return torch.reciprocal(self.resistance(w))

    def current(self, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return v * self.conductance(w)

    # -- dynamics -----------------------------------------------------------
    def _window(self, w: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Biolek window f = 1 - (w - stp(-i))^(2p): suppresses drift only
        at the boundary being *approached* (w=1 for SET, w=0 for RESET)."""
        stp_neg_i = torch.where(i >= 0, 0.0, 1.0)
        x = w - stp_neg_i
        return 1.0 - _integer_pow(x, 2 * self.p_window)

    def dw_dt(self, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        i = self.current(v, w)
        # sign convention: positive v (SET polarity) grows w
        mag = torch.where(
            v >= 0,
            torch.where(v > self.v_th_pos, i, 0.0),
            torch.where(v < -self.v_th_neg, i, 0.0),
        )
        return self.k_drift * mag * self._window(w, i)

    def _euler(self, v: torch.Tensor, w: torch.Tensor, dt: float
               ) -> torch.Tensor:
        return torch.clamp(w + self.dw_dt(v, w) * dt, 0.0, 1.0)

    def transient(self, v_t: torch.Tensor, w0, dt: float,
                  capture: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Integrate the device response to a voltage waveform.

        Args:
          v_t: (T,) applied voltage samples.
          w0:  scalar or tensor initial state.
          dt:  timestep [s].
          capture: replay the blocks from a CUDA graph (``None``: on
            CUDA); see :func:`_run_blocks`.

        Returns:
          (i_t, w_t): current and state trajectories, each (T,) + w0.shape.
        """
        dev = v_t.device
        capture = resolve_capture(capture, dev)
        state = torch.as_tensor(w0, dtype=torch.float32, device=dev).clone()
        v_t = v_t.to(torch.float32)
        i_t = torch.empty((len(v_t),) + state.shape, dtype=torch.float32,
                          device=dev)
        w_t = torch.empty_like(i_t)
        v_blk = torch.empty((_BLOCK,), dtype=torch.float32, device=dev)
        i_blk = torch.empty((_BLOCK,) + state.shape, dtype=torch.float32,
                            device=dev)
        w_blk = torch.empty_like(i_blk)

        def steps(v_s, i_s, w_s):
            w = state
            for k in range(len(v_s)):
                v = v_s[k]
                i_s[k] = self.current(v, w)
                w = self._euler(v, w, dt)
                w_s[k] = w
            state.copy_(w)

        def load(sl):
            v_blk.copy_(v_t[sl])

        def store(sl):
            i_t[sl].copy_(i_blk)
            w_t[sl].copy_(w_blk)

        def tail(sl):
            steps(v_t[sl], i_t[sl], w_t[sl])

        _run_blocks(len(v_t), _BLOCK, lambda: steps(v_blk, i_blk, w_blk),
                    load, store, tail, capture)
        return i_t, w_t

    def program(self, w0, v_pulse, n_steps: int = 64,
                capture: Optional[bool] = None) -> torch.Tensor:
        """Apply one write pulse of duration t_write; returns the new state.

        v_pulse > 0 SETs (w -> 1), v_pulse < 0 RESETs (w -> 0).  The steps
        run in blocks (:func:`_run_blocks`; ``capture`` as there).
        """
        state = _state(w0).clone()
        capture = resolve_capture(capture, state.device)
        v = torch.as_tensor(v_pulse, dtype=torch.float32, device=state.device)
        dt = PAPER.t_write / n_steps

        def steps(n):
            w = state
            for _ in range(n):
                w = self._euler(v, w, dt)
            state.copy_(w)

        _run_blocks(n_steps, _BLOCK, lambda: steps(_BLOCK), None, None,
                    lambda sl: steps(sl.stop - sl.start), capture)
        return state

    def program_verify(self, w0, g_target, n_pulses: int = 16,
                       n_steps: int = 16, capture: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Iterative program-and-verify to hit a target conductance.

        Mirrors multi-level cell tuning: apply short write pulses whose
        polarity is chosen from the sign of the conductance error, reading
        (verifying) between pulses.  Returns the final state and the
        conductance after each pulse, (n_pulses,) + w0.shape.  The pulses
        run in blocks of ``max(1, _BLOCK // n_steps)`` (:func:`_run_blocks`;
        ``capture`` as there).
        """
        state = _state(w0).clone()
        dev = state.device
        capture = resolve_capture(capture, dev)
        g_target = torch.as_tensor(g_target, dtype=torch.float32,
                                   device=dev)
        dt = PAPER.t_write / (n_pulses * n_steps)
        v_set = torch.full((), PAPER.v_write, dtype=torch.float32,
                           device=dev)
        g_trace = torch.empty((n_pulses,) + state.shape, dtype=torch.float32,
                              device=dev)
        per_block = max(1, _BLOCK // n_steps)
        g_blk = torch.empty((per_block,) + state.shape, dtype=torch.float32,
                            device=dev)

        def pulses(g_s):
            w = state
            for p in range(len(g_s)):
                err = g_target - self.conductance(w)
                v = torch.where(err > 0, v_set, -v_set)
                del err
                for _ in range(n_steps):
                    w = self._euler(v, w, dt)
                g_s[p] = self.conductance(w)
            state.copy_(w)

        def store(sl):
            g_trace[sl].copy_(g_blk)

        _run_blocks(n_pulses, per_block, lambda: pulses(g_blk), None, store,
                    lambda sl: pulses(g_trace[sl]), capture)
        return state, g_trace


#: Euler steps in one block of ``transient`` and ``program``, and the
#: micro-steps whose pulses fill one block of ``program_verify`` (at least
#: one pulse a block)
_BLOCK = 32


def _run_blocks(n: int, size: int, block: Callable[[], None],
                load: Optional[Callable[[slice], None]],
                store: Optional[Callable[[slice], None]],
                tail: Callable[[slice], None], capture: bool) -> None:
    """The reference's ``lax.scan`` over ``n`` steps as ``n // size``
    calls of ``block``, a zero-argument step over static buffers, then
    ``tail`` over the last ``n % size`` steps, eagerly.  Before each
    block ``load`` copies its inputs in and after it ``store`` copies its
    outputs out (one device copy each), both given the block's slice of
    the ``n`` steps.  With ``capture`` the first block runs eagerly as
    the warm-up, the second is captured into one CUDA graph and every
    later one replays it (``graphs.GraphStep``); the graph and its memory
    pool are released before the call returns.  Captured or not, the
    blocks run the same ops in the same order, so the trajectory is the
    eager loop's bit for bit."""
    step = GraphStep(capture, body=block, scope=torch.no_grad)
    try:
        for start in range(0, n - n % size, size):
            sl = slice(start, start + size)
            if load is not None:
                load(sl)
            step.run()
            if store is not None:
                store(sl)
    finally:
        step.reset()
    if n % size:
        with torch.no_grad():
            tail(slice(n - n % size, n))


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num)`` in float32 as the reference
    computes it: its ``stop * (i / (num - 1))`` with the constants folded
    by XLA into ``i * (stop / (num - 1))``, and the exact endpoint."""
    stop_t = torch.full((1,), stop, dtype=torch.float32, device=device)
    delta = true_div(stop_t, float(num - 1))
    return torch.cat([torch.arange(num - 1, dtype=torch.float32,
                                   device=device) * delta, stop_t])


def hysteresis_loop(model: Optional[MemristorModel] = None,
                    freq_hz: float = 50.0, v_amp: float = 1.2,
                    n_cycles: int = 2, samples_per_cycle: int = 4096,
                    w0: float = 0.05, device=None,
                    capture: Optional[bool] = None):
    """Drive the device with a sinusoid and return (v, i, w) — the pinched
    hysteresis loop of paper Fig. 3a, on ``device`` (the card unless
    ``"cpu"`` is asked for).  At 50 Hz the loop must (a) pass through the
    origin and (b) enclose nonzero area.

    At 50 Hz the drive is quasi-static against the ~250 ns switching
    time, so the drift constant is scaled to the drive period (the loop
    SHAPE, not the absolute speed, is the fingerprint reproduced).
    ``capture`` as in :meth:`MemristorModel.transient`.
    """
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    model = model or MemristorModel()
    period = 1.0 / freq_hz
    t = _linspace(n_cycles * period, n_cycles * samples_per_cycle, dev)
    v = v_amp * torch.sin(2 * math.pi * freq_hz * t)
    dt = float(t[1] - t[0])
    # rescale drift so ~one full traversal happens per half cycle
    slow = MemristorModel(r_on=model.r_on, r_off=model.r_off,
                          k_drift=model.k_drift * (PAPER.t_write * freq_hz
                                                   * 4),
                          p_window=model.p_window)
    i, w = slow.transient(v, w0, dt, capture=capture)
    return v, i, w


def sample_conductances(generator: torch.Generator, w_bits: torch.Tensor,
                        p: CrossStackParams = PAPER) -> torch.Tensor:
    """Sample stochastic conductances for a tensor of binary weight bits.

    bit == 1 -> G_set = 1/(10 kOhm * (1 + N(0, 7%)))
    bit == 0 -> G_reset = 1/(100 kOhm * (1 + N(0, 10%)))

    The paper's Monte-Carlo methodology (Gaussian, 200 trials); the draws
    come from ``generator`` on ``w_bits``' device.
    """
    z_s = _normal(generator, w_bits.shape, w_bits.device)
    z_r = _normal(generator, w_bits.shape, w_bits.device)
    r_s = p.r_set * (1.0 + p.r_set_tol * z_s)
    r_r = p.r_reset * (1.0 + p.r_reset_tol * z_r)
    r = torch.where(w_bits > 0, r_s, r_r)
    return torch.reciprocal(r)


def transistor_leakage(v_ds: torch.Tensor, v_gs: torch.Tensor,
                       p: CrossStackParams = PAPER) -> torch.Tensor:
    """Subthreshold leakage of the OFF access transistor (N1 during a
    deep-net write), calibrated so the paper's worst-case bias (v_gs = 0,
    v_ds ~ V_write) leaks ~2.5 pA/cell (Fig. 3c).

    The reference's constants are float32 scalars (``jnp.exp`` of a
    Python float) combined with Python floats; each is rounded here
    where the reference rounds it.
    """
    vt_therm = 0.02585
    f32 = dict(dtype=torch.float32, device=v_ds.device)
    e_write = torch.exp(torch.full((), -p.v_write / vt_therm, **f32))
    i0 = true_div(torch.full((), p.i_leak_0, **f32),
                  10.0 ** ((0.0 - p.v_th) / p.subthreshold_swing)
                  * (1.0 - e_write))
    gate = torch.pow(10.0, true_div(v_gs - p.v_th, p.subthreshold_swing))
    return (i0 * gate
            * (1.0 - torch.exp(-true_div(torch.clamp(v_ds, min=0.0),
                                         vt_therm))))

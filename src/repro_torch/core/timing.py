"""Table-I device/circuit constants of the CrossStack prototype and the
per-mode latency/energy accounting used by the deep-net pipeline model.

All values are taken verbatim from Table I of the paper (SK Hynix 180 nm
process, Al/TiO2/TiO2-x/Al bilayer devices).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CrossStackParams:
    """Device + circuit corner set (paper Table I)."""

    r_set: float = 10e3            # R_s: static SET resistance [ohm]
    r_set_tol: float = 0.07        # +/- 7 % (Gaussian sigma used for MC)
    r_reset: float = 100e3         # R_r: static RESET resistance [ohm]
    r_reset_tol: float = 0.10      # +/- 10 %
    v_dd: float = 1.8              # supply [V]
    v_read: float = 0.5            # max read voltage [V]
    v_write: float = 1.2           # write voltage [V]
    t_read: float = 10e-9          # current read-out time [s]
    t_write: float = 250e-9        # programming time [s]
    n_devices: int = 200           # 10 x 10 x 2 prototype
    v_th: float = 0.4              # NMOS threshold [V]
    p_critical: float = 2.9e-3     # worst-case power [W]
    r_wire: float = 3.2            # wire resistance per cell [ohm]
    cell_pitch: float = 20e-6      # 20 um x 20 um cell
    w_over_l: float = 2.5          # 450 nm / 180 nm transistor sizing

    # Derived / calibrated analog front-end constants (see DESIGN.md §6).
    # N1/N2 ON resistance from the square-law triode model at
    # Vgs = Vdd, overdrive = 1.4 V, uCox ~ 300 uA/V^2 (180 nm nominal):
    # R_on = 1 / (uCox * W/L * (Vgs - Vth)) ~ 950 ohm.  This reproduces the
    # paper's measured 39.6 nA (1 % below the ideal 40 nA) single-cell read.
    u_cox: float = 300e-6          # [A/V^2]
    # Subthreshold leakage calibration: I0 such that the worst-case deep-net
    # leakage through OFF N1 is ~2.5 pA/cell at Vds ~ V_write (paper Fig 3c).
    i_leak_0: float = 2.5e-12      # [A] per cell at the worst-case bias
    subthreshold_swing: float = 0.090  # 90 mV/dec, typical 180 nm

    @property
    def g_set(self) -> float:
        return 1.0 / self.r_set

    @property
    def g_reset(self) -> float:
        return 1.0 / self.r_reset

    @property
    def r_on_transistor(self) -> float:
        """Triode ON resistance of the access transistor (N1 or N2)."""
        return 1.0 / (self.u_cox * self.w_over_l * (self.v_dd - self.v_th))


PAPER = CrossStackParams()


def read_time(n_input_bits: int, p: CrossStackParams = PAPER) -> float:
    """Total read time of a bit-serial b-bit MAC: one t_read pulse per bit."""
    return n_input_bits * p.t_read


def serial_layer_time(n_input_bits: int, p: CrossStackParams = PAPER) -> float:
    """Conventional 2-D crossbar: program, then read (steps 1-3 of §V)."""
    return p.t_write + read_time(n_input_bits, p)


def deepnet_layer_time(n_input_bits: int, p: CrossStackParams = PAPER) -> float:
    """Deep-net mode steady-state: read of layer l overlaps the write of
    layer l+1, so each pipeline stage costs max(t_write, b * t_read)."""
    return max(p.t_write, read_time(n_input_bits, p))


def deepnet_speedup(n_input_bits: int, n_layers: int = 10 ** 6,
                    p: CrossStackParams = PAPER) -> float:
    """Fractional speed improvement of deep-net mode over the serial schedule.

    Serial:   T = L * (t_write + b*t_read)
    Deep-net: T = t_write + L * max(t_write, b*t_read)   (fill + steady state)

    For b = 10 bits, t_read = 10 ns, t_write = 250 ns and large L this is
    1 - 250/350 = 28.6 % ~ "29 %" (paper §IV-B / §V).
    """
    t_serial = n_layers * serial_layer_time(n_input_bits, p)
    t_deep = p.t_write + n_layers * deepnet_layer_time(n_input_bits, p)
    return 1.0 - t_deep / t_serial


def mac_energy(n_rows: int, n_cols: int, duty: float = 1.0,
               p: CrossStackParams = PAPER) -> float:
    """Upper-bound read energy of one analog MAC over an n_rows x n_cols tile.

    Worst case: every device at G_set with the full read voltage across it.
    """
    i_cell = p.v_read * p.g_set
    power = i_cell * p.v_read * n_rows * n_cols * duty
    return power * p.t_read

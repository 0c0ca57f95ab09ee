"""Analytic energy/delay models — Eq. (2)-(4) of the paper. The port's
copy of ``repro/core/cost_model.py`` (host numpy, unchanged).

E_c  = sum_i kappa * alpha_i * f^2          (device compute energy)
tau_c^MD = sum_i alpha_i / (f * eta_d)      (device compute delay)
tau_c^S  = sum_{i>l} alpha_i / (f' * eta_s) (server compute delay)
tau_t = D(l) / R(P, h)                      (uplink delay)
E_t  = P * tau_t                            (transmit energy)

alpha_i are per-layer MAC counts from the profiles; kappa = 1e-29 and
f = 1.8 GHz follow §6.1. eta_d/eta_s are the processor-efficiency factors
(Eq. 4) calibrated in DESIGN.md §6: device 2.0 (Pi-4 4xA72 effective),
server 9.0 (M4 10 cores) -> 3.6 / 40.5 GMAC/s effective throughput.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.wireless.channel import LinkParams, achievable_rate


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    kappa: float = 1e-29        # J / (MAC * Hz^2), paper §6.1
    f_hz: float = 1.8e9         # Pi 4 CPU clock
    eta: float = 2.0            # processor efficiency factor (Eq. 4)


@dataclasses.dataclass(frozen=True)
class ServerParams:
    f_hz: float = 4.5e9         # Mac M4 clock
    eta: float = 9.0


@dataclasses.dataclass(frozen=True)
class Budgets:
    e_max_j: float = 5.0        # §6.1: 5 J
    tau_max_s: float = 5.0      # §6.1: 5 s


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Arch-agnostic per-layer profile the cost model consumes."""
    name: str
    cum_macs: np.ndarray        # (L+1,), cum_macs[l] = device MACs at split l
    total_macs: float           # device+server total (incl. server-only tail)
    tx_bytes: np.ndarray        # (L+1,), activation bytes at split l
    n_layers: int               # valid splits are 1..n_layers


def profile_from_cnn(cnn) -> LayerProfile:
    cum = np.asarray(cnn.cumulative_macs())
    n = cnn.n_split_layers
    tx = np.asarray([cnn.activation_bytes(l) for l in range(n + 1)])
    return LayerProfile(cnn.name, cum[:n + 1], float(cum[-1]), tx, n)


def pad_profile(profile: LayerProfile, l_max: int):
    """Edge-pad a profile's per-layer arrays to a batch-wide ``l_max``.

    Returns ``(padded profile, valid mask)``. The padded profile keeps the
    TRUE ``n_layers`` (valid splits stay 1..L) but its ``(l_max+1,)``
    arrays repeat the final-layer entry in the tail, so mixed-architecture
    scenario batches stack into dense device arrays and an index that was
    clipped to ``n_layers`` reads the same value as the unpadded profile.
    ``valid[l]`` marks the real (non-padded) entries ``l <= n_layers``.
    """
    L = profile.n_layers
    if l_max < L:
        raise ValueError(f"l_max={l_max} < profile n_layers={L}")
    pad = l_max - L
    valid = np.arange(l_max + 1) <= L
    if pad == 0:
        return profile, valid
    return LayerProfile(
        profile.name,
        np.pad(profile.cum_macs, (0, pad), mode="edge"),
        profile.total_macs,
        np.pad(profile.tx_bytes, (0, pad), mode="edge"),
        L), valid


class CostModel:
    """Deterministic energy/delay for (split l, power P) given a channel."""

    def __init__(self, profile: LayerProfile,
                 device: DeviceParams = DeviceParams(),
                 server: ServerParams = ServerParams(),
                 link: LinkParams = LinkParams(),
                 budgets: Budgets = Budgets()):
        self.profile = profile
        self.device = device
        self.server = server
        self.link = link
        self.budgets = budgets

    # --- Eq. (3)-(4) ------------------------------------------------------
    def device_energy_j(self, l):
        a = self.profile.cum_macs[np.asarray(l)]
        return self.device.kappa * a * self.device.f_hz ** 2

    def device_delay_s(self, l):
        a = self.profile.cum_macs[np.asarray(l)]
        return a / (self.device.f_hz * self.device.eta)

    def server_delay_s(self, l):
        a = self.profile.total_macs - self.profile.cum_macs[np.asarray(l)]
        return a / (self.server.f_hz * self.server.eta)

    # --- Eq. (1)-(2) ------------------------------------------------------
    def tx_bits(self, l):
        return 8.0 * self.profile.tx_bytes[np.asarray(l)]

    def tx_delay_s(self, l, p_w, gain_db):
        r = achievable_rate(p_w, gain_db, self.link)
        return np.where(r > 0, self.tx_bits(l) / np.maximum(r, 1e-30), np.inf)

    # --- totals -----------------------------------------------------------
    def tx_energy_j(self, l, p_w, gain_db):
        tau = self.tx_delay_s(l, p_w, gain_db)
        p = np.asarray(p_w, dtype=np.float64)
        return np.where(np.isfinite(tau), p * np.where(np.isfinite(tau), tau, 0.0),
                        np.inf)

    def energy_j(self, l, p_w, gain_db):
        return self.device_energy_j(l) + self.tx_energy_j(l, p_w, gain_db)

    def delay_s(self, l, p_w, gain_db):
        return (self.device_delay_s(l) + self.tx_delay_s(l, p_w, gain_db)
                + self.server_delay_s(l))

    def feasible(self, l, p_w, gain_db):
        return ((self.energy_j(l, p_w, gain_db) <= self.budgets.e_max_j)
                & (self.delay_s(l, p_w, gain_db) <= self.budgets.tau_max_s))

    def completion_fraction(self, l, p_w, gain_db):
        """Fraction of the pipeline finished by the deadline (deadline-based
        truncation, §6.1). 1.0 == completes."""
        tau = self.delay_s(l, p_w, gain_db)
        return np.minimum(1.0, self.budgets.tau_max_s / np.maximum(tau, 1e-9))

    def calibrate_gain_db(self, l_star: int, p_star: float) -> float:
        """Channel gain making p_star exactly the min feasible power at
        l_star (delay boundary) — anchors the Table-1 operating point."""
        slack = (self.budgets.tau_max_s - self.device_delay_s(l_star)
                 - self.server_delay_s(l_star))
        if slack <= 0:
            raise ValueError(
                f"split l={l_star} cannot meet tau_max="
                f"{self.budgets.tau_max_s}s even with instant transmission "
                f"(compute alone takes {self.budgets.tau_max_s - slack:.2f}s)")
        rate_needed = self.tx_bits(l_star) / slack
        x = 2.0 ** (rate_needed / self.link.bandwidth_hz) - 1.0
        gain_lin = x * self.link.noise_power_w / p_star
        return float(10.0 * np.log10(gain_lin))

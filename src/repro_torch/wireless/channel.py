"""Wireless uplink model — Eq. (1)-(2) of the paper. The port's copy of
``repro/wireless/channel.py`` (numpy, unchanged).

R = B log2(1 + P |h|^2 / (N0 B)),  tau_t = D(l) / R.

Constants follow §6.1: B = 240000*256*0.8 Hz (OFDM subcarrier allocation),
N0 = -147 dBm/Hz.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# paper constants (§6.1)
BANDWIDTH_HZ = 240_000.0 * 256.0 * 0.8          # 49.152 MHz
N0_DBM_PER_HZ = -147.0


def db_to_lin(db):
    return 10.0 ** (np.asarray(db) / 10.0)


def lin_to_db(lin):
    return 10.0 * np.log10(np.asarray(lin))


@dataclasses.dataclass(frozen=True)
class LinkParams:
    bandwidth_hz: float = BANDWIDTH_HZ
    n0_dbm_per_hz: float = N0_DBM_PER_HZ

    @property
    def noise_power_w(self) -> float:
        # dBm/Hz -> W/Hz -> * B
        return 10.0 ** ((self.n0_dbm_per_hz - 30.0) / 10.0) * self.bandwidth_hz


def achievable_rate(p_tx_w, gain_db, link: LinkParams = LinkParams()):
    """Shannon rate in bit/s. Vectorized over p_tx_w and/or gain_db."""
    snr = np.asarray(p_tx_w) * db_to_lin(gain_db) / link.noise_power_w
    return link.bandwidth_hz * np.log2(1.0 + snr)


def tx_delay_s(bits, p_tx_w, gain_db, link: LinkParams = LinkParams()):
    r = achievable_rate(p_tx_w, gain_db, link)
    return np.where(r > 0, np.asarray(bits) / np.maximum(r, 1e-30), np.inf)


def required_power_w(bits, deadline_s, gain_db,
                     link: LinkParams = LinkParams()):
    """Inverse of tx_delay: min power to move `bits` within `deadline_s`."""
    rate_needed = np.asarray(bits) / np.asarray(deadline_s)
    x = 2.0 ** (rate_needed / link.bandwidth_hz) - 1.0
    return x * link.noise_power_w / db_to_lin(gain_db)

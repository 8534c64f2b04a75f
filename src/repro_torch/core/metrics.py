"""Measurement units of the paper (§III.B, eqs. 1-4).

Every application `A` published to the tracker carries three units so
volunteers can judge it before leeching:

  d_A = sum_v d_app + sum_i d_data          (eq. 1)  — bytes moved
  p_A = sum_i frequency(A_i)                 (eq. 2)  — popularity (cycles run)
  w_A = sum_i time(A_i) / p_A                (eq. 3)  — avg working time
  under m_min-way validation all scale by m_min (eq. 4)

High d + low w  -> low complexity; high p and w + low d -> high complexity
(§III.B).  The same units drive the framework's scheduler cost model
(heterogeneity-aware placement) — see cluster/coordinator.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class AppMetrics:
    """Accumulates (d, p, w) for one application."""
    d_app_bytes: int = 0                 # size of the application file
    d_data_bytes: float = 0.0            # sum of data part sizes transferred
    app_downloads: int = 0               # REQ re-downloads the app each cycle
    cycles: int = 0                      # p numerator (frequency)
    total_time_s: float = 0.0            # sum of per-cycle working time
    m_min: int = 1                       # validation replication (eq. 4)

    # -- updates ----------------------------------------------------------
    def record_cycle(self, data_bytes: float, time_s: float,
                     app_downloaded: bool = True) -> None:
        self.cycles += 1
        self.d_data_bytes += data_bytes
        if app_downloaded:
            self.app_downloads += 1
        self.total_time_s += time_s

    # -- units ------------------------------------------------------------
    @property
    def d(self) -> float:
        """eq. (1) scaled by m_min per eq. (4)."""
        return self.m_min * (self.d_app_bytes * self.app_downloads
                             + self.d_data_bytes)

    @property
    def p(self) -> float:
        """eq. (2) scaled by m_min per eq. (4)."""
        return self.m_min * self.cycles

    @property
    def w(self) -> float:
        """eq. (3); note eq. (4) scales the numerator sum, and p carries its
        own m_min, so w is m_min-invariant in the paper's formulation."""
        if self.cycles == 0:
            return 0.0
        return self.m_min * self.total_time_s / self.p

    def as_dict(self) -> Dict[str, float]:
        return {"d": self.d, "p": self.p, "w": self.w}


def complexity_hint(d: float, p: float, w: float,
                    d_scale: float = 1 << 20, w_scale: float = 10.0) -> str:
    """The paper's §III.B heuristic, as a volunteer-facing hint."""
    high_d = d > d_scale
    high_w = w > w_scale
    high_p = p > 100
    if high_d and not high_w:
        return "low"
    if high_p and high_w and not high_d:
        return "high"
    return "medium"

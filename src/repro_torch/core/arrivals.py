"""Open-loop arrival processes for serve request streams.

A copy of ``ARRIVAL_REGIMES`` and ``arrival_times`` from
``repro.core.simulator`` (numpy only), so the port imports nothing of
``repro``.  The draws are the same, so a seed gives the same arrival times
in both packages.
"""
from __future__ import annotations

import numpy as np

ARRIVAL_REGIMES = ("poisson", "diurnal", "burst")


def arrival_times(n: int, rate: float, seed: int,
                  regime: str = "poisson", diurnal_amp: float = 0.8,
                  diurnal_period: float = 0.0, burst_factor: float = 4.0,
                  burst_duty: float = 0.15) -> np.ndarray:
    """``n`` open-loop arrival timestamps at mean offered load ``rate``.

    Regimes (all deterministic given ``seed``, mean rate ≈ ``rate``):

    * ``poisson`` — homogeneous: exponential inter-arrival gaps.
    * ``diurnal`` — non-homogeneous Poisson, intensity
      ``rate * (1 + amp*sin(2*pi*t/period))`` (day/night swing), sampled
      by Lewis-Shedler thinning.  ``diurnal_period`` defaults to the
      span ``n`` arrivals cover at ``rate``, i.e. one full "day" per
      trace.
    * ``burst`` — baseline load with periodic burst episodes:
      ``burst_factor`` x rate for ``burst_duty`` of each cycle, rebalanced
      below baseline otherwise so the mean stays ``rate`` (flash-crowd
      traffic).
    """
    rng = np.random.default_rng([seed, 1])
    if regime == "poisson":
        t, out = 0.0, []
        for _ in range(n):
            t += float(rng.exponential(1.0 / rate))
            out.append(t)
        return np.asarray(out)
    if regime == "diurnal":
        period = diurnal_period or n / max(rate, 1e-9)
        lam_max = rate * (1.0 + diurnal_amp)

        def lam(t):
            return rate * (1.0 + diurnal_amp
                           * np.sin(2.0 * np.pi * t / period))
    elif regime == "burst":
        period = n / max(rate, 1e-9) / 8.0     # several bursts per trace
        low = max(0.05, (1.0 - burst_factor * burst_duty)
                  / max(1e-9, 1.0 - burst_duty))
        lam_max = rate * burst_factor

        def lam(t):
            frac = (t / period) % 1.0
            return rate * (burst_factor if frac < burst_duty else low)
    else:
        raise ValueError(f"unknown arrival regime {regime!r}")
    # thinning: candidate gaps at lam_max, accept with lam(t)/lam_max
    t, out = 0.0, []
    while len(out) < n:
        t += float(rng.exponential(1.0 / lam_max))
        if rng.uniform() * lam_max <= lam(t):
            out.append(t)
    return np.asarray(out)

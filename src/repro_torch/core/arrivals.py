"""Open-loop arrival processes for serve request streams.

``ARRIVAL_REGIMES`` and ``arrival_times`` live in ``core.simulator`` (the
port's copy of ``repro.core.simulator``); this module re-exports them for
the serving path, so one copy of the draws exists.  A seed gives the same
arrival times in both packages.
"""
from __future__ import annotations

from repro_torch.core.simulator import ARRIVAL_REGIMES, arrival_times

__all__ = ["ARRIVAL_REGIMES", "arrival_times"]

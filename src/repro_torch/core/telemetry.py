"""Process-local telemetry recorder: spans, counters, gauges, histograms
(the part of ``repro.core.telemetry`` that the serving path uses, copied so
the port imports nothing of ``repro``).

The module-level default recorder is a no-op whose every method returns
immediately, so instrumented call sites cost nothing until a caller
installs a live recorder with :func:`enable`.  Exports:
:meth:`Telemetry.to_chrome_trace` / :meth:`write_chrome_trace` (Chrome
trace-event JSON, Perfetto-loadable) and :meth:`Telemetry.summary` /
:meth:`write_summary`.
"""
from __future__ import annotations

import bisect
import json
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Telemetry", "get", "enable", "disable"]

# Fixed histogram bucket bounds: 1 µs .. 100 s, four per decade.  Fixed
# (not adaptive) so summaries from different runs merge/compare cleanly.
HIST_BOUNDS: Tuple[float, ...] = tuple(
    round(1e-6 * 10 ** (i / 4.0), 12) for i in range(33))

# Cap per-gauge time series so a long serve run cannot grow unbounded;
# the last value is always kept exactly.
_GAUGE_SERIES_CAP = 4096


class _Histogram:
    __slots__ = ("counts", "n", "total", "min", "max")

    def __init__(self) -> None:
        self.counts = [0] * (len(HIST_BOUNDS) + 1)
        self.n = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_right(HIST_BOUNDS, value)] += 1
        self.n += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def percentile(self, q: float) -> float:
        """Upper bucket bound holding the q-th percentile (0..100)."""
        if self.n == 0:
            return 0.0
        rank = max(1, int(round(q / 100.0 * self.n)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return HIST_BOUNDS[i] if i < len(HIST_BOUNDS) else self.max
        return self.max

    def to_dict(self) -> Dict[str, Any]:
        return {
            "count": self.n,
            "sum": self.total,
            "min": self.min if self.n else 0.0,
            "max": self.max if self.n else 0.0,
            "mean": (self.total / self.n) if self.n else 0.0,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "buckets": {
                ("%.3g" % HIST_BOUNDS[i]) if i < len(HIST_BOUNDS)
                else "+inf": c
                for i, c in enumerate(self.counts) if c
            },
        }


class Telemetry:
    """Live recorder: spans + counters + gauges + histograms."""

    enabled = True

    def __init__(self) -> None:
        self.spans: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.gauge_series: Dict[str, List[Tuple[float, float]]] = {}
        self.histograms: Dict[str, _Histogram] = {}
        self.instants: List[Dict[str, Any]] = []
        self._t_origin = time.perf_counter()

    # ---- recording ----------------------------------------------------------
    def span_at(self, name: str, t0: float, t1: float, track: str = "main",
                clock: str = "wall", **attrs) -> None:
        """Record a span with explicit start/end (either clock)."""
        self.spans.append({"name": name, "t0": t0, "t1": t1,
                           "track": track, "clock": clock, "attrs": attrs})

    def instant(self, name: str, t: Optional[float] = None,
                track: str = "main", clock: str = "wall", **attrs) -> None:
        if t is None:
            t = time.perf_counter()
        self.instants.append({"name": name, "t": t, "track": track,
                              "clock": clock, "attrs": attrs})

    def count(self, name: str, inc: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value: float,
              t: Optional[float] = None) -> None:
        self.gauges[name] = value
        series = self.gauge_series.setdefault(name, [])
        if len(series) < _GAUGE_SERIES_CAP:
            series.append((time.perf_counter() - self._t_origin
                           if t is None else t, float(value)))

    def observe(self, name: str, value: float) -> None:
        hist = self.histograms.get(name)
        if hist is None:
            hist = self.histograms[name] = _Histogram()
        hist.observe(value)

    # ---- export -------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        tracks = {}
        for s in self.spans:
            tracks[s["track"]] = tracks.get(s["track"], 0) + 1
        span_s: Dict[str, float] = {}
        span_n: Dict[str, int] = {}
        for s in self.spans:
            span_s[s["name"]] = span_s.get(s["name"], 0.0) \
                + (s["t1"] - s["t0"])
            span_n[s["name"]] = span_n.get(s["name"], 0) + 1
        return {
            "spans_total": len(self.spans),
            "instants_total": len(self.instants),
            "span_counts": dict(sorted(span_n.items())),
            "span_seconds": {k: round(v, 9)
                             for k, v in sorted(span_s.items())},
            "tracks": dict(sorted(tracks.items())),
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self.histograms.items())},
        }

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON dict (load in Perfetto / about:tracing).

        Virtual-clock events land in pid 1 ("virtual: gangs") and pid 2
        ("virtual: hosts"); wall-clock events in pid 10 ("wall").  One
        tid per track (gang / host / subsystem); gauges and counter
        totals as 'C' counter tracks.
        """
        events: List[Dict[str, Any]] = []
        tids: Dict[Tuple[int, str], int] = {}
        pids_named = set()

        def pid_for(track: str, clock: str) -> int:
            if clock == "virtual":
                return 2 if track.startswith("host") else 1
            return 10

        def tid_for(pid: int, track: str) -> int:
            key = (pid, track)
            if key not in tids:
                tids[key] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tids[key],
                               "args": {"name": track}})
            return tids[key]

        def ensure_pid(pid: int) -> None:
            if pid in pids_named:
                return
            pids_named.add(pid)
            label = {1: "virtual: gangs", 2: "virtual: hosts",
                     10: "wall"}.get(pid, str(pid))
            events.append({"ph": "M", "name": "process_name",
                           "pid": pid, "args": {"name": label}})

        def cat_of(name: str) -> str:
            return name.split(".", 1)[0].split("/", 1)[0]

        for s in self.spans:
            pid = pid_for(s["track"], s["clock"])
            ensure_pid(pid)
            t0 = s["t0"] if s["clock"] == "virtual" \
                else s["t0"] - self._t_origin
            events.append({
                "ph": "X", "name": s["name"], "cat": cat_of(s["name"]),
                "pid": pid, "tid": tid_for(pid, s["track"]),
                "ts": round(t0 * 1e6, 3),
                "dur": max(0.0, round((s["t1"] - s["t0"]) * 1e6, 3)),
                "args": _plain(s["attrs"]),
            })
        for ev in self.instants:
            pid = pid_for(ev["track"], ev["clock"])
            ensure_pid(pid)
            t = ev["t"] if ev["clock"] == "virtual" \
                else ev["t"] - self._t_origin
            events.append({
                "ph": "i", "s": "t", "name": ev["name"],
                "cat": cat_of(ev["name"]),
                "pid": pid, "tid": tid_for(pid, ev["track"]),
                "ts": round(t * 1e6, 3),
                "args": _plain(ev["attrs"]),
            })
        ensure_pid(10)
        ctr_tid = 0   # counter events render per-name, tid unused
        for name, series in sorted(self.gauge_series.items()):
            for t, v in series:
                events.append({"ph": "C", "name": name,
                               "cat": cat_of(name), "pid": 10,
                               "tid": ctr_tid, "ts": round(t * 1e6, 3),
                               "args": {name: v}})
        # monotonic counters: one final-total sample each, so the layer
        # is visible on the timeline even when its only signal is counts
        t_end = round((time.perf_counter() - self._t_origin) * 1e6, 3)
        for name, v in sorted(self.counters.items()):
            events.append({"ph": "C", "name": name,
                           "cat": cat_of(name), "pid": 10,
                           "tid": ctr_tid, "ts": t_end,
                           "args": {name: v}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def write_summary(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(_plain(self.summary()), f, indent=1, sort_keys=True)


class _NoopTelemetry(Telemetry):
    """Default recorder: every method returns immediately, records nothing.

    Instrumented call sites check ``tel.enabled`` before computing attrs,
    and even un-gated calls are a no-op.
    """

    enabled = False

    def __init__(self) -> None:
        super().__init__()

    def span_at(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def count(self, *a, **k) -> None:
        pass

    def gauge(self, *a, **k) -> None:
        pass

    def observe(self, *a, **k) -> None:
        pass


_NOOP = _NoopTelemetry()
_current: Telemetry = _NOOP


def get() -> Telemetry:
    """The active recorder (the module-level no-op unless enabled)."""
    return _current


def enable(recorder: Optional[Telemetry] = None) -> Telemetry:
    """Install (and return) a live recorder as the process default."""
    global _current
    _current = recorder if recorder is not None else Telemetry()
    return _current


def disable() -> None:
    """Restore the zero-cost no-op default."""
    global _current
    _current = _NOOP


def _plain(value: Any) -> Any:
    """Coerce numpy scalars/arrays and tuples to JSON-plain Python."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    item = getattr(value, "item", None)
    if item is not None and getattr(value, "shape", None) == ():
        return item()
    tolist = getattr(value, "tolist", None)
    if tolist is not None:
        return _plain(tolist())
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)

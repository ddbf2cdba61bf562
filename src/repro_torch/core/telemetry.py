"""Process-local telemetry plane: spans, counters, gauges, histograms.

The reproduction's evaluation (like Faabric's §6) hinges on fine-grained
visibility — per-decision scheduling latency, migration cost, checkpoint
bytes, serve-queue depth — but recording must never perturb the thing it
measures.  The contract mirrors the CostModel's opt-in features
(``risk_tau_s=None``): the module-level default recorder is a **no-op**
whose every method returns immediately, so instrumented call sites are
zero-cost and all pinned traces stay bit-identical until a caller
explicitly installs a live recorder with :func:`enable` / :func:`recording`.

Two clocks share one span schema:

* ``clock="wall"`` — real elapsed time (``time.perf_counter``), used by
  live code paths (GangHandle lifecycle, placement decisions, probes).
* ``clock="virtual"`` — simulator time, attached after a run by
  :meth:`Telemetry.record_actions`, so simulated and live timelines
  render identically in the same viewer.

Exports:

* :meth:`Telemetry.to_chrome_trace` / :meth:`write_chrome_trace` — Chrome
  trace-event JSON (Perfetto-loadable): one track per gang, one per host,
  instant events for Actions, counter tracks for gauges.
* :meth:`Telemetry.summary` — metrics-summary dict folded into the
  ``results/`` benchmark schema.
* :func:`diff_traces` — align a predicted and a live Action stream,
  report the first divergence with surrounding context, and compute
  per-phase predicted-vs-measured time error (the ROADMAP item-2
  fidelity metric).

Calibration: :meth:`Telemetry.step_time` aggregates measured step times
per (host-kind, job-kind); :meth:`feed_cost_model` pushes them into
``CostModel.observe_step`` so the self-calibration loop has a data source.

The module imports nothing from the rest of ``repro`` (Action objects are
duck-typed via ``.kind`` / ``.payload``), so any layer may import it.
"""
from __future__ import annotations

import bisect
import difflib
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Telemetry", "get", "enable", "disable", "recording",
    "diff_traces", "spans_from_actions",
]

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


class _SpanCtx:
    """Context manager recording one wall-clock span on exit."""

    __slots__ = ("_tel", "name", "track", "attrs", "t0")

    def __init__(self, tel: "Telemetry", name: str, track: str,
                 attrs: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.track = track
        self.attrs = attrs
        self.t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tel.span_at(self.name, self.t0, time.perf_counter(),
                          track=self.track, clock="wall", **self.attrs)


class _NullCtx:
    __slots__ = ("attrs",)

    def __init__(self) -> None:
        self.attrs: Dict[str, Any] = {}

    def __enter__(self) -> "_NullCtx":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_CTX = _NullCtx()


class Telemetry:
    """Live recorder: spans + counters + gauges + histograms."""

    enabled = True

    def __init__(self) -> None:
        self.spans: List[Dict[str, Any]] = []
        self.instants: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.gauge_series: Dict[str, List[Tuple[float, float]]] = {}
        self.histograms: Dict[str, _Histogram] = {}
        # (host_kind, job_kind) -> [count, total_s]
        self.step_times: Dict[Tuple[str, str], List[float]] = {}
        self._t_origin = time.perf_counter()

    # ---- recording ----------------------------------------------------------
    def span(self, name: str, track: str = "main", **attrs):
        """Wall-clock span context manager: ``with tel.span("x"): ...``."""
        return _SpanCtx(self, name, track, attrs)

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

    def step_time(self, host_kind: str, job_kind: str,
                  seconds: float) -> None:
        """Measured per-step wall time for one (host-kind, job-kind)."""
        agg = self.step_times.setdefault((host_kind, job_kind), [0, 0.0])
        agg[0] += 1
        agg[1] += seconds
        self.observe(f"step_time_s/{host_kind}/{job_kind}", seconds)

    def record_actions(self, actions: Sequence[Any],
                       clock: str = "virtual") -> None:
        """Attach a simulator/live Action log as virtual-clock spans."""
        spans, instants = spans_from_actions(actions, clock=clock)
        self.spans.extend(spans)
        self.instants.extend(instants)

    # ---- calibration --------------------------------------------------------
    def step_time_aggregates(self) -> Dict[Tuple[str, str],
                                           Tuple[int, float]]:
        """(host_kind, job_kind) -> (count, mean seconds)."""
        return {k: (int(v[0]), v[1] / v[0])
                for k, v in self.step_times.items() if v[0]}

    def feed_cost_model(self, model: Any) -> int:
        """Push step-time aggregates into ``CostModel.observe_step``.

        Returns the number of (host-kind, job-kind) pairs fed."""
        observe = getattr(model, "observe_step", None)
        if observe is None:
            return 0
        fed = 0
        for (hk, jk), (n, mean_s) in self.step_time_aggregates().items():
            observe(hk, jk, mean_s, count=n)
            fed += 1
        return fed

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
            "step_time_aggregates": {
                f"{hk}/{jk}": {"count": n, "mean_s": mean}
                for (hk, jk), (n, mean)
                in sorted(self.step_time_aggregates().items())},
        }

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON dict (load in Perfetto / about:tracing).

        Virtual-clock events land in pid 1 ("virtual: gangs") and pid 2
        ("virtual: hosts"); wall-clock events in pid 10 ("wall").  One
        tid per track (gang / host / subsystem); Action instants render
        as 'i' events; gauges as 'C' counter tracks.
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
    and even un-gated calls are a no-op — pinned traces stay bit-identical
    (the ``risk_tau_s=None`` contract).
    """

    enabled = False

    def __init__(self) -> None:
        super().__init__()

    def span(self, name, track="main", **attrs):
        return _NULL_CTX

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

    def step_time(self, *a, **k) -> None:
        pass

    def record_actions(self, *a, **k) -> None:
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


class recording:
    """``with telemetry.recording() as tel: ...`` — scoped enable."""

    def __init__(self, recorder: Optional[Telemetry] = None):
        self.recorder = recorder if recorder is not None else Telemetry()

    def __enter__(self) -> Telemetry:
        self._prev = _current
        enable(self.recorder)
        return self.recorder

    def __exit__(self, *exc) -> None:
        global _current
        _current = self._prev


# ---- Action-stream utilities ------------------------------------------------

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


def _action_dict(action: Any) -> Dict[str, Any]:
    to_dict = getattr(action, "to_dict", None)
    if to_dict is not None:
        return to_dict()
    if isinstance(action, dict):
        return {"kind": action.get("kind"),
                "payload": _plain(action.get("payload", {}))}
    return {"kind": getattr(action, "kind", "?"),
            "payload": _plain(getattr(action, "payload", {}))}


# Action kinds that close a job's run segment; everything else with a
# job id is an instant on that gang's track.
_SEG_OPEN = ("start", "resume", "recover", "regrow")
_SEG_CLOSE = ("preempt", "finish", "host-fail", "shrink", "evacuate")
_HOST_KINDS = ("join", "drain", "retire")


def spans_from_actions(actions: Sequence[Any], clock: str = "virtual"
                       ) -> Tuple[List[Dict[str, Any]],
                                  List[Dict[str, Any]]]:
    """Convert an Action log into (spans, instants) in the span schema.

    A gang's run segments open on start/resume/recover/regrow and close
    on preempt/finish/shrink/evacuate/host-fail; every Action also emits
    an instant on its gang track (or host track for fleet events) so the
    full decision stream is visible on the timeline.
    """
    spans: List[Dict[str, Any]] = []
    instants: List[Dict[str, Any]] = []
    open_seg: Dict[Any, Tuple[float, Dict[str, Any]]] = {}
    t_max = 0.0
    for a in actions:
        kind = getattr(a, "kind", None) or (a.get("kind")
                                            if isinstance(a, dict) else "?")
        payload = getattr(a, "payload", None)
        if payload is None and isinstance(a, dict):
            payload = a.get("payload", {})
        payload = payload or {}
        t = float(payload.get("t", t_max))
        t_max = max(t_max, t)
        job = payload.get("job")
        if kind in _HOST_KINDS or job is None:
            hosts = payload.get("hosts", payload.get("host"))
            if not isinstance(hosts, (list, tuple)):
                hosts = [hosts] if hosts is not None else ["fleet"]
            for h in hosts:
                instants.append({"name": f"fleet.{kind}", "t": t,
                                 "track": f"host:{h}", "clock": clock,
                                 "attrs": _plain(payload)})
            continue
        track = f"gang:{job}"
        instants.append({"name": f"action.{kind}", "t": t, "track": track,
                         "clock": clock, "attrs": _plain(payload)})
        if kind in _SEG_OPEN:
            if job not in open_seg:
                open_seg[job] = (t, {"opened_by": kind})
        elif kind in _SEG_CLOSE and job in open_seg:
            t0, attrs = open_seg.pop(job)
            attrs["closed_by"] = kind
            spans.append({"name": "run", "t0": t0, "t1": t,
                          "track": track, "clock": clock, "attrs": attrs})
    for job, (t0, attrs) in open_seg.items():
        attrs["closed_by"] = "end-of-trace"
        spans.append({"name": "run", "t0": t0, "t1": t_max,
                      "track": f"gang:{job}", "clock": clock,
                      "attrs": attrs})
    return spans, instants


def _sig(action: Any) -> Tuple[Any, Any]:
    kind = getattr(action, "kind", None) or (action.get("kind")
                                             if isinstance(action, dict)
                                             else "?")
    payload = getattr(action, "payload", None)
    if payload is None and isinstance(action, dict):
        payload = action.get("payload", {})
    return (kind, (payload or {}).get("job"))


def diff_traces(predicted: Any, live: Any,
                context: int = 3) -> Dict[str, Any]:
    """Align two Action streams; report divergence + per-phase time error.

    ``predicted``/``live`` are Action sequences (or objects with an
    ``.actions`` attribute, e.g. ``TraceResult``).  Streams are aligned
    by ``(kind, job)`` signature with ``difflib.SequenceMatcher``; the
    **first divergence** is the earliest position where the aligned
    signatures differ (an insertion, deletion, or replacement), reported
    with ``context`` surrounding actions from both streams.  For aligned
    pairs, per-phase (= per Action kind) time error compares the two
    streams' ``payload["t"]`` stamps: mean/max absolute delta and the
    relative phase-span error.
    """
    pred = list(getattr(predicted, "actions", predicted))
    liv = list(getattr(live, "actions", live))
    psig = [_sig(a) for a in pred]
    lsig = [_sig(a) for a in liv]
    sm = difflib.SequenceMatcher(a=psig, b=lsig, autojunk=False)
    divergences = 0
    first: Optional[Dict[str, Any]] = None
    matched: List[Tuple[Any, Any]] = []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            matched.extend(zip(pred[i1:i2], liv[j1:j2]))
            continue
        divergences += max(i2 - i1, j2 - j1)
        if first is None:
            first = {
                "predicted_index": i1,
                "live_index": j1,
                "op": tag,
                "predicted": [_action_dict(a)
                              for a in pred[i1:min(i2, i1 + context)]],
                "live": [_action_dict(a)
                         for a in liv[j1:min(j2, j1 + context)]],
                "context_before": [_action_dict(a)
                                   for a in pred[max(0, i1 - context):i1]],
                "context_after": [_action_dict(a)
                                  for a in pred[i2:i2 + context]],
            }
    phases: Dict[str, Dict[str, Any]] = {}
    for p, l in matched:
        kind, _ = _sig(p)
        pt = (getattr(p, "payload", p.get("payload", {})
                      if isinstance(p, dict) else {})).get("t")
        lt = (getattr(l, "payload", l.get("payload", {})
                      if isinstance(l, dict) else {})).get("t")
        if pt is None or lt is None:
            continue
        ph = phases.setdefault(kind, {"count": 0, "sum_abs_dt_s": 0.0,
                                      "max_abs_dt_s": 0.0,
                                      "pred_min": float("inf"),
                                      "pred_max": float("-inf"),
                                      "live_min": float("inf"),
                                      "live_max": float("-inf")})
        dt = abs(float(lt) - float(pt))
        ph["count"] += 1
        ph["sum_abs_dt_s"] += dt
        ph["max_abs_dt_s"] = max(ph["max_abs_dt_s"], dt)
        ph["pred_min"] = min(ph["pred_min"], float(pt))
        ph["pred_max"] = max(ph["pred_max"], float(pt))
        ph["live_min"] = min(ph["live_min"], float(lt))
        ph["live_max"] = max(ph["live_max"], float(lt))
    phase_error: Dict[str, Any] = {}
    for kind, ph in sorted(phases.items()):
        pred_span = ph["pred_max"] - ph["pred_min"]
        live_span = ph["live_max"] - ph["live_min"]
        phase_error[kind] = {
            "count": ph["count"],
            "mean_abs_dt_s": ph["sum_abs_dt_s"] / ph["count"],
            "max_abs_dt_s": ph["max_abs_dt_s"],
            "predicted_span_s": pred_span,
            "live_span_s": live_span,
            "span_rel_error": (abs(live_span - pred_span) / pred_span
                               if pred_span > 0 else 0.0),
        }
    return {
        "n_predicted": len(pred),
        "n_live": len(liv),
        "aligned": len(matched),
        "divergences": divergences,
        "first_divergence": first,
        "phase_error": phase_error,
    }

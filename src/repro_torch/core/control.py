"""Control points (paper §3.2) for the training runtime (the port's copy
of ``repro.core.control``, which it may not import).

A training job's natural interruption point is the step boundary: the
gradient sync already synchronises the gang, so it is a barrier control
point with no message in flight.  ``ControlPointRunner`` is consulted by
the runtime at every step boundary and may emit actions:

    checkpoint   periodic / incremental snapshot
    migrate      consolidate a fragmented gang (locality)
    rescale      grow/shrink the data-parallel world (elasticity)
    recover      gang restart from the last snapshot after a failure

``Action`` is the shared vocabulary of the scheduling stack.  Straggler
mitigation: an EWMA of step times flags steps slower than
``factor`` x the moving average; persistent stragglers trigger a migrate
action.  The port's runtime acts on checkpoint actions; migrate and
rescale wait for the fabric (ROADMAP, slice (c)) and are only recorded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import telemetry


def _plain(value: Any) -> Any:
    """Coerce numpy scalars/arrays (and tuples) to plain Python."""
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
    return value


@dataclasses.dataclass
class Action:
    kind: str                      # checkpoint | migrate | rescale | recover
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-plain dict: payload values coerced to Python scalars."""
        return {"kind": self.kind, "payload": _plain(self.payload)}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Action":
        return cls(kind=data["kind"], payload=dict(data.get("payload", {})))


class EwmaStragglerDetector:
    """Flags steps slower than factor x EWMA; K consecutive flags fire."""

    def __init__(self, alpha: float = 0.2, factor: float = 2.0,
                 patience: int = 3):
        self.alpha = alpha
        self.factor = factor
        self.patience = patience
        self.ewma: Optional[float] = None
        self.strikes = 0
        self.flagged = 0

    def observe(self, step_time: float) -> bool:
        if self.ewma is None:
            self.ewma = step_time
            return False
        tel = telemetry.get()
        slow = step_time > self.factor * self.ewma
        # slow steps do not pollute the baseline estimate
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
            self.strikes = 0
            if tel.enabled:
                tel.gauge("straggler.ewma_s", self.ewma)
            return False
        self.strikes += 1
        if self.strikes >= self.patience:
            self.strikes = 0
            self.flagged += 1
            if tel.enabled:
                tel.count("straggler.flagged")
                tel.gauge("straggler.ewma_s", self.ewma)
                tel.instant("straggler.flag", track="control",
                            ewma_s=self.ewma, step_time_s=step_time)
            return True
        return False


class ControlPointRunner:
    """Evaluates triggers at step-boundary control points."""

    def __init__(self, checkpoint_every: int = 100,
                 straggler: Optional[EwmaStragglerDetector] = None,
                 failure_probe: Optional[Callable[[], bool]] = None,
                 elastic_probe: Optional[Callable[[int], Optional[int]]] = None):
        self.checkpoint_every = checkpoint_every
        self.straggler = straggler or EwmaStragglerDetector()
        self.failure_probe = failure_probe
        self.elastic_probe = elastic_probe
        self.history: List[Action] = []
        self.straggler_migrations = 0

    def on_step(self, step: int, step_time: float,
                world_size: int) -> List[Action]:
        actions: List[Action] = []
        if self.failure_probe is not None and self.failure_probe():
            actions.append(Action("recover", {"step": step}))
            self._log(actions)
            return actions          # recovery preempts everything else
        if self.checkpoint_every and step > 0 \
                and step % self.checkpoint_every == 0:
            actions.append(Action("checkpoint", {"step": step}))
        if self.straggler.observe(step_time):
            self.straggler_migrations += 1
            tel = telemetry.get()
            if tel.enabled:
                tel.count("straggler.migrations")
            actions.append(Action("migrate", {"reason": "straggler",
                                              "step": step}))
        if self.elastic_probe is not None:
            new_world = self.elastic_probe(world_size)
            if new_world is not None and new_world != world_size:
                actions.append(Action("rescale", {"from": world_size,
                                                  "to": new_world,
                                                  "step": step}))
        self._log(actions)
        return actions

    def _log(self, actions: List[Action]) -> None:
        self.history.extend(actions)

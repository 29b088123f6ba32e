"""Anytime decoding: cooperative budget clocks for graceful degradation
(PyTorch port of ``consensus_tpu/methods/anytime.py``).

The paper's decoders are budgeted searches whose intermediate state already
contains a valid welfare-ranked statement — best-of-N after generation,
beam search after any step, lookahead after any emitted token, MCTS after
any wave, the Habermas Machine after any deliberation phase.  Under
deadline or overload pressure the right failure mode is therefore *degrade
the answer, not the availability*: return the best-so-far statement tagged
``degraded=true`` instead of burning the tokens already spent on device and
answering 504.

This module is the seam every method shares:

* :class:`BudgetClock` — a cooperative budget: an optional monotonic
  deadline, an optional cancellation probe (the serving ticket's
  ``cancelled`` flag), and a *budget scale* in ``(0, 1]`` that the brownout
  controller uses to shrink search effort (N, beam width, lookahead depth,
  MCTS simulations — never temperature and never the welfare rule).
  Checks are O(1) and the unbounded clock is a no-op, so the seam costs
  nothing on the full-budget path.  Expiry is STICKY: once a clock reports
  expired it stays expired, so a method's exit decision cannot flap
  mid-unwind.
* :class:`AnytimeResult` — the checkpoint record a method refreshes after
  each wave/round: best-so-far statement, its internal search welfare when
  the method tracks one, and how much budget was spent.
* :class:`BudgetExpired` — raised only when the clock expires before ANY
  checkpoint exists (nothing to degrade to); the serving layer maps it to
  504, exactly like the pre-anytime behaviour.

Checks happen BETWEEN device dispatches (device programs are not
preemptible), which bounds overshoot to one wave — the same cooperative
contract the scheduler's cancellation already uses.

Obs families:
``anytime_early_exits_total{method,reason}`` counts degraded exits by
trigger (deadline | cancelled), and ``degraded_welfare_gap{method}``
histograms the welfare a degraded statement gave up against a full-budget
golden run of the same request (recorded by harnesses that run both, e.g.
the overload acceptance test).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

from consensus_tpu_torch.obs import get_registry


class BudgetExpired(Exception):
    """The budget expired before any checkpoint produced a statement.

    Carries the method name, the expiry reason (``deadline`` or
    ``cancelled``), and whatever budget accounting the method had; the
    serving layer maps this to a 504 (there is nothing to degrade to)."""

    def __init__(self, method: str, reason: str,
                 budget_spent: Optional[Dict[str, Any]] = None):
        super().__init__(
            f"{method}: budget expired ({reason}) before any wave completed"
        )
        self.method = method
        self.reason = reason
        self.budget_spent = dict(budget_spent or {})


@dataclasses.dataclass
class AnytimeResult:
    """Best-so-far search state recorded at a cooperative checkpoint."""

    statement: str
    #: The method's INTERNAL search welfare for the statement (cumulative
    #: min-reward for beam search, path welfare for lookahead, …) when the
    #: method tracks one; None for phase-structured methods (Habermas).
    welfare: Optional[float] = None
    #: Which checkpoint produced this (e.g. ``"step 12/50"``).
    checkpoint: str = ""
    #: Budget accounting at the checkpoint (method-specific keys such as
    #: ``steps_done`` / ``steps_planned``).
    budget_spent: Dict[str, Any] = dataclasses.field(default_factory=dict)


class BudgetClock:
    """Cooperative budget: deadline + cancellation probe + budget scale.

    ``expired()`` is the only hot call; for the unbounded clock it is two
    attribute reads.  The expiry *reason* is latched on first detection —
    ``deadline`` (monotonic deadline passed) or ``cancelled`` (the probe
    returned True, e.g. the serving ticket was abandoned)."""

    __slots__ = ("deadline", "scale", "cancelled_probe", "tier", "_reason")

    def __init__(
        self,
        deadline: Optional[float] = None,
        scale: float = 1.0,
        cancelled: Optional[Callable[[], bool]] = None,
        tier: Optional[int] = None,
    ):
        if not (0.0 < scale <= 1.0):
            raise ValueError(f"budget scale must be in (0, 1], got {scale}")
        self.deadline = deadline  # monotonic seconds; None = unbounded
        self.scale = float(scale)
        self.cancelled_probe = cancelled
        #: Brownout tier that issued this clock (None outside serving).
        self.tier = tier
        self._reason: Optional[str] = None

    @classmethod
    def unbounded(cls) -> "BudgetClock":
        """Full budget: never expires, scale 1.0 — today's exact behaviour."""
        return cls()

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "BudgetClock":
        """Offline clock from method-config scalars: ``budget_s`` (wall
        seconds for this statement, measured from now) and/or
        ``budget_scale``.  Absent both, the unbounded clock."""
        budget_s = config.get("budget_s")
        scale = float(config.get("budget_scale", 1.0))
        deadline = (
            time.monotonic() + float(budget_s) if budget_s is not None else None
        )
        return cls(deadline=deadline, scale=scale)

    @property
    def bounded(self) -> bool:
        return self.deadline is not None or self.cancelled_probe is not None

    @property
    def reason(self) -> Optional[str]:
        """Latched expiry reason (``deadline`` | ``cancelled``), or None."""
        return self._reason

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        """True once the budget is gone; sticky after the first True."""
        if self._reason is not None:
            return True
        if self.cancelled_probe is not None and self.cancelled_probe():
            self._reason = "cancelled"
            return True
        if self.deadline is not None and time.monotonic() >= self.deadline:
            self._reason = "deadline"
            return True
        return False

    def scale_int(self, value: int) -> int:
        """Shrink an integer search budget by the brownout scale.

        Ceil-rounded and floored at 1 so a scaled budget never degenerates
        to zero work; a zero/negative configured budget is preserved
        (``num_rounds: 0`` must stay 0).  ``scale == 1.0`` is the identity,
        so full-budget runs are untouched."""
        if value <= 0 or self.scale >= 1.0:
            return int(value)
        return max(1, int(math.ceil(value * self.scale)))


# -- observability ----------------------------------------------------------

def record_early_exit(method: str, reason: str, registry=None) -> None:
    """Count a degraded (early) exit in ``anytime_early_exits_total``."""
    reg = registry if registry is not None else get_registry()
    reg.counter(
        "anytime_early_exits_total",
        "Anytime decoder early exits (degraded statements returned), by "
        "method and trigger (deadline | cancelled).",
        ("method", "reason"),
    ).labels(method, reason).inc()


#: Welfare-gap buckets: log-prob welfare gaps are small positive reals.
_GAP_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0)


def observe_welfare_gap(
    method: str, full_welfare: float, degraded_welfare: float, registry=None
) -> float:
    """Record how much welfare a degraded statement gave up vs the
    full-budget golden for the same request, into
    ``degraded_welfare_gap{method}``.  Called by harnesses that run both
    (the overload acceptance test); returns the gap (clamped at
    0 — a degraded run can tie but never beats its own full-budget search
    on the recorded internal welfare)."""
    gap = max(0.0, float(full_welfare) - float(degraded_welfare))
    reg = registry if registry is not None else get_registry()
    reg.histogram(
        "degraded_welfare_gap",
        "Internal search welfare given up by a degraded statement vs the "
        "full-budget golden run of the same request, by method.",
        ("method",),
        _GAP_BUCKETS,
    ).labels(method).observe(gap)
    return gap

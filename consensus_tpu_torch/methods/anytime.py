"""Anytime decoding: cooperative budget clocks for graceful degradation
(the part of ``consensus_tpu/methods/anytime.py`` the port needs).

* :class:`BudgetClock` -- a cooperative budget: an optional monotonic
  deadline and a budget scale in ``(0, 1]`` that shrinks search effort.  The unbounded clock is a no-op.
  Expiry is sticky.
* :class:`AnytimeResult` -- the best-so-far checkpoint a method records.
* :class:`BudgetExpired` -- raised when the clock expires before any
  checkpoint exists.

The obs families of the JAX version (early-exit counter, welfare-gap
histogram) wait for the obs port (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional


class BudgetExpired(Exception):
    """The budget expired before any checkpoint produced a statement.

    Carries the method name, the expiry reason (``deadline``), and
    whatever budget accounting the method had."""

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
    """Cooperative budget: an optional monotonic deadline and a budget scale.

    ``expired()`` is the only hot call; for the unbounded clock it is one
    attribute read.  The expiry is latched on first detection."""

    __slots__ = ("deadline", "scale", "_reason")

    def __init__(self, deadline: Optional[float] = None, scale: float = 1.0):
        if not (0.0 < scale <= 1.0):
            raise ValueError(f"budget scale must be in (0, 1], got {scale}")
        self.deadline = deadline  # monotonic seconds; None = unbounded
        self.scale = float(scale)
        self._reason: Optional[str] = None

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
        """True when the clock can expire (a deadline is set)."""
        return self.deadline is not None

    @property
    def reason(self) -> Optional[str]:
        """Latched expiry reason (``deadline``), or None."""
        return self._reason

    def expired(self) -> bool:
        """True once the budget is gone; sticky after the first True."""
        if self._reason is not None:
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

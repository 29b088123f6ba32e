"""Decoder base class (PyTorch port of ``consensus_tpu/methods/base.py``).

Reference counterpart: ``src/methods/base.py`` (BaseGenerator ABC) and
``src/methods/__init__.py`` (GENERATOR_MAP / get_method_generator).  The one
architectural change: generators receive an explicit :class:`Backend`
instead of reaching for a module-global HTTP client (src/utils.py:69-74) —
the seam that lets the same decoder logic run against any backend.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, Dict, Optional

from consensus_tpu_torch.backends.base import Backend
from consensus_tpu_torch.methods.anytime import (
    AnytimeResult,
    BudgetClock,
    BudgetExpired,
)

logger = logging.getLogger(__name__)


class BaseGenerator(abc.ABC):
    """A consensus-statement decoding method.

    Parameters
    ----------
    backend:
        Model-execution backend.
    config:
        The method's section of the experiment YAML (seed already injected
        by the experiment engine).
    model_identifier:
        Carried for result keys and API-backend routing; the TPU backend
        ignores it (its model is fixed at construction).

    Anytime seam (graceful degradation)
    -----------------------------------
    Search methods call :meth:`_checkpoint` after each completed
    wave/round to record the best-so-far statement, and guard device
    dispatches with ``if self.budget_clock.expired(): return
    self._degrade()``.  Offline runs can bound a statement with the
    ``budget_s`` / ``budget_scale`` config keys.  With no bound
    configured the clock is unbounded and the seam is inert — outputs are
    bit-identical to a build without it.

    After ``generate_statement`` returns, callers inspect ``degraded``,
    ``degraded_reason``, and ``budget_spent`` to tag the result.
    """

    #: Overridden per subclass; labels anytime obs + BudgetExpired.
    method_name: str = "unknown"

    def __init__(
        self,
        backend: Backend,
        config: Optional[Dict[str, Any]] = None,
        model_identifier: str = "",
    ):
        self.backend = backend
        self.config = dict(config or {})
        self.model_identifier = model_identifier
        # Statement before the optional brushup pass; the experiment engine
        # records it when present (reference src/experiment.py:184-188).
        self.pre_brushup_statement: Optional[str] = None
        self._budget_clock: Optional[BudgetClock] = None
        #: Latest cooperative checkpoint; None until the first wave lands.
        self.anytime: Optional[AnytimeResult] = None
        #: True when the returned statement used less than the configured
        #: budget (early exit OR brownout-scaled search).
        self.degraded: bool = False
        #: Why (``deadline`` | ``budget_scaled``), or None.
        self.degraded_reason: Optional[str] = None
        #: Budget accounting for the returned statement (method-specific).
        self.budget_spent: Dict[str, Any] = {}

    @abc.abstractmethod
    def generate_statement(self, issue: str, agent_opinions: Dict[str, str]) -> str:
        """Produce one consensus statement for the issue and opinions."""

    @property
    def seed(self) -> Optional[int]:
        value = self.config.get("seed")
        return int(value) if value is not None else None

    # -- anytime seam --------------------------------------------------------

    @property
    def budget_clock(self) -> BudgetClock:
        """The request's budget; lazily built from config on first access
        (so the ``budget_s`` deadline starts when generation starts)."""
        if self._budget_clock is None:
            self._budget_clock = BudgetClock.from_config(self.config)
        return self._budget_clock

    def _checkpoint(
        self,
        statement: str,
        welfare: Optional[float] = None,
        checkpoint: str = "",
        **budget_spent: Any,
    ) -> None:
        """Record the best-so-far statement after a completed wave/round.

        No-op (beyond attribute writes) on the unbounded clock; methods
        call it unconditionally so the full-budget path exercises the same
        code the degraded path returns from."""
        self.anytime = AnytimeResult(
            statement=statement,
            welfare=welfare,
            checkpoint=checkpoint,
            budget_spent=dict(budget_spent),
        )

    def _degrade(self) -> str:
        """Exit early: return the latest checkpoint tagged degraded, or
        raise :class:`BudgetExpired` when no wave has completed yet."""
        reason = self.budget_clock.reason or "deadline"
        if self.anytime is None:
            raise BudgetExpired(self.method_name, reason)
        self.degraded = True
        self.degraded_reason = reason
        self.budget_spent = dict(self.anytime.budget_spent)
        logger.info("%s: early exit (%s)", self.method_name, reason)
        return self.anytime.statement

    def _mark_scaled(self, **budget_spent: Any) -> None:
        """Tag a run that completed under a brownout-shrunk budget
        (scale < 1): degraded, but not an early exit (no counter inc)."""
        self.degraded = True
        if self.degraded_reason is None:
            self.degraded_reason = "budget_scaled"
        merged = dict(self.budget_spent)
        merged.update(budget_spent)
        merged.setdefault("budget_scale", self.budget_clock.scale)
        self.budget_spent = merged

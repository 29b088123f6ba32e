"""Decoding methods (PyTorch port of ``consensus_tpu/methods``).

Ported: the methods that need only ``generate`` and ``score``
(``best_of_n``, ``zero_shot``, ``predefined``, ``habermas_machine``) and the
token-level searches over a fused session (``beam_search``,
``finite_lookahead``).  ``get_method_generator`` raises
``NotImplementedError`` for ``mcts``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

from consensus_tpu_torch.backends.base import Backend
from consensus_tpu_torch.methods.anytime import AnytimeResult, BudgetClock, BudgetExpired
from consensus_tpu_torch.methods.base import BaseGenerator
from consensus_tpu_torch.methods.beam_search import BeamSearchGenerator
from consensus_tpu_torch.methods.best_of_n import BestOfNGenerator
from consensus_tpu_torch.methods.finite_lookahead import FiniteLookaheadGenerator
from consensus_tpu_torch.methods.habermas import HabermasMachineGenerator
from consensus_tpu_torch.methods.predefined import PredefinedStatementGenerator
from consensus_tpu_torch.methods.zero_shot import ZeroShotGenerator

#: Name -> class map of the ported methods.
GENERATOR_MAP: Dict[str, Type[BaseGenerator]] = {
    "best_of_n": BestOfNGenerator,
    "zero_shot": ZeroShotGenerator,
    "predefined": PredefinedStatementGenerator,
    "beam_search": BeamSearchGenerator,
    "finite_lookahead": FiniteLookaheadGenerator,
    "habermas_machine": HabermasMachineGenerator,
}

#: Methods of the JAX package that wait for a later slice.
NOT_PORTED = ("mcts",)


def get_method_generator(
    method_name: str,
    backend: Backend,
    config: Optional[Dict[str, Any]] = None,
    model_identifier: str = "",
) -> BaseGenerator:
    """Instantiate the named method."""
    if method_name in NOT_PORTED:
        raise NotImplementedError(
            f"method {method_name!r} is not ported yet (ROADMAP.md, queue A: "
            "the other methods)"
        )
    try:
        cls = GENERATOR_MAP[method_name]
    except KeyError:
        raise ValueError(
            f"Unknown method: {method_name!r}. Available: {sorted(GENERATOR_MAP)}"
        ) from None
    return cls(backend=backend, config=config, model_identifier=model_identifier)


__all__ = [
    "AnytimeResult",
    "BaseGenerator",
    "BeamSearchGenerator",
    "BestOfNGenerator",
    "BudgetClock",
    "BudgetExpired",
    "FiniteLookaheadGenerator",
    "GENERATOR_MAP",
    "HabermasMachineGenerator",
    "PredefinedStatementGenerator",
    "ZeroShotGenerator",
    "get_method_generator",
]

"""Decoding methods (PyTorch port of ``consensus_tpu/methods``).

Every method of the JAX package: those that need only ``generate`` and
``score`` (``best_of_n``, ``zero_shot``, ``predefined``,
``habermas_machine``) and the token-level searches over a session
(``beam_search``, ``finite_lookahead``, ``mcts``).
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
from consensus_tpu_torch.methods.mcts import MCTSGenerator
from consensus_tpu_torch.methods.predefined import PredefinedStatementGenerator
from consensus_tpu_torch.methods.zero_shot import ZeroShotGenerator

#: Name -> class map of the methods.
GENERATOR_MAP: Dict[str, Type[BaseGenerator]] = {
    "best_of_n": BestOfNGenerator,
    "zero_shot": ZeroShotGenerator,
    "predefined": PredefinedStatementGenerator,
    "beam_search": BeamSearchGenerator,
    "finite_lookahead": FiniteLookaheadGenerator,
    "habermas_machine": HabermasMachineGenerator,
    "mcts": MCTSGenerator,
}


def register_generator(name: str, cls: Type[BaseGenerator]) -> None:
    """Add (or replace) a method under ``name`` for ``get_method_generator``."""
    GENERATOR_MAP[name] = cls


def get_method_generator(
    method_name: str,
    backend: Backend,
    config: Optional[Dict[str, Any]] = None,
    model_identifier: str = "",
) -> BaseGenerator:
    """Instantiate the named method."""
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
    "MCTSGenerator",
    "PredefinedStatementGenerator",
    "ZeroShotGenerator",
    "get_method_generator",
    "register_generator",
]

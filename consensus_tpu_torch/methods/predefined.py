"""Pass-through generator for externally supplied statements.

Parity with reference ``src/methods/predefined_statement.py:7-55``: returns
``config["predefined_statement"]`` verbatim so external/reference statements
flow through the identical evaluation pipeline (used by the paper's
main-body configs, e.g. configs/main_body/scenario_1.yaml:66-67).
"""

from __future__ import annotations

from typing import Dict

from consensus_tpu_torch.methods.base import BaseGenerator

MISSING_STATEMENT = "[ERROR: Predefined statement not found in config]"


class PredefinedStatementGenerator(BaseGenerator):
    method_name = "predefined"

    def generate_statement(self, issue: str, agent_opinions: Dict[str, str]) -> str:
        statement = self.config.get("predefined_statement")
        return statement if statement is not None else MISSING_STATEMENT

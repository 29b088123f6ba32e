"""What decides ``correct``: the timed path's own outputs against the plain
reference (``bench_port/reference/``), once the window has closed.

Each method's checks live in ``checks/<method>.py``, found by the traffic
mix's ``method`` as the per-layer metrics are found by name.  Such a module
gives ``mismatches(statement, scenario, cfg)``, the exact checks of one
statement (limit 0, run on every statement of the window), and
``compare(statements, sample, cfg, flat, seed, weights, control_weights)``,
the numbers against the reference on a sample of statements drawn from the
seed, returned with the control's readings of the same numbers.  This
module holds what they share: the prompts' token ids, the calls a
statement made, the seeded sample, and the weights of both sides.

With ``control=True`` the sample is also run through the reference with
int4 weights (the control: the step below the configuration's int8), which
is put in the program's place and read the same way.
"""

from __future__ import annotations

import importlib.util
import pathlib
from typing import Any, Dict, List, Optional

import numpy as np

from bench_port.reference import text
from bench_port.reference.model import Weights

CHECKS_DIR = pathlib.Path(__file__).resolve().parents[1] / "checks"


def prompt_ids(user: str, system: Optional[str], chat: bool) -> List[int]:
    rendered = text.chat_prompt(user, system) if chat else text.raw_prompt(user, system)
    return text.encode(rendered, add_bos=True)


def calls(st, kind: str) -> list:
    """The (requests, results) of every call of ``kind`` the statement made."""
    return [(req, res) for k, req, res in st.log.calls if k == kind]


def sample(statements: list, count: int, seed: int, key, salt: int) -> list:
    """``count`` statements: the one with the longest ``key``, then others
    drawn from the seed."""
    if not statements or count <= 0:
        return []
    longest = max(statements, key=key)
    rest = [s for s in statements if s is not longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7, salt]))
    picks = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in picks]


def load_method(method: str):
    path = CHECKS_DIR / f"{method}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_check_{method}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def judge(
    statements: list, scenarios: Dict[int, Any], traffic: Dict[str, Any], cfg: Dict[str, Any],
    flat_cfg: Dict[str, Any], seed: int, device, control: bool = False,
) -> Dict[str, Any]:
    """The cell's numbers (and, with ``control``, the control's)."""
    method = load_method(traffic["method"])
    ok = [s for s in statements if s.ok]
    readings: Dict[str, Any] = {
        "mismatches": sum(method.mismatches(s, scenarios[s.scenario], s.config) for s in ok),
    }
    ref_w = Weights(flat_cfg, seed, device, bits=8 if cfg["backend"].get("quantization") == "int8" else None)
    ctl_w = Weights(flat_cfg, seed, device, bits=4) if control else None
    numbers, controls = method.compare(ok, traffic["check"], cfg, flat_cfg, seed, ref_w, ctl_w)
    readings.update(numbers)
    if control:
        readings["control"] = controls
    return readings

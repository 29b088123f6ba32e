"""The general traffic generator: closed-loop clients over the method entry.

A traffic file names a method, its configuration, groups of clients (each
group a count and the configuration keys its clients change) and the
scenarios.  Client ``c``'s ``j``-th statement takes scenario
``scenarios[(c + j) % n]``, so every seed runs the same prompts, and a
method seed drawn from (seed, c, j).  Each client loops: open a batching session, call
``generate_statement`` through a ``StatementLog``, record its wall; it
stops taking statements once admission closes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from bench_port.harness.record import StatementLog


@dataclasses.dataclass
class Statement:
    client: int
    index: int
    scenario: int
    config: Dict[str, Any]
    start: float = 0.0
    end: float = 0.0
    text: Optional[str] = None
    pre_brushup: Optional[str] = None
    error: Optional[str] = None
    log: Optional[StatementLog] = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.text is not None and not self.text.startswith("[ERROR")

    @property
    def wall(self) -> float:
        return self.end - self.start


def client_configs(traffic: Dict[str, Any]) -> List[Dict[str, Any]]:
    out = []
    for group in traffic["clients"]:
        out.extend([dict(group.get("config", {}))] * int(group["count"]))
    return out


class Schedule:
    """Each client's statements; ``overrides`` (the warm-up's) replace
    configuration keys of every statement."""

    def __init__(self, traffic: Dict[str, Any], seed: int, overrides: Optional[Dict[str, Any]] = None):
        self.traffic = traffic
        self.seed = int(seed)
        self.clients = client_configs(traffic)
        self.overrides = dict(overrides or {})

    def statement(self, client: int, index: int) -> Statement:
        scenarios = self.traffic["scenarios"]
        scenario = scenarios[(client + index) % len(scenarios)]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, client, index]))
        config = {
            **self.traffic["method_config"],
            **self.clients[client],
            **self.overrides,
            "seed": int(rng.integers(0, 2**31 - 1)),
        }
        return Statement(client=client, index=index, scenario=scenario, config=config)


def run_clients(
    batching,
    schedule: Schedule,
    scenarios: Dict[int, Dict[str, Any]],
    admit: Callable[[int, int], bool],
    first_index: int,
    join_timeout_s: float,
) -> List[Statement]:
    """Run every client until ``admit(client, j)`` is false; return the
    statements in the order they finished."""
    from consensus_tpu_torch.methods import get_method_generator

    method = schedule.traffic["method"]
    done: List[Statement] = []
    lock = threading.Lock()

    def client(c: int) -> None:
        j = 0
        while admit(c, j):
            st = schedule.statement(c, first_index + j)
            scenario = scenarios[st.scenario]
            st.log = StatementLog(batching)
            generator = get_method_generator(method, backend=st.log, config=st.config)
            with batching.session():
                st.start = time.perf_counter()
                try:
                    st.text = generator.generate_statement(scenario["issue"], scenario["agent_opinions"])
                except Exception:  # a failed statement is counted, not fatal
                    st.error = traceback.format_exc(limit=8)
                st.end = time.perf_counter()
            st.pre_brushup = generator.pre_brushup_statement
            st.log.inner = None
            with lock:
                done.append(st)
            j += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(len(schedule.clients))]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + join_timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"statements still running {join_timeout_s:.0f} s after admission began")
    return done

"""The port's load generator (``serve/loadgen.py`` and
``consensus_tpu_torch/scripts/serve_loadgen.py``) against the JAX
package's.

Tolerance: exact.  ``scenario_requests`` and ``corpus_requests`` give equal
payload lists for the same arguments (round-robin, Zipf and fixed repeats,
agent expansion, corpus mixes), ``report_json`` renders a report the same
way, and a self-contained run of the port's driver on the fake backend
(three elastic replicas, two chaos kills) reports availability 1.0 and
respawns, as the JAX driver does."""

import json
import os
import subprocess
import sys

import pytest

from consensus_tpu.serve import loadgen as jax_loadgen
from consensus_tpu_torch.serve import loadgen

CASES = [
    dict(n=10),
    dict(n=12, scenario_repeat="fixed:2", evaluate=True, timeout_s=5.0),
    dict(n=20, scenario_repeat="zipf:1.2", base_seed=7),
    dict(n=6, agents=9, method="zero_shot", params={"max_tokens": 16}),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_scenario_requests_equal_jax(case):
    kwargs = dict(CASES[case])
    n = kwargs.pop("n")
    assert loadgen.scenario_requests(n, **kwargs) == jax_loadgen.scenario_requests(n, **kwargs)


@pytest.mark.parametrize("mix, agents", [(None, None), ("polarized=2,sybil=1", None), (None, 7)])
def test_corpus_requests_equal_jax(mix, agents):
    kwargs = dict(method="best_of_n", params={"n": 4}, base_seed=3, mix=mix, agents=agents)
    got = loadgen.corpus_requests("v2", 16, **kwargs)
    assert got == jax_loadgen.corpus_requests("v2", 16, **kwargs)
    assert len(got) == 16


def test_report_json_equal_jax():
    report = {"completed": 8, "availability": 1.0, "latency_s": {"p50": 0.125, "p95": 0.5},
              "fleet": {"size": 2, "lost": 1}, "chaos": {"kills": 1}}
    assert loadgen.report_json(report) == jax_loadgen.report_json(report)


def _driver(script, extra, env):
    out = subprocess.run([sys.executable, script, "--self-contained", *extra],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def test_self_contained_elastic_chaos_run_reports_full_availability():
    env = dict(os.environ, PYTHONPATH=os.getcwd(), JAX_PLATFORMS="cpu")
    args = ["--fleet", "3", "--elastic", "--requests", "60", "--rate", "60",
            "--scenario-repeat", "fixed:2", "--chaos-schedule", "kill:0.3,kill:0.8"]
    port = _driver("consensus_tpu_torch/scripts/serve_loadgen.py", args, env)
    ref = _driver("scripts/serve_loadgen.py", args, env)
    for report in (port, ref):
        assert report["completed"] == 60 and report["availability"] == 1.0
        # The report reads the manager when the load has drained; the second
        # kill's respawn may still be under way then, in either package.
        assert report["chaos"]["kills"] == 2 and report["chaos"]["respawns"] >= 1
    assert set(port) == set(ref)
    assert port["scenario_mix"] == ref["scenario_mix"] == "fixed:2"

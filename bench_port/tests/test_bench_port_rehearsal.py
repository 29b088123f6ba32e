"""CPU rehearsals of both traffic mixes at a tiny size: the harness's whole
run past its look for a card, the reference against the port's forward on
shared weights, the control, and faults planted under the timed path, each
of which has to turn ``correct`` false."""

from __future__ import annotations

import dataclasses
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.harness import program, spec  # noqa: E402
from bench_port.harness.cell import run_cell, verdict  # noqa: E402
from bench_port.reference import model as reference  # noqa: E402

TINY = {"d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "ffn_hidden": 128}
SEED = 2**31 + 977  # larger than 32 signed bits hold
BON_TRAFFIC = {
    "method_config": {"n": 2, "max_tokens": 8, "temperature": 1.0, "matrix_scoring": True},
    "clients": [{"count": 2, "config": {}}, {"count": 1, "config": {"temperature": 0.0}}],
    "scenarios": [1, 2],
    "check": {"generations": 1, "sampled": 2, "matrices": 2},
}
BEAM_TRAFFIC = {
    "method_config": {"max_tokens": 5, "brushup": True, "pin_budget": True, "matrix_scoring": True},
    "clients": [{"count": 1, "config": {"beam_width": 2}}, {"count": 1, "config": {"beam_width": 3}}],
    "scenarios": [1, 3],
    "check": {"sessions": 2},
}


#: The beam-search mix and its configuration, ready for a later cell (no
#: cell of ``BENCHMARK.json`` runs them yet): rehearsed in the best-of-N
#: cell's place, with limits of its own.
BEAM = {
    "config": "configs/deepseek-llm-7b.json",
    "traffic": "traffic/beam_grid.json",
    "limits": {"mismatches": 0, "lp_gap": 0.5},
}


def tiny_cell(name: str) -> spec.Cell:
    if name == "deepseek-7b.beam":
        cell = spec.load_cell("mistral-7b.bon")
        cell.name = name
        cell.config = spec.load_json(spec.BENCH_DIR / BEAM["config"])
        cell.traffic = spec.load_json(spec.BENCH_DIR / BEAM["traffic"])
        cell.limits = dict(BEAM["limits"])
    else:
        cell = spec.load_cell(name)
    cell.config["model"].update(TINY)
    cell.config["backend"]["dtype"] = "float32"
    cell.traffic.update(BON_TRAFFIC if cell.traffic["method"] == "best_of_n" else BEAM_TRAFFIC)
    return cell


def rehearse(name: str, control: bool = False):
    cell = tiny_cell(name)
    out = run_cell(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter(), control=control)
    return cell, out, verdict(out["readings"], cell.limits, out["failed"])


@pytest.mark.parametrize("name", ["mistral-7b.bon", "deepseek-7b.beam"])
def test_rehearsal_is_correct_and_its_control_is_not(name):
    cell, out, judged = rehearse(name, control=True)
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert judged["correct"], judged
    assert {m.name for m in cell.end_to_end} == set(out["metrics"])
    control = out["readings"]["control"]
    assert any(control[k] > cell.limits[k] for k in control if k in cell.limits), (control, cell.limits)


def test_reference_agrees_with_the_ports_forward():
    from consensus_tpu_torch.models.transformer import forward

    cfg = tiny_cell("mistral-7b.bon").config
    device = torch.device("cpu")
    params = program.build_params(cfg, SEED, device)
    ids = [1] + list(range(20, 120))
    tokens = torch.tensor([ids])
    positions = torch.arange(len(ids))[None]
    ours, _ = forward(params, program.model_config(cfg), tokens, positions, torch.ones_like(tokens, dtype=torch.bool))
    flat = program.flat_config(cfg)
    ref = reference.run(flat, reference.Weights(flat, SEED, device, bits=8), [reference.Job(ids, (0, len(ids)))])
    assert torch.allclose(ours[0].float(), ref[0].prefix, atol=1e-4, rtol=1e-4)
    branch = reference.run(
        flat, reference.Weights(flat, SEED, device, bits=8), [reference.Job(ids[:60], (0, 0), [ids[60:]])]
    )[0].branches[0]
    assert torch.allclose(branch, ref[0].prefix[59:-1], atol=1e-4, rtol=1e-4)


# -- faults planted under the timed path --------------------------------------


def _altered_tokens(monkeypatch):
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    original = TorchBackend._finish_generation

    def finish(self, *args, **kwargs):
        return [
            dataclasses.replace(r, token_ids=tuple([12 + ord("~")] * len(r.token_ids)))
            for r in original(self, *args, **kwargs)
        ]

    monkeypatch.setattr(TorchBackend, "_finish_generation", finish)


def _altered_utilities(monkeypatch):
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    original = TorchBackend.score_matrix

    def score_matrix(self, requests):
        return [
            dataclasses.replace(r, utilities=np.asarray(r.utilities) + 0.5)
            for r in original(self, requests)
        ]

    monkeypatch.setattr(TorchBackend, "score_matrix", score_matrix)


def _half_the_tokens(monkeypatch):
    """Each candidate's mean taken over its first half only."""
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    original = TorchBackend.score_matrix

    def score_matrix(self, requests):
        halves = [
            dataclasses.replace(r, candidates=tuple(c[: max(1, len(c) // 2)] for c in r.candidates))
            for r in requests
        ]
        return original(self, halves)

    monkeypatch.setattr(TorchBackend, "score_matrix", score_matrix)


def _stale_session(monkeypatch):
    """An advance that returns the session's state unchanged: the previous
    step's proposals."""
    from consensus_tpu_torch.backends.torch_backend import TorchTokenSearchSession

    original = TorchTokenSearchSession.advance_and_propose

    def advance(self, parents, chosen):
        out = original(self, parents, chosen)
        previous = getattr(self, "_previous", None)
        self._previous = out
        return previous if previous is not None else out

    monkeypatch.setattr(TorchTokenSearchSession, "advance_and_propose", advance)


def _altered_logprobs(monkeypatch):
    from consensus_tpu_torch.backends.torch_backend import TorchTokenSearchSession

    original = TorchTokenSearchSession._unpack

    def unpack(self, packed):
        return [
            [c._replace(agent_logprobs=tuple(v + 0.5 for v in c.agent_logprobs)) for c in slot]
            for slot in original(self, packed)
        ]

    monkeypatch.setattr(TorchTokenSearchSession, "_unpack", unpack)


@pytest.mark.parametrize(
    "name, fault",
    [
        ("mistral-7b.bon", _altered_tokens),
        ("mistral-7b.bon", _altered_utilities),
        ("mistral-7b.bon", _half_the_tokens),
        ("deepseek-7b.beam", _stale_session),
        ("deepseek-7b.beam", _altered_logprobs),
    ],
    ids=["bon-token-altered", "bon-utility-altered", "bon-half-the-tokens",
         "beam-state-unchanged", "beam-logprob-altered"],
)
def test_a_planted_fault_turns_correct_false(monkeypatch, name, fault):
    fault(monkeypatch)
    _, _, judged = rehearse(name)
    assert not judged["correct"], judged

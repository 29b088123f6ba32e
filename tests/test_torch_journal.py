"""The port's run journal, resume, timing mode and sweep flags against the
JAX package's.

* ``JournalWriter`` / ``read_journal``: either package reads the other's
  journal, torn tail lines and other schemas skipped.
* ``run_config_hash`` equals the JAX one, so a journal key means the same
  run in both packages.
* A run cut after k rows (a backend that fails at its k-th generate call
  under ``on_error: fail``) and resumed gives the uninterrupted run's
  ``results.csv`` byte for byte and executes only the missing runs;
  concurrent and sequential.
* ``pin_generation_budget`` gives the JAX backend's token ids (tiny-llama3,
  float32, shared weights), every request at its full ``max_tokens``.
* ``run_sweep --timing-pin-budget --metrics-out --resume`` on a tmp tree of
  tiny-llama3 configs.
"""

import json

import jax
import numpy as np
import pytest
import torch
import yaml

from consensus_tpu.backends.base import GenerationRequest as JaxRequest
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.experiment import run_config_hash as jax_hash
from consensus_tpu.utils import io_atomic as jax_io
from consensus_tpu_torch.backends import torch_backend
from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.cli import run_sweep
from consensus_tpu_torch.experiment import Experiment, run_config_hash
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.utils import io_atomic

torch.set_num_threads(1)

OPINIONS = {"alice": "Yes, green space matters.", "bob": "Too expensive."}


def test_journal_reads_across_packages(tmp_path):
    ours, theirs = tmp_path / "torch.jsonl", tmp_path / "jax.jsonl"
    records = [{"key": {"method": "m", "seed": i}, "row": {"statement": f"s{i}"}}
               for i in range(3)]
    with io_atomic.JournalWriter(ours) as writer:
        for record in records:
            writer.append(record)
    with jax_io.JournalWriter(theirs) as writer:
        for record in records:
            writer.append(record)
    assert ours.read_text() == theirs.read_text()
    with open(ours, "a") as fh:
        fh.write(json.dumps({"schema": "other.v1", "x": 1}) + "\n" + '{"schema": "consensus')
    assert io_atomic.read_journal(ours) == jax_io.read_journal(ours) == jax_io.read_journal(theirs)
    assert list(io_atomic.iter_journal(ours)) == io_atomic.read_journal(ours)
    assert io_atomic.read_journal(ours, schema=None)[-1] == {"schema": "other.v1", "x": 1}
    assert io_atomic.read_journal(tmp_path / "missing.jsonl") == []
    assert io_atomic.JOURNAL_SCHEMA == jax_io.JOURNAL_SCHEMA


@pytest.mark.parametrize("config", [
    {"n": 2, "seed": 1}, {"n": 2, "seed": 9}, {"n": 3},
    {"beam_width": 4, "max_tokens": 50, "brushup": True, "brushup_model": "gemma2-2b"},
    {"num_candidates": 3, "pin_budget": True, "temperature": 1.0, "path": None},
], ids=["seed1", "seed9", "n3", "beam", "habermas"])
def test_run_config_hash_matches_jax(config):
    assert run_config_hash(config) == jax_hash(config)
    assert run_config_hash(config) == run_config_hash(dict(config, seed=123))


class _DiesAt(FakeBackend):
    """A fake backend whose ``generate`` fails from its k-th call on."""

    def __init__(self, k):
        super().__init__()
        self.k, self.calls = k, 0

    def generate(self, requests):
        self.calls += 1
        if self.calls >= self.k:
            raise RuntimeError("device lost")
        return super().generate(requests)


def _config(tmp_path, sub, **overrides):
    config = {
        "experiment_name": "resume", "seed": 42, "num_seeds": 2, "backend": "fake",
        "models": {"generation_model": "fake-lm"},
        "scenario": {"issue": "Should the town build a park?", "agent_opinions": OPINIONS},
        "methods_to_run": ["zero_shot", "best_of_n", "predefined"],
        "zero_shot": {"max_tokens": 16},
        "best_of_n": {"n": [2, 3], "max_tokens": 16},
        "predefined": {"predefined_statement": "A fixed statement."},
        "output_dir": str(tmp_path / sub),
        "deterministic_artifacts": True,
    }
    config.update(overrides)
    return config


@pytest.mark.parametrize("concurrent", [True, False], ids=["concurrent", "sequential"])
def test_cut_run_resumes_to_the_uninterrupted_results(tmp_path, monkeypatch, concurrent):
    clean = Experiment(_config(tmp_path, "clean", concurrent_execution=concurrent))
    clean.run()
    expect = (clean.run_dir / "results.csv").read_bytes()

    cut = Experiment(
        _config(tmp_path, "cut", on_error="fail", concurrent_execution=False),
        backend=_DiesAt(3),
    )
    with pytest.raises(RuntimeError, match="device lost"):
        cut.run()
    journaled = io_atomic.read_journal(cut.run_dir / "journal.jsonl")
    assert 0 < len(journaled) < 8

    executed = []
    original = Experiment._run_one

    def counting(self, method, run_config, seed, backend=None):
        executed.append((method, run_config_hash(run_config), seed))
        return original(self, method, run_config, seed, backend=backend)

    monkeypatch.setattr(Experiment, "_run_one", counting)
    resumed = Experiment(_config(tmp_path, "cut", resume=True, concurrent_execution=concurrent))
    assert resumed.resumed and resumed.run_dir == cut.run_dir
    resumed.run()
    assert (resumed.run_dir / "results.csv").read_bytes() == expect
    after = io_atomic.read_journal(resumed.run_dir / "journal.jsonl")
    assert len(after) == 8 and len(executed) == 8 - len(journaled)
    assert not {r["run_index"] for r in after[len(journaled):]} & {
        r["run_index"] for r in journaled}

    again = Experiment(_config(tmp_path, "cut", resume=True))
    executed.clear()
    again.run()
    assert executed == [] and (again.run_dir / "results.csv").read_bytes() == expect
    # The JAX engine resumes the port's journal to the same file.
    from consensus_tpu.experiment import Experiment as JaxExperiment

    jax_run = JaxExperiment(_config(tmp_path, "cut", resume=True))
    jax_run.run()
    assert (jax_run.run_dir / "results.csv").read_bytes() == expect


def test_resume_without_prior_run_starts_fresh(tmp_path):
    experiment = Experiment(_config(tmp_path, "fresh", resume=True))
    assert not experiment.resumed
    assert len(experiment.run()) == 8


TINY = dict(model="tiny-llama3", dtype="float32", max_context=256)


@pytest.fixture(scope="module")
def pinned():
    ref = TPUBackend(pin_generation_budget=True, **TINY)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", pin_generation_budget=True, **TINY)


def test_pin_generation_budget_matches_jax(pinned):
    ref, port = pinned
    specs = [("Say hello.", 5, 1.0, 12, ("e", ".")), ("Bikes?", 6, 0.0, 9, ()),
             ("Bikes?", 7, 1.0, 20, ("\n",))]
    expect = ref.generate([JaxRequest(p, seed=s, temperature=t, max_tokens=m, stop=st)
                           for p, s, t, m, st in specs])
    got = port.generate([GenerationRequest(p, seed=s, temperature=t, max_tokens=m, stop=st)
                         for p, s, t, m, st in specs])
    assert [g.token_ids for g in got] == [e.token_ids for e in expect]
    assert [len(g.token_ids) for g in got] == [m for _, _, _, m, _ in specs]
    assert [g.finish_reason for g in got] == ["length"] * 3


def _tiny_sweep_tree(tmp_path):
    config = {
        "experiment_name": "tiny_sweep", "seed": 42, "num_seeds": 1, "backend": "tpu",
        "backend_options": dict(TINY),
        "models": {"generation_model": "tiny-llama3", "evaluation_models": ["tiny-llama3"]},
        "scenario": {"issue": "Should the town build a park?", "agent_opinions": OPINIONS},
        "methods_to_run": ["zero_shot", "best_of_n", "predefined"],
        "zero_shot": {"max_tokens": 6},
        "best_of_n": {"n": 2, "max_tokens": 5},
        "predefined": {"predefined_statement": "A fixed statement."},
        "output_dir": str(tmp_path / "runs"),
    }
    path = tmp_path / "tree" / "llama" / "scenario_1" / "tiny.yaml"
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(config))
    return path


def test_run_sweep_metrics_out_resume_and_timing_pin_budget(tmp_path, monkeypatch):
    path = _tiny_sweep_tree(tmp_path)
    built = []
    original = TorchBackend.__init__

    def init(self, *args, **kwargs):
        original(self, *args, **kwargs)
        built.append(self)

    monkeypatch.setattr(TorchBackend, "__init__", init)
    argv = ["--configs-root", str(tmp_path / "tree"), "--device", "cpu", "--quiet",
            "--skip-comparative-ranking", "--timing-pin-budget",
            "--metrics-out", str(tmp_path / "sweep.json")]
    assert run_sweep.main(argv) == 0
    assert len(built) == 1 and built[0].pin_generation_budget
    (run,) = (tmp_path / "runs").iterdir()
    tokens = json.loads((run / "token_counts.json").read_text())
    assert tokens["pinned_budget"] is True
    # Pinned: zero_shot decodes its whole 6-token budget, best-of-N 2 x 5.
    assert tokens["tokens_generated"] == 6 + 2 * 5
    config = yaml.safe_load((run / "config.yaml").read_text())
    assert config["timing_pin_budget"] is True
    aggregate = json.loads((tmp_path / "sweep.json").read_text())
    assert aggregate["schema"] == "consensus_tpu.metrics.sweep.v1"
    assert aggregate["cells"] == [run.name]
    cell = json.loads((run / "metrics.json").read_text())
    assert aggregate["metrics"] == cell["metrics"]
    assert aggregate["derived"]["padding_efficiency"] is not None
    assert "batching_flushes_total" in aggregate["metrics"]["families"]
    expect = (run / "results.csv").read_text()

    executed = []
    monkeypatch.setattr(
        torch_backend.TorchBackend, "generate",
        lambda self, requests: executed.append(len(requests)) or [],
    )
    assert run_sweep.main([*argv[:-2], "--resume"]) == 0
    assert executed == [] and [p.name for p in (tmp_path / "runs").iterdir()] == [run.name]
    assert (run / "results.csv").read_text() == expect

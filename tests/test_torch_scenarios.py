"""The port's scenario data, generator, corpus, registry and welfare-gap
tables against the JAX package's.

Pure-Python pieces compare exactly: the AAMAS data, generated records
(byte for byte), the repo's ``data/scenarios_v2`` corpus (content hash,
integrity, regeneration) and every registry ref.  ``main_body:<k>`` is the
one ref form where the packages differ: the JAX registry reads the issue at
the top level of a ``MAIN_BODY`` entry, where there is none, and raises
``KeyError``; the port reads the entry's ``scenario``, which is the
scenario of ``configs/main_body/scenario_<k>.yaml``.

Model-backed pieces use tiny-gemma2 / tiny-llama3 in float32 with JAX's
``init_params`` weights (``params_from_jax``), ``max_context`` 1024 so the
corpus prompts fit: ``welfare_gap_table`` against the JAX package's live
output within 1e-5 absolute (tables round to 6 digits; winners equal), and
an ``Experiment`` on a ``corpus:`` ref against the JAX ``Experiment``
(statements equal).
"""

import functools

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import consensus_tpu.data.scenarios as jscen
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.data import aamas_scenarios as jaamas
from consensus_tpu.data.scenarios import fairness as jfairness
from consensus_tpu.data.scenarios.corpus import scenarios_blob as jblob
from consensus_tpu.data.scenarios import registry as jregistry
from consensus_tpu.experiment import Experiment as JaxExperiment
import consensus_tpu_torch.data.scenarios as tscen
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.data import aamas_scenarios as taamas
from consensus_tpu_torch.data.scenarios import fairness as tfairness
from consensus_tpu_torch.data.scenarios.corpus import scenarios_blob as tblob
from consensus_tpu_torch.data.scenarios import registry as tregistry
from consensus_tpu_torch.experiment import Experiment
from consensus_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ROOT = tregistry._REPO_ROOT
CORPUS_IDS = [r["id"] for r in tscen.get_corpus("v2").scenarios]


def test_registry_repo_root_is_the_checkout():
    assert (ROOT / "consensus_tpu_torch").is_dir() and (ROOT / "data" / "scenarios_v2").is_dir()
    assert ROOT == jregistry._REPO_ROOT


def test_aamas_data_equals_jax():
    assert taamas.SCENARIOS == jaamas.SCENARIOS
    assert taamas.MAIN_BODY == jaamas.MAIN_BODY
    assert sorted(taamas.SCENARIOS) == [1, 2, 3, 4, 5] and sorted(taamas.MAIN_BODY) == [1, 2, 3]


@pytest.mark.parametrize(
    "spec",
    [
        {},
        {"seed": 7, "per_family": 3},
        {"version": "v9", "families": ("polarized", "sybil"), "include_big": False},
        {"per_family": 2, "agent_ladder": (2, 4, 9), "big_agents": 40},
    ],
    ids=["default", "seed7", "two-families", "ladder"],
)
def test_generated_records_are_byte_equal(spec):
    expect = jscen.generate_scenarios(jscen.CorpusSpec(**spec))
    got = tscen.generate_scenarios(tscen.CorpusSpec(**spec))
    assert tblob(got) == jblob(expect)
    assert tscen.CorpusSpec(**spec).to_dict() == jscen.CorpusSpec(**spec).to_dict()
    assert (tscen.GENERATOR_VERSION, tscen.SCENARIO_SCHEMA, tscen.FAMILIES) == (
        jscen.GENERATOR_VERSION, jscen.SCENARIO_SCHEMA, jscen.FAMILIES,
    )


def test_repo_corpus_loads_and_regenerates():
    got, expect = tscen.get_corpus("v2"), jscen.get_corpus("v2")
    assert got.manifest["content_hash"] == expect.manifest["content_hash"]
    assert got.manifest == expect.manifest and got.scenarios == expect.scenarios
    assert len(got.scenarios) == 49 and got.name == "scenarios_v2" and got.version == "v2"
    got.verify()
    ok, detail = tscen.regenerate_check(tscen.corpus_root("v2"))
    assert ok, detail
    assert jscen.regenerate_check(jscen.corpus_root("v2"))[0]
    assert got.sample_sequence(7, "polarized=2,sybil=1", 3) == expect.sample_sequence(
        7, "polarized=2,sybil=1", 3
    )


def test_written_corpus_round_trips(tmp_path):
    spec = tscen.CorpusSpec(per_family=2, include_big=False)
    manifest = tscen.write_corpus(tmp_path / "t", spec)
    jscen.write_corpus(tmp_path / "j", jscen.CorpusSpec(per_family=2, include_big=False))
    for name in ("scenarios.jsonl", "manifest.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert tscen.regenerate_check(tmp_path / "t")[0]
    assert manifest["n_scenarios"] == 12
    # A literal corpus path is a ref too.
    ref = f"corpus:{tmp_path / 't'}"
    assert tregistry.resolve_scenario_ref(ref) == jregistry.resolve_scenario_ref(ref)
    # A hand-edited corpus fails its integrity check.
    path = tmp_path / "t" / "scenarios.jsonl"
    path.write_text(path.read_text().replace("a", "b", 1))
    with pytest.raises(tscen.CorpusIntegrityError, match="content hash"):
        tscen.load_corpus(tmp_path / "t")


@pytest.mark.parametrize(
    "ref",
    [f"aamas:{k}" for k in range(1, 6)] + ["corpus:v2", " corpus:v2 "]
    + [f"corpus:v2:{sid}" for sid in CORPUS_IDS],
)
def test_refs_resolve_as_in_jax(ref):
    assert tregistry.resolve_scenario_ref(ref) == jregistry.resolve_scenario_ref(ref)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_main_body_refs_resolve_to_the_configs(k):
    config = yaml.safe_load((ROOT / "configs" / "main_body" / f"scenario_{k}.yaml").read_text())
    got = tregistry.resolve_scenario_ref(f"main_body:{k}")
    assert got["id"] == f"main_body-{k}" and got["family"] == "main_body"
    assert got["issue"] == config["scenario"]["issue"]
    assert got["agent_opinions"] == config["scenario"]["agent_opinions"]
    assert got["n_agents"] == len(config["scenario"]["agent_opinions"])


@pytest.mark.parametrize(
    "ref", ["", "aamas:9", "aamas:x", "main_body:4", "corpus:", "nope:1", "corpus:v2:missing-1"]
)
def test_bad_refs_raise_as_in_jax(ref):
    with pytest.raises((ValueError, KeyError)) as expect:
        jregistry.resolve_scenario_ref(ref)
    with pytest.raises(expect.type):
        tregistry.resolve_scenario_ref(ref)


@pytest.mark.parametrize(
    "scenario",
    [
        "aamas:3",
        {"ref": "corpus:v2:holdout-0002", "issue": "A pinned issue?"},
        {"issue": "Inline?", "agent_opinions": {"A": "yes"}},
        None,
    ],
)
def test_maybe_resolve_scenario_as_in_jax(scenario):
    assert tregistry.maybe_resolve_scenario(scenario) == jregistry.maybe_resolve_scenario(scenario)


def test_package_exports_match():
    assert sorted(tscen.__all__) == sorted(jscen.__all__)
    assert tfairness.RULES == jfairness.RULES and tfairness.BIG_SLATE == jfairness.BIG_SLATE


@functools.lru_cache(maxsize=None)
def _backends(model):
    kw = dict(model=model, dtype="float32", max_context=1024, max_batch_rows=32)
    ref = TPUBackend(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", **kw)


def _assert_table_close(got, want, path="table"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_table_close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_table_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-5, f"{path}: {got} != {want}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize(
    "model, sid, candidates",
    [
        ("tiny-gemma2", "polarized-0004", "slate"),
        ("tiny-gemma2", "sybil-0003", "slate"),
        ("tiny-llama3", "holdout-0001", "generated"),
    ],
)
def test_welfare_gap_table_matches_jax(model, sid, candidates):
    ref, port = _backends(model)
    ref_ref = f"corpus:v2:{sid}"
    kwargs = (
        {"candidates": tfairness.BIG_SLATE} if candidates == "slate"
        else {"n_candidates": 3, "max_tokens": 8, "seed": 4}
    )
    expect = jfairness.welfare_gap_table(ref, jregistry.resolve_scenario_ref(ref_ref), **kwargs)
    got = tfairness.welfare_gap_table(port, tregistry.resolve_scenario_ref(ref_ref), **kwargs)
    _assert_table_close(got, expect)
    assert got["matrix_path"] == "fused"
    assert got["n_candidates"] == (4 if candidates == "slate" else 3)
    for channel in got["channels"].values():
        assert set(channel["winners"].values()) <= set(range(got["n_candidates"]))
        assert channel["gaps"]["egalitarian_price_of_egalitarian"] == 0.0
    assert tfairness.separated_families([got]) == jfairness.separated_families([expect])


def test_experiment_on_a_corpus_ref_matches_jax(tmp_path):
    ref, port = _backends("tiny-llama3")
    config = {
        "experiment_name": "corpus_ref", "seed": 42, "num_seeds": 1,
        "scenario": {"ref": "corpus:v2:holdout-0001"},
        "models": {"generation_model": "tiny-llama3"},
        "methods_to_run": ["best_of_n", "predefined"],
        "best_of_n": {"n": 2, "max_tokens": 8, "temperature": 1.0},
        "predefined": {"predefined_statement": "A fixed statement."},
        "concurrent_execution": False,
        "deterministic_artifacts": True,
    }
    jax_exp = JaxExperiment(dict(config, output_dir=str(tmp_path / "jax")), backend=ref)
    del config["concurrent_execution"]
    exp = Experiment(dict(config, output_dir=str(tmp_path / "torch")), backend=port)
    scenario = tregistry.resolve_scenario_ref("corpus:v2:holdout-0001")
    assert (exp.issue, exp.agent_opinions) == (jax_exp.issue, jax_exp.agent_opinions)
    assert (exp.issue, exp.agent_opinions) == (scenario["issue"], scenario["agent_opinions"])
    got, expect = exp.run(), jax_exp.run()
    assert (got["error_message"] == "").all()
    assert list(got["statement"]) == list(expect["statement"])
    on_disk = yaml.safe_load((exp.run_dir / "config.yaml").read_text())
    assert on_disk["scenario"] == {"ref": "corpus:v2:holdout-0001"}
    frame = pd.read_csv(exp.run_dir / "results.csv", keep_default_na=False)
    assert list(frame["method"]) == ["best_of_n", "predefined"]
    assert list(frame["statement"]) == list(got["statement"])

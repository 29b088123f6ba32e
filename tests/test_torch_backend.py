"""The slice as a whole: TorchBackend against TPUBackend on the same weights.

The reference is ``TPUBackend(..., dtype="float32", use_flash_attention=True)``
with the classic generation and per-call scoring paths (the defaults'
shared-trunk, segmented and int8-KV generation and shared-context scoring
have their own test files); its random weights are converted
with ``params_from_jax`` into ``TorchBackend(device="cpu")``.  Tolerances:
score logprobs and best-of-N utilities 1e-4 absolute (float32 forwards
summed in different orders; the JAX side scores best-of-N through its fused
paged path).  Greedy text must match exactly, on prompts whose greedy picks
are checked to be free of near-ties (margin > 1e-3 at every step).
"""

import dataclasses
import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.experiment import Experiment as JaxExperiment
from consensus_tpu.methods.best_of_n import BestOfNGenerator as JaxBestOfN
from consensus_tpu_torch.backends import get_backend
from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.experiment import Experiment
from consensus_tpu_torch.methods.best_of_n import BestOfNGenerator
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.transformer import forward
from consensus_tpu_torch.utils import threefry

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

MODEL = "tiny-llama3"
ATOL = 1e-4
CLASSIC_PATHS = dict(
    shared_context_scoring=False, shared_trunk_generation=False,
    segmented_decode=False, kv_quant=False,
)
OPINIONS = {
    "Agent 1": "Cities should build more bike lanes.",
    "Agent 2": "Roads are for cars; bikes slow traffic.",
    "Agent 3": "Only where streets are wide enough.",
}
ISSUE = "Should the city add bike lanes?"


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(
        model=MODEL, dtype="float32", use_flash_attention=True, max_context=256,
        max_batch_rows=32, **CLASSIC_PATHS,
    )
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    port = TorchBackend(
        model=MODEL, dtype="float32", use_flash_attention=True, max_context=256,
        max_batch_rows=32, params=params, device="cpu", **CLASSIC_PATHS,
    )
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    return ref, port


def test_score_logprobs(backends):
    ref, port = backends
    requests = [
        ScoreRequest(context="Issue: bikes", continuation="Yes, build them."),
        ScoreRequest(context="Q", continuation="no", system_prompt="Be brief."),
        ScoreRequest(context="eval", continuation="A statement.", role="user"),
        ScoreRequest(context="x" * 300, continuation="Truncated context keeps this."),
        ScoreRequest(context="raw", continuation=" text", chat=False),
    ]
    expect = ref.score(requests)
    got = port.score(requests)
    for e, g in zip(expect, got):
        assert g.tokens == e.tokens
        np.testing.assert_allclose(g.logprobs, e.logprobs, atol=ATOL)
    assert port.call_counts["score_batches"] == 1


def _greedy_margins(port, request, result):
    """Top-1 minus top-2 logit at every emitted greedy step (port model)."""
    prompt = port.tokenizer.encode(port._render_prompt(request), add_bos=True)
    ids = prompt + list(result.token_ids)
    tokens = torch.tensor([ids], dtype=torch.int32)
    valid = torch.ones_like(tokens, dtype=torch.bool)
    positions = torch.arange(len(ids), dtype=torch.int32)[None]
    logits, _ = forward(port.params, port.config, tokens, positions, valid)
    steps = logits[0, len(prompt) - 1 : len(ids) - 1]
    top2 = torch.topk(steps, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


def test_greedy_generate_same_text(backends):
    ref, port = backends
    requests = [
        GenerationRequest(user_prompt=p, max_tokens=12, temperature=0.0, seed=3)
        for p in ("Write one sentence about rivers.", "Summarize: taxes.", "Hello")
    ]
    got = port.generate(requests)
    for request, result in zip(requests, got):
        assert _greedy_margins(port, request, result).min() > 1e-3, "near-tie prompt"
    expect = ref.generate(requests)
    assert [g.text for g in got] == [e.text for e in expect]
    assert [g.finish_reason for g in got] == [e.finish_reason for e in expect]


def _sampled_margins(port, request, result):
    """Top-1 minus top-2 of logits / temperature + Gumbel noise at every
    draw of a seeded sampled request (the EOS draw included): the row's key
    is the backend's fold of ("generate", seed), split once per step."""
    prompt = port.tokenizer.encode(port._render_prompt(request), add_bos=True)
    ids = prompt + list(result.token_ids)
    tokens = torch.tensor([ids], dtype=torch.int32)
    valid = torch.ones_like(tokens, dtype=torch.bool)
    positions = torch.arange(len(ids), dtype=torch.int32)[None]
    logits, _ = forward(port.params, port.config, tokens, positions, valid)
    n_draws = len(result.token_ids) + (result.finish_reason == "stop")
    if n_draws > len(result.token_ids):  # the EOS draw reads the last position
        steps = logits[0, len(prompt) - 1 : len(ids)]
    else:
        steps = logits[0, len(prompt) - 1 : len(ids) - 1]
    key = port._fold_seed("generate", request.seed)
    margins = []
    for row in steps:
        key, sub = threefry.split(key)
        scores = row / request.temperature + threefry.gumbel(sub, row.shape)
        top2 = torch.topk(scores, 2).values
        margins.append(float(top2[0] - top2[1]))
    return np.asarray(margins)


def test_sampled_generate_same_text(backends):
    """Seeded sampling at temperature 1: the port's threefry keys draw the
    reference's tokens, on prompts whose every draw has margin > 1e-3."""
    ref, port = backends
    requests = [
        GenerationRequest(user_prompt=p, max_tokens=12, temperature=1.0, seed=seed)
        for p, seed in (("Write one sentence about rivers.", 5), ("Summarize: taxes.", 11), ("Hello", 2))
    ]
    got = port.generate(requests)
    for request, result in zip(requests, got):
        assert _sampled_margins(port, request, result).min() > 1e-3, "near-tie draw"
    expect = ref.generate(requests)
    assert [g.text for g in got] == [e.text for e in expect]
    assert [g.token_ids for g in got] == [e.token_ids for e in expect]
    assert [g.finish_reason for g in got] == [e.finish_reason for e in expect]


def test_best_of_n_utility_matrix(backends):
    ref, port = backends
    candidates = ["We agree on safe streets.", "Bikes everywhere!", "Roads first, then lanes."]
    expect = JaxBestOfN(ref, {"n": 3}).score_candidates(ISSUE, OPINIONS, candidates)
    got = BestOfNGenerator(port, {"n": 3}).score_candidates(ISSUE, OPINIONS, candidates)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, expect, atol=ATOL)
    assert int(np.argmax(got.min(axis=1))) == int(np.argmax(np.asarray(expect).min(axis=1)))


def test_experiment_results_csv(backends, tmp_path):
    ref, port = backends
    config = {
        "experiment_name": "parity",
        "seed": 7,
        "num_seeds": 1,
        "scenario": {"issue": ISSUE, "agent_opinions": OPINIONS},
        "concurrent_execution": False,
        "deterministic_artifacts": True,
        "methods_to_run": ["best_of_n", "zero_shot", "predefined"],
        "best_of_n": {"n": 2, "max_tokens": 6, "temperature": 0.0},
        "zero_shot": {"max_tokens": 6, "temperature": 0.0},
        "predefined": {"predefined_statement": "A fixed statement."},
    }
    jax_frame = JaxExperiment(dict(config, output_dir=str(tmp_path / "jax")), backend=ref).run()
    port_config = dict(config, output_dir=str(tmp_path / "torch"))
    port_config.pop("concurrent_execution")
    experiment = Experiment(port_config, backend=port)
    frame = experiment.run()
    on_disk = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    assert list(on_disk.columns) == list(jax_frame.columns)
    assert list(frame["method"]) == list(jax_frame["method"])
    assert list(frame["seed"]) == list(jax_frame["seed"])
    assert (frame["error_message"] == "").all()
    assert frame.loc[frame.method == "predefined", "statement"].item() == "A fixed statement."
    assert list(frame["statement"]) == list(jax_frame["statement"])


def test_degraded_rows_carry_budget_spent(backends, tmp_path):
    """A brownout-scaled run (``budget_scale``) writes ``degraded``,
    ``degraded_reason`` and ``budget_spent`` as the JAX engine does."""
    ref, port = backends
    config = {
        "experiment_name": "degraded", "seed": 7, "num_seeds": 1,
        "scenario": {"issue": ISSUE, "agent_opinions": OPINIONS},
        "deterministic_artifacts": True,
        "methods_to_run": ["best_of_n", "predefined"],
        "best_of_n": {"n": 4, "max_tokens": 6, "temperature": 0.0, "budget_scale": 0.5},
        "predefined": {"predefined_statement": "A fixed statement."},
    }
    jax_run = JaxExperiment(dict(config, output_dir=str(tmp_path / "jax"), concurrent_execution=False),
                            backend=ref)
    jax_run.run()
    experiment = Experiment(dict(config, output_dir=str(tmp_path / "torch")), backend=port)
    experiment.run()
    got = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    expect = pd.read_csv(jax_run.run_dir / "results.csv", keep_default_na=False)
    assert list(got.columns) == list(expect.columns)
    assert "budget_spent" in got.columns
    for column in ("method", "statement", "degraded", "degraded_reason", "budget_spent"):
        assert list(got[column]) == list(expect[column]), column
    spent = json.loads(got.loc[got.method == "best_of_n", "budget_spent"].item())
    assert spent["n_used"] == 2 and spent["n_planned"] == 4
    assert got.loc[got.method == "predefined", "budget_spent"].item() == ""


def test_get_backend_tpu_is_the_resident_backend():
    backend = get_backend("tpu", model=MODEL, device="cpu", max_context=128)
    assert isinstance(backend, TorchBackend) and backend.model_name == MODEL
    assert backend.max_context == 128 and backend.device.type == "cpu"
    spec = {"name": "tpu", "model": MODEL, "device": "cpu", "dtype": "float32"}
    assert isinstance(get_backend(spec), TorchBackend)
    assert get_backend(backend) is backend
    assert type(get_backend("fake")).__name__ == "FakeBackend"
    # The API judge builds lazily, as the JAX package's: with no client it
    # answers with the reference's error sentinel.
    from consensus_tpu.backends import get_backend as jax_get_backend

    judge, jax_judge = get_backend("openai"), jax_get_backend("openai")
    assert type(judge).__name__ == type(jax_judge).__name__ == "OpenAIBackend"
    request = GenerationRequest(user_prompt="Rank these.", max_tokens=4)
    assert judge.generate([request])[0].text == jax_judge.generate([request])[0].text
    with pytest.raises(ValueError, match="resident"):
        get_backend("nope")


@pytest.mark.parametrize(
    "option, value",
    [("tp", 2), ("dp", 2), ("mesh", "dp=1,tp=2"), ("checkpoint", "weights/"),
     ("quantize_frozen_kv", True)],
)
def test_unported_options_raise(option, value, tmp_path, monkeypatch):
    """tp (``tp=2`` or a mesh with tp > 1) is ported: the model runs
    tensor-parallel over two CPU ranks and gives tp=1's tokens, and its
    KV identity carries the width.  dp is
    ported: ``dp=2`` over two CPU shards gives dp=1's tokens and
    logprobs, as the JAX backend's ``dp=2`` gives its own.  ``checkpoint``
    and ``quantize_frozen_kv`` are ported: the checkpoint (an HF safetensors
    directory at the relative path ``weights/``) loads the params the JAX
    backend loads from it, and ``quantize_frozen_kv`` is the alias of
    ``kv_quant`` in both."""
    if option in ("tp", "mesh"):
        one = TorchBackend(model=MODEL, device="cpu", dtype="float32")
        port = TorchBackend(model=MODEL, device="cpu", dtype="float32", params=one.params,
                            **{option: value})
        assert port._tp == 2 and port.kv_cache_identity()[-1] == ("tp", 2)
        requests = [GenerationRequest(user_prompt=f"Say {i}", max_tokens=6, seed=i)
                    for i in range(3)]
        assert ([r.token_ids for r in port.generate(requests)]
                == [r.token_ids for r in one.generate(requests)])
        return
    if option == "dp":
        one = TorchBackend(model=MODEL, device="cpu", dtype="float32")
        port = TorchBackend(model=MODEL, device="cpu", dtype="float32", params=one.params,
                            dp=value)
        assert port.mesh_plan.dp == value
        ref = TPUBackend(model=MODEL, dp=value)
        assert ref.mesh_plan.dp == value
        requests = [GenerationRequest(user_prompt=f"Say {i}", max_tokens=6, seed=i)
                    for i in range(3)]
        assert ([r.token_ids for r in port.generate(requests)]
                == [r.token_ids for r in one.generate(requests)])
        scores = [ScoreRequest(context="c", continuation=f"w {i}") for i in range(3)]
        for a, b in zip(port.score(scores), one.score(scores)):
            np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-6)
        return
    if option == "quantize_frozen_kv":
        for alias in (True, False):
            for kv_quant in (True, False):
                options = {"quantize_frozen_kv": alias, "kv_quant": kv_quant}
                port = TorchBackend(model=MODEL, device="cpu", **options)
                assert port.kv_quant == TPUBackend(model=MODEL, **options).kv_quant == alias
        return
    from consensus_tpu.models.transformer import init_params as jax_init_params
    from tests.test_loader import _export_hf
    from tests.test_torch_loader import assert_params_equal

    monkeypatch.chdir(tmp_path)
    ref_config = TPUBackend(model=MODEL).config
    _export_hf(jax_init_params(ref_config, jax.random.PRNGKey(3)), ref_config,
               tmp_path / value, shards=2)
    port = TorchBackend(model=MODEL, device="cpu", **{option: value})
    ref = TPUBackend(model=MODEL, **{option: value})
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert_params_equal(port.params, params_from_jax(jax.tree.map(np.asarray, ref.params),
                                                     ref.config))


def test_row_buckets_stay_fixed_while_free_memory_changes(monkeypatch):
    """On the card the decode budget is read once, beside the resident
    weights (``tpu.py:728-731``'s fixed ``_HBM_BYTES - params``): what
    another tenant holds later moves no row bucket; live sessions do."""
    from consensus_tpu_torch.backends import torch_backend

    gib = 1024**3
    free = {"bytes": 40 * gib}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free["bytes"], 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    backend = TorchBackend(model=MODEL, device="cpu", dtype="float32")
    # The card's route of the budget reads, as the constructor takes it on
    # a CUDA device once the weights are resident.
    backend.device = torch.device("cuda")
    backend._device_budget = backend._free_device_bytes()
    row_bytes = gib // 2

    def rows():
        return (backend._generate_rows_allowed(1024, 256),
                backend._segmented_rows_allowed(1024, 512, 128),
                backend._rows_for(row_bytes))

    before = rows()
    assert before[2] == 64  # (40 - 3) GiB / 0.5 GiB = 74 rows -> the ladder's 64
    for other_tenants in (30 * gib, 2 * gib, 60 * gib):
        free["bytes"] = other_tenants
        assert rows() == before
    assert backend._session_budget.cap == 8 * gib
    backend._session_budget.acquire(8 * gib)  # a live search session's cache
    try:
        assert backend._rows_for(row_bytes) == 48  # (40 - 3 - 8) / 0.5 = 58 -> 48
    finally:
        backend._session_budget.release(8 * gib)
    assert rows() == before


def test_unported_mesh_and_default_device():
    """tp=2 on the CPU builds the tensor-parallel backend over two CPU
    ranks (queue A15, ported); a tp that does not divide the query columns
    raises naming ``n_heads*head_dim``, as the JAX package's sharding does."""
    backend = TorchBackend(model=MODEL, device="cpu", tp=2)
    assert backend._tp == 2 and backend.mesh.devices == ((torch.device("cpu"),) * 2,)
    with pytest.raises(ValueError, match=r"n_heads\*head_dim="):
        TorchBackend(model=MODEL, device="cpu", tp=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchBackend(model=MODEL)


@pytest.mark.parametrize("key, item", [("engine", "A8"), ("fault_plan", "faults"),
                                       ("supervisor", "supervisor")])
def test_experiment_refuses_unported_keys(tmp_path, key, item):
    """The three keys build their stacks now, as in the JAX engine:
    ``fault_plan`` / ``supervisor`` wrap the backend in
    ``supervisor(faults(backend))``; ``engine`` runs the decode engine,
    whose speculative windows (queue A8) build too."""
    value = {"seed": 1} if key == "fault_plan" else True
    experiment = Experiment({key: value, "output_dir": str(tmp_path)}, backend=get_backend("fake"))
    if key == "engine":
        from consensus_tpu_torch.backends.engine import DecodeEngine

        engine = DecodeEngine(experiment.backend, speculative=True, auto_start=False)
        try:
            assert engine.speculative and engine.decode_steps == 4
            assert engine.stats()["speculative"]["enabled"] is True
        finally:
            engine.close()
        return
    layer = experiment.backend if key == "supervisor" else experiment.backend.inner
    assert type(layer).__module__ == f"consensus_tpu_torch.backends.{item}"

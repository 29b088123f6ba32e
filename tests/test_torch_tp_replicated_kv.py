"""Tensor parallelism with a tp that does not divide the kv heads: each rank
holds copies of the kv heads its query heads read
(``consensus_tpu_torch/parallel/tensor.py::kv_heads_of_rank``), where the
JAX package drops the ``model`` axis on the kv heads and lets GSPMD gather
K and V.  The same numpy-seeded inputs (JAX weights from ``PRNGKey(0)`` in
float32 through ``params_from_jax``) go through the JAX package on its 8
virtual CPU devices and through the port on ``cpu`` ranks:

* tiny-llama3 and tiny-gemma2 (4 q / 2 kv heads) at tp=4 and dp=2 x tp=4:
  ``token_logprobs`` within atol 2e-4 of JAX under ``make_mesh(tp=4)``;
  ``TorchBackend(tp=4)`` against ``TPUBackend(tp=4)``: seeded generation
  ids equal where every draw's top-two margin is above 1e-3, and the paged
  K-step stream's; a beam session's advances against tp=1's;
* the straddling case, tiny-llama3 with 6 q / 3 kv heads at tp=2 (rank 0
  reads kv heads 0, 0, 1), against JAX's forward under ``make_mesh(tp=2)``;
* the tp=4 train step against ``jax.grad`` on one device (relative 1e-4),
  and the copies of a shared head equal after an AdamW step;
* the sharded restore straight into the ranks, bit-equal to slicing the
  whole tree, and the gather back to it;
* the per-card KV accounting: each rank's kv heads, against the JAX
  package's ``n_kv_heads / tp`` figure (``tpu.py:456-457``)."""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.backends.base import GenerationRequest as JaxGenerationRequest
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.models import stepper as jax_stepper
from consensus_tpu.models.config import get_model_config as jax_get_model_config
from consensus_tpu.models.transformer import init_params as jax_init_params
from consensus_tpu.models.transformer import token_logprobs as jax_token_logprobs
from consensus_tpu.parallel import lm_loss as jax_lm_loss
from consensus_tpu.parallel import make_mesh as jax_make_mesh
from consensus_tpu.parallel import shard_batch as jax_shard_batch
from consensus_tpu.parallel import shard_params as jax_shard_params
from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.backends.session import SearchSpec
from consensus_tpu_torch.backends.torch_backend import TorchBackend, _kv_heads_per_card
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.quant import QTensor, quantize_params
from consensus_tpu_torch.models.transformer import make_cache, token_logprobs
from consensus_tpu_torch.parallel import (
    TPParams,
    init_train_state,
    kv_heads_of_rank,
    local_config,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
    tp_group,
    tp_params,
    train_step,
    unshard_params,
)
from consensus_tpu_torch.parallel.train import _leaves, shard_grads
from consensus_tpu_torch.utils.checkpoint import restore_params, save_params
from tests.test_torch_loader import assert_params_equal
from tests.test_torch_tp_backend import _margins

torch.set_num_threads(1)

ATOL = 2e-4
TIE_MARGIN = 1e-3
GRAD_RTOL = 1e-4
TINY_MODELS = ["tiny-llama3", "tiny-gemma2"]
OPTIONS = dict(dtype="float32", max_context=128, base_seed=3)
PROMPTS = ("Write one sentence about rivers.", "Summarize: taxes.", "Hello")


def _port(jax_params, config):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), config)


@pytest.fixture(scope="module", params=TINY_MODELS)
def scoring_case(request):
    """The model, its JAX and port params, an (8, 16) token batch and JAX's
    logprobs under its tp=4 mesh (dp=2 over the 8 virtual devices)."""
    cfg = jax_get_model_config(request.param)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab_size, jnp.int32)
    valid = jnp.ones((8, 16), jnp.bool_)
    plan = jax_make_mesh(tp=4)
    expected = np.asarray(jax_token_logprobs(jax_shard_params(params, plan.mesh), cfg,
                                             *jax_shard_batch(plan.mesh, tokens, valid)))
    return (get_model_config(request.param), _port(params, cfg),
            torch.from_numpy(np.array(tokens)), torch.from_numpy(np.array(valid)), expected)


@pytest.mark.parametrize("plan", ["tp4", "dp2_tp4"])
def test_scoring_matches_jax_tp4_mesh(scoring_case, plan):
    config, params, tokens, valid, expected = scoring_case
    assert config.n_kv_heads == 2 and local_config(config, 4).n_kv_heads == 1
    if plan == "tp4":
        got = token_logprobs(tp_params(params, config, ["cpu"] * 4), config, tokens, valid)
    else:
        mesh = make_mesh(["cpu"] * 8, tp=4)
        trees = shard_params(params, mesh, config)
        got = torch.cat([
            token_logprobs(tp_group(trees[d], mesh.devices[d], config), config, t, v)
            for d, (t, v) in enumerate(zip(*shard_batch(mesh, tokens, valid)))
        ])
    np.testing.assert_allclose(got.numpy(), expected, atol=ATOL)


def test_each_rank_holds_copies_of_its_kv_heads(scoring_case):
    """Ranks 0-1 hold kv head 0's ``wk``/``wv`` columns, ranks 2-3 head 1's,
    each a copy of its own (no view of the whole tensor or of a neighbour)."""
    config, params, *_ = scoring_case
    sharded = tp_params(params, config, ["cpu"] * 4)
    hd = config.head_dim
    for key in ("wk", "wv"):
        whole = params["layers"][0][key]
        for t, tree in enumerate(sharded.ranks):
            (head,) = kv_heads_of_rank(config, 4, t)
            part = tree["layers"][0][key]
            assert head == t // 2 and part.shape == (config.d_model, hd)
            assert torch.equal(part, whole[:, head * hd:(head + 1) * hd])
        ptrs = {tree["layers"][0][key].data_ptr() for tree in sharded.ranks}
        assert len(ptrs) == 4 and whole.data_ptr() not in ptrs


def test_straddling_query_heads_match_jax_tp2():
    """6 q / 3 kv heads at tp=2: a rank's 3 query heads straddle two groups,
    so each rank holds one kv copy per query head (rank 0: 0, 0, 1; rank
    1: 1, 2, 2) and runs plain multi-head attention."""
    overrides = dict(n_layers=2, n_heads=6, n_kv_heads=3)
    jcfg = jax_get_model_config("tiny-llama3", **overrides)
    config = get_model_config("tiny-llama3", **overrides)
    assert [kv_heads_of_rank(config, 2, t) for t in range(2)] == [(0, 0, 1), (1, 2, 2)]
    assert local_config(config, 2).n_kv_heads == 3 and local_config(config, 2).n_heads == 3
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, jcfg.vocab_size, jnp.int32)
    valid = jnp.asarray(np.arange(16)[None, :] >= np.array([0, 3, 0, 5, 1, 0, 7, 2])[:, None])
    plan = jax_make_mesh(tp=2)
    expected = np.asarray(jax_token_logprobs(jax_shard_params(params, plan.mesh), jcfg,
                                             *jax_shard_batch(plan.mesh, tokens, valid)))
    one = np.asarray(jax_token_logprobs(params, jcfg, tokens, valid))
    np.testing.assert_allclose(expected, one, atol=1e-5)
    port = _port(params, jcfg)
    got = token_logprobs(tp_params(port, config, ["cpu"] * 2), config,
                         torch.from_numpy(np.array(tokens)), torch.from_numpy(np.array(valid)))
    np.testing.assert_allclose(got.numpy(), expected, atol=ATOL)
    assert np.isfinite(got.numpy()).all()


# ---------------------------------------------------------------------------
# TorchBackend(tp=4) against TPUBackend(tp=4)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backends():
    """(JAX tp=4, port tp=1, port tp=4) on the JAX backend's weights."""
    ref = TPUBackend(model="tiny-llama3", tp=4, **OPTIONS)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    one = TorchBackend(model="tiny-llama3", params=params, device="cpu", **OPTIONS)
    four = TorchBackend(model="tiny-llama3", params=params, device="cpu", tp=4, **OPTIONS)
    assert isinstance(four.params, TPParams) and four.params.kv_heads == 1
    assert dataclasses.asdict(four.config) == dataclasses.asdict(ref.config)
    return ref, one, four


def test_tiny_llama3_tp4_builds_and_holds_one_kv_head_per_rank(backends):
    _, _, four = backends
    assert four._tp == 4 and four.config.vocab_size == 268
    cache = make_cache(four.config, 2, 8, torch.float32, "cpu", params=four.params)
    assert [tuple(p.shape) for p in cache.k.parts] == [
        (four.config.n_layers, 2, 8, 1, four.config.head_dim)] * 4


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_matches_tpu_backend_tp4(backends, temperature):
    ref, one, four = backends
    requests = [GenerationRequest(user_prompt=p, max_tokens=10, temperature=temperature,
                                  seed=seed) for seed, p in enumerate(PROMPTS)]
    got = four.generate(requests)
    expect = ref.generate([JaxGenerationRequest(user_prompt=p, max_tokens=10,
                                                temperature=temperature, seed=seed)
                           for seed, p in enumerate(PROMPTS)])
    tp1 = one.generate(requests)
    checked = 0
    for request, g, e, o in zip(requests, got, expect, tp1):
        if _margins(one, request, o).min() > TIE_MARGIN:
            assert g.token_ids == e.token_ids == o.token_ids
            checked += 1
    assert checked >= 1, "every request holds a near-tie draw"


def _settled_lengths(prefill_chunk):
    """JAX ``paged_prefill_chunk`` handed a NumPy copy of ``lengths``: the
    stream rewrites one NumPy buffer chunk after chunk, which a CPU array
    may alias (``test_torch_paged_stream._with_settled_lengths``)."""
    def call(params, config, tokens, valid, state, tables, lengths, *args, **kwargs):
        return prefill_chunk(params, config, tokens, valid, state, tables,
                             jnp.asarray(np.array(lengths, copy=True)), *args, **kwargs)
    return call


def _drain(stream):
    results = {}
    while not stream.finished:
        stream.dispatch()
        results.update(stream.collect()[1])
    stream.close()
    return [results[i].token_ids for i in range(len(results))]


def test_paged_stream_matches_tpu_backend_tp4(backends, monkeypatch):
    ref, one, four = backends
    cohort = [(p, seed, 8 + 4 * seed, 0.8) for seed, p in enumerate(PROMPTS)]
    port = [GenerationRequest(user_prompt=p, seed=s, max_tokens=m, temperature=t)
            for p, s, m, t in cohort]
    monkeypatch.setattr(jax_stepper, "paged_prefill_chunk",
                        _settled_lengths(jax_stepper.paged_prefill_chunk))
    expect = _drain(ref.generate_stream(
        [JaxGenerationRequest(user_prompt=p, seed=s, max_tokens=m, temperature=t)
         for p, s, m, t in cohort], decode_steps=4))
    got = _drain(four.generate_stream(port, decode_steps=4))
    tp1 = _drain(one.generate_stream(port, decode_steps=4))
    assert got == tp1
    checked = 0
    for request, g, e, o in zip(port, got, expect, one.generate(port)):
        if o.token_ids == g and _margins(one, request, o).min() > TIE_MARGIN:
            assert g == e
            checked += 1
    assert checked >= 1, "every request holds a near-tie draw"


def test_beam_session_advances_match_tp1(backends):
    _, one, four = backends
    spec = SearchSpec(ref_system=None, ref_user="Write a joint statement.",
                      agent_prompts=((None, "I want more trains."), (None, "I want cheaper cars.")),
                      k=3, seed=5, n_slots=2, max_steps=8)
    a, b = one.open_fused_token_search(spec), four.open_fused_token_search(spec)
    try:
        pa, pb = a.propose(), b.propose()
        for _ in range(4):
            assert [[c.token_id for c in r] for r in pa] == [[c.token_id for c in r] for r in pb]
            for ra, rb in zip(pa, pb):
                np.testing.assert_allclose([c.ref_logprob for c in rb],
                                           [c.ref_logprob for c in ra], atol=ATOL)
                np.testing.assert_allclose([c.agent_logprobs for c in rb],
                                           [c.agent_logprobs for c in ra], atol=ATOL)
            parents, chosen = [1, 0], [pa[1][0], pa[0][1]]
            pa, pb = a.advance_and_propose(parents, chosen), b.advance_and_propose(parents, chosen)
    finally:
        a.close()
        b.close()


def test_engine_through_create_server_at_tp4():
    """``create_server(mesh="dp=1,tp=4")`` on tiny-llama3: the engine runs
    the paged programs on 4 ranks of one kv head each and answers as the
    same server at tp=1 does."""
    from consensus_tpu_torch.obs.metrics import Registry
    from consensus_tpu_torch.serve import create_server

    payload = {"issue": "Should the town build a new library?",
               "agent_opinions": {"A": "Yes, for the children.", "B": "No, taxes are high."},
               "method": "best_of_n", "params": {"n": 2, "max_tokens": 8}, "seed": 7}
    out = {}
    for mesh in ("dp=1,tp=1", "dp=1,tp=4"):
        server = create_server(backend="torch", port=0, registry=Registry(), mesh=mesh,
                               backend_options={"model": "tiny-llama3", "device": "cpu",
                                                "dtype": "float32", "max_context": 256}).start()
        try:
            request = urllib.request.Request(
                server.base_url + "/v1/consensus", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=120) as response:
                body = json.loads(response.read())
            with urllib.request.urlopen(server.base_url + "/healthz", timeout=30) as response:
                health = json.loads(response.read())
        finally:
            server.stop()
        out[mesh] = (body["statement"], health["engine"]["mesh"]["tp"])
    assert out["dp=1,tp=4"] == (out["dp=1,tp=1"][0], 4)


# ---------------------------------------------------------------------------
# Train step, sharded restore, KV accounting
# ---------------------------------------------------------------------------


def _port_keys(params):
    keys = []
    for name, value in params.items():
        if name == "layers":
            keys += [f"layers.{i}.{key}" for i, layer in enumerate(value) for key in layer]
        else:
            keys.append(name)
    return keys


def test_tp4_train_step_matches_jax_grad_and_keeps_copies_equal():
    """Each copy of a shared head is a slice of the master leaf, so the
    master's columns get the sum of the copies' gradients: the first step's gradients equal ``jax.grad`` on one
    device, and after an AdamW step the ranks that share a head hold equal
    ``wk``/``wv`` columns."""
    config = jax_get_model_config("tiny-gemma2", n_layers=2)
    jax_params = jax_init_params(config, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, config.vocab_size, (4, 16)).astype(np.int32)
    valid = np.arange(16)[None, :] < rng.integers(8, 17, 4)[:, None]
    want = jax.grad(jax_lm_loss)(jax_params, config, jnp.asarray(tokens), jnp.asarray(valid))
    want_loss = float(jax_lm_loss(jax_params, config, jnp.asarray(tokens), jnp.asarray(valid)))
    port_config = get_model_config("tiny-gemma2", n_layers=2)
    params, state, optimizer = init_train_state(_port(jax_params, config), learning_rate=1e-3)
    plan = make_mesh(["cpu"] * 4, tp=4)
    loss, grads = shard_grads(params, port_config, torch.from_numpy(tokens),
                              torch.from_numpy(valid), plan)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    flat = {"embed": np.asarray(want["embed"]), "final_norm": np.asarray(want["final_norm"])}
    for key, value in want["layers"].items():
        for i in range(value.shape[0]):
            flat[f"layers.{i}.{key}"] = np.asarray(value[i])
    for key, got in zip(_port_keys(params), grads):
        rel = np.linalg.norm(got.numpy() - flat[key]) / max(np.linalg.norm(flat[key]), 1e-12)
        assert rel < GRAD_RTOL, (key, rel)
    train_step(params, state, port_config, optimizer, torch.from_numpy(tokens),
               torch.from_numpy(valid), plan=plan)
    with torch.no_grad():
        ranks = shard_params(params, plan, port_config)[0]
    for layer in range(port_config.n_layers):
        for key in ("wk", "wv"):
            for a, b in ((0, 1), (2, 3)):
                assert torch.equal(ranks[a]["layers"][layer][key], ranks[b]["layers"][layer][key])
            assert not torch.equal(ranks[0]["layers"][layer][key], ranks[2]["layers"][layer][key])
    assert all(leaf.grad is None for leaf in _leaves(params))


@pytest.mark.parametrize("model, overrides, tp, int8", [
    ("tiny-llama3", {}, 4, False), ("tiny-gemma2", {}, 4, True),
    ("tiny-llama3", dict(n_heads=6, n_kv_heads=3), 2, True),
])
def test_sharded_restore_into_replicated_ranks(tmp_path, model, overrides, tp, int8):
    """``restore_params(shardings=param_shardings(..., config))`` reads each
    rank's kv-head columns (a slice, or a column list where heads straddle)
    straight from the file: bit-equal to ``shard_params`` of the whole tree,
    and ``unshard_params`` takes one copy of each head back to it."""
    config = get_model_config(model, **overrides)
    jcfg = jax_get_model_config(model, **overrides)
    params = _port(jax_init_params(jcfg, jax.random.PRNGKey(0)), jcfg)
    if int8:
        params = quantize_params(params)
    save_params(str(tmp_path), params)
    plan = make_mesh(["cpu"] * (2 * tp), tp=tp)
    trees = restore_params(str(tmp_path), template=params,
                           shardings=param_shardings(params, plan, config))
    want = shard_params(params, plan, config)
    for d in range(plan.dp):
        for t in range(tp):
            assert_params_equal(trees[d][t], want[d][t])
    wk = trees[0][0]["layers"][0]["wk"]
    assert (wk.q if int8 else wk).shape[-1] == local_config(config, tp).n_kv_heads * config.head_dim
    assert isinstance(wk, QTensor) == int8
    assert_params_equal(unshard_params(trees[0], config), params)


def test_per_card_kv_bytes_follow_the_local_kv_heads(backends):
    """At tp=4 on tiny-llama3 (2 kv heads) every rank holds one kv head, so
    a rank's card holds 2x the JAX package's ``n_kv_heads / tp`` figure
    (``tpu.py:456-457``, which divides by tp although the heads
    replicate); the row buckets, session budgets and page pools count what
    the rank holds.  A card that holds several ranks holds each one's."""
    _, one, four = backends
    c = four.config
    itemsize = 4
    jax_figure = 2 * c.n_layers * c.n_kv_heads * c.head_dim * itemsize // 4
    factor = 4 * local_config(c, 4).n_kv_heads // c.n_kv_heads
    assert factor == 2 and four._kv_heads_per_card == 1
    assert four._kv_bytes_per_column() == jax_figure * factor == 2 * c.n_layers * c.head_dim * 4
    assert one._kv_bytes_per_column() == 2 * c.n_layers * c.n_kv_heads * c.head_dim * 4
    cache = make_cache(c, 3, 16, torch.float32, "cpu", params=four.params)
    per_rank = [p.numel() * p.element_size() * 2 for p in cache.k.parts]
    assert per_rank == [3 * 16 * four._kv_bytes_per_column()] * 4
    per_token = int(2 * c.n_layers * four._kv_heads_per_card * c.head_dim
                    * (1.25 if four.kv_quant else itemsize))
    assert four.suggest_kv_page_pool(16) == max(
        64, (four._session_budget.cap // 2) // (per_token * 16))
    gemma = get_model_config("gemma2-2b")
    assert _kv_heads_per_card(gemma, [torch.device("cuda", 0)] * 8) == 8
    assert _kv_heads_per_card(gemma, [torch.device("cuda", i // 2) for i in range(8)]) == 2
    assert _kv_heads_per_card(gemma, [torch.device("cuda", i) for i in range(8)]) == 1
    assert _kv_heads_per_card(gemma, [torch.device("cuda", i) for i in range(2)]) == 2
    llama = get_model_config("llama3-8b")
    assert (local_config(llama, 16).n_heads, local_config(llama, 16).n_kv_heads) == (2, 1)

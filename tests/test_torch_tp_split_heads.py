"""Tensor parallelism with a tp that cuts a query head: rank t owns columns
``[t * C, (t + 1) * C)`` of the flattened ``n_heads * head_dim`` (the JAX
package's ``wq`` columns and ``wo`` rows), holds whole copies of the query
heads that range touches and of the kv heads those read
(``consensus_tpu_torch/parallel/tensor.py::q_heads_of_rank``), computes
their attention in full and keeps its own C columns
(``q_columns_of_rank``) for its slice of ``wo`` rows, where GSPMD splits
the columns evenly.  The same numpy-seeded inputs (JAX weights from
``PRNGKey(0)`` in float32 through ``params_from_jax``) go through the JAX
package on its 8 virtual CPU devices and through the port on ``cpu`` ranks:

* tiny-llama3 and tiny-gemma2 (4 q / 2 kv heads, hd 16) at tp=8, half a
  head a rank, and at dp=1 x tp=8: ``token_logprobs`` within atol 2e-4 of
  JAX under ``make_mesh(tp=8)``;
* the straddling 6 q / 3 kv heads at tp=4 (1.5 heads a rank) and at tp=8
  (a rank's columns touch one head or two), within atol 2e-4 of JAX;
* ``TorchBackend(tp=4)`` against ``TPUBackend(tp=4)`` on tiny-llama3 with
  2 q / 1 kv heads at head_dim 32 (half a head a rank; the byte
  tokenizer's vocab of 268 rules out tp=8): seeded generation ids equal
  where every draw's top-two margin is above 1e-3, scores within atol
  2e-4, the paged stream's ids; a beam session against tp=1 and
  ``create_server(mesh="dp=1,tp=4")``;
* the tp=4 train step against ``jax.grad`` on one device (relative 1e-4),
  and the shared ``wq`` copies equal after an AdamW step;
* the sharded restore straight into the ranks and ``unshard_params`` back;
* the per-card KV bytes;
* ``check_tp`` accepts and refuses the same (model, tp) as the JAX
  package's ``param_shardings``."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from consensus_tpu.backends.base import GenerationRequest as JaxGenerationRequest
from consensus_tpu.backends.base import ScoreRequest as JaxScoreRequest
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.models import stepper as jax_stepper
from consensus_tpu.models.config import get_model_config as jax_get_model_config
from consensus_tpu.models.transformer import init_params as jax_init_params
from consensus_tpu.models.transformer import token_logprobs as jax_token_logprobs
from consensus_tpu.parallel import lm_loss as jax_lm_loss
from consensus_tpu.parallel import make_mesh as jax_make_mesh
from consensus_tpu.parallel import param_shardings as jax_param_shardings
from consensus_tpu.parallel import shard_batch as jax_shard_batch
from consensus_tpu.parallel import shard_params as jax_shard_params
from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
from consensus_tpu_torch.backends.session import SearchSpec
from consensus_tpu_torch.backends.torch_backend import TorchBackend, _kv_heads_per_card
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.quant import quantize_params
from consensus_tpu_torch.models.transformer import make_cache, token_logprobs
from consensus_tpu_torch.parallel import (
    TPParams,
    check_tp,
    init_train_state,
    kv_heads_of_rank,
    local_config,
    make_mesh,
    param_shardings,
    q_columns_of_rank,
    q_heads_of_rank,
    shard_params,
    tp_group,
    tp_params,
    train_step,
    unshard_params,
)
from consensus_tpu_torch.parallel.tensor import rank_views
from consensus_tpu_torch.parallel.train import _leaves, shard_grads
from consensus_tpu_torch.utils.checkpoint import restore_params, save_params
from tests.test_torch_loader import assert_params_equal
from tests.test_torch_tp_backend import _margins
from tests.test_torch_tp_replicated_kv import _drain, _port, _port_keys, _settled_lengths

torch.set_num_threads(1)

ATOL = 2e-4
TIE_MARGIN = 1e-3
GRAD_RTOL = 1e-4
TINY_MODELS = ["tiny-llama3", "tiny-gemma2"]
STRADDLE = dict(n_layers=2, n_heads=6, n_kv_heads=3)
#: Half a head a rank at tp=4 with the byte tokenizer's vocab of 268.
HALF_HEAD = dict(n_heads=2, n_kv_heads=1, head_dim=32)
OPTIONS = dict(dtype="float32", max_context=128, base_seed=3)
PROMPTS = ("Write one sentence about rivers.", "Summarize: taxes.", "Hello")


def _jax_expected(jcfg, tp, valid=None):
    """(JAX params, tokens, valid, JAX logprobs under ``make_mesh(tp)``)."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, jcfg.vocab_size, jnp.int32)
    valid = jnp.ones((8, 16), jnp.bool_) if valid is None else jnp.asarray(valid)
    plan = jax_make_mesh(tp=tp)
    expected = np.asarray(jax_token_logprobs(jax_shard_params(params, plan.mesh), jcfg,
                                             *jax_shard_batch(plan.mesh, tokens, valid)))
    return params, torch.from_numpy(np.array(tokens)), torch.from_numpy(np.array(valid)), expected


@pytest.fixture(scope="module", params=TINY_MODELS)
def scoring_case(request):
    """The model, its port params, an (8, 16) token batch and JAX's
    logprobs under its tp=8 mesh."""
    jcfg = jax_get_model_config(request.param)
    params, tokens, valid, expected = _jax_expected(jcfg, 8)
    return get_model_config(request.param), _port(params, jcfg), tokens, valid, expected


@pytest.mark.parametrize("plan", ["tp8", "dp1_tp8"])
def test_scoring_matches_jax_tp8_mesh(scoring_case, plan):
    """Half a head a rank: atol 2e-4 against JAX's tp=8 forward."""
    config, params, tokens, valid, expected = scoring_case
    assert (local_config(config, 8).n_heads, local_config(config, 8).n_kv_heads) == (1, 1)
    if plan == "tp8":
        got = token_logprobs(tp_params(params, config, ["cpu"] * 8), config, tokens, valid)
    else:
        mesh = make_mesh(["cpu"] * 8, tp=8, dp=1)
        assert (mesh.dp, mesh.tp) == (1, 8)
        got = token_logprobs(tp_group(shard_params(params, mesh, config)[0], mesh.devices[0],
                                      config), config, tokens, valid)
    np.testing.assert_allclose(got.numpy(), expected, atol=ATOL)


def test_each_rank_holds_a_copy_of_its_query_head(scoring_case):
    """At tp=8 ranks 2h and 2h+1 both hold query head h's whole ``wq``
    columns (and int8 scales), each its own copy, and keep the first and
    second half of its output; the ``wo`` rows split evenly."""
    config, params, *_ = scoring_case
    hd = config.head_dim
    quantized = quantize_params(params)
    for tree_params in (params, quantized):
        sharded = tp_params(tree_params, config, ["cpu"] * 8)
        assert [view.columns for view in rank_views(sharded, config)] == [
            slice(0, hd // 2) if t % 2 == 0 else slice(hd // 2, hd) for t in range(8)]
        whole = tree_params["layers"][0]["wq"]
        for t, tree in enumerate(sharded.ranks):
            assert q_heads_of_rank(config, 8, t) == (t // 2,)
            assert kv_heads_of_rank(config, 8, t) == (t // 4,)
            part = tree["layers"][0]["wq"]
            cols = slice(t // 2 * hd, (t // 2 + 1) * hd)
            if tree_params is quantized:
                assert torch.equal(part.q, whole.q[:, cols])
                assert torch.equal(part.scale, whole.scale[:, cols])
            else:
                assert torch.equal(part, whole[:, cols])
            wo, whole_wo = tree["layers"][0]["wo"], tree_params["layers"][0]["wo"]
            if tree_params is quantized:
                wo, whole_wo = wo.q, whole_wo.q
            assert torch.equal(wo, whole_wo[t * hd // 2:(t + 1) * hd // 2])
        if tree_params is params:
            ptrs = {tree["layers"][0]["wq"].data_ptr() for tree in sharded.ranks}
            assert len(ptrs) == 8 and whole.data_ptr() not in ptrs


@pytest.mark.parametrize("tp", [4, 8])
def test_straddling_query_heads_match_jax(tp):
    """6 q / 3 kv heads (hd 16): at tp=4 a rank owns 1.5 heads and holds
    two; at tp=8 a rank's 12 columns touch one head or two, and every rank
    holds two (padded with a neighbour whose columns it drops).  Some
    rank's two heads straddle kv groups, so every rank holds one kv copy
    per query head.  atol 2e-4 against JAX's forward under make_mesh(tp)."""
    jcfg = jax_get_model_config("tiny-llama3", **STRADDLE)
    config = get_model_config("tiny-llama3", **STRADDLE)
    want = {
        4: ([(0, 1), (1, 2), (3, 4), (4, 5)], [(0, 0), (0, 1), (1, 2), (2, 2)],
            [(0, 24), (8, 32), (0, 24), (8, 32)]),
        8: ([(0, 1), (0, 1), (1, 2), (2, 3), (3, 4), (3, 4), (4, 5), (4, 5)],
            [(0, 0), (0, 0), (0, 1), (1, 1), (1, 2), (1, 2), (2, 2), (2, 2)],
            [(0, 12), (12, 24), (8, 20), (4, 16), (0, 12), (12, 24), (8, 20), (20, 32)]),
    }[tp]
    assert [q_heads_of_rank(config, tp, t) for t in range(tp)] == want[0]
    assert [kv_heads_of_rank(config, tp, t) for t in range(tp)] == want[1]
    assert [(c.start, c.stop) for c in (q_columns_of_rank(config, tp, t)
                                        for t in range(tp))] == want[2]
    valid = np.arange(16)[None, :] >= np.array([0, 3, 0, 5, 1, 0, 7, 2])[:, None]
    params, tokens, valid, expected = _jax_expected(jcfg, tp, valid)
    one = np.asarray(jax_token_logprobs(params, jcfg, jnp.asarray(tokens.numpy()),
                                        jnp.asarray(valid.numpy())))
    np.testing.assert_allclose(expected, one, atol=1e-5)
    got = token_logprobs(tp_params(_port(params, jcfg), config, ["cpu"] * tp), config,
                         tokens, valid)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), expected, atol=ATOL)


# ---------------------------------------------------------------------------
# TorchBackend(tp=4) against TPUBackend(tp=4), half a head a rank
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backends():
    """(JAX tp=4, port tp=1, port tp=4) on the JAX backend's weights."""
    ref = TPUBackend(model="tiny-llama3", config=jax_get_model_config("tiny-llama3", **HALF_HEAD),
                     tp=4, **OPTIONS)
    config = get_model_config("tiny-llama3", **HALF_HEAD)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    one = TorchBackend(model="tiny-llama3", config=config, params=params, device="cpu",
                       **OPTIONS)
    four = TorchBackend(model="tiny-llama3", config=config, params=params, device="cpu", tp=4,
                        **OPTIONS)
    assert isinstance(four.params, TPParams) and four.params.kv_heads == 1
    assert [view.columns for view in rank_views(four.params, config)] == [
        slice(0, 16), slice(16, 32)] * 2
    assert four.config.vocab_size == ref.config.vocab_size == 268
    return ref, one, four


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


def test_score_matches_tpu_backend_tp4(backends):
    """Teacher-forced scores within atol 2e-4 of ``TPUBackend(tp=4)``."""
    ref, _, four = backends
    pairs = [("Issue: parks.", "We agree on more parks."), ("Hello", " world"),
             ("Summarize: taxes.", "Taxes should be fair to all.")]
    got = four.score([ScoreRequest(context=c, continuation=s) for c, s in pairs])
    expect = ref.score([JaxScoreRequest(context=c, continuation=s) for c, s in pairs])
    for g, e in zip(got, expect):
        assert len(g.logprobs) == len(e.logprobs) > 0
        np.testing.assert_allclose(g.logprobs, e.logprobs, atol=ATOL)


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
    """A fused beam session's proposals at tp=4 equal tp=1's, logprobs
    within atol 2e-4."""
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
    """``create_server(mesh="dp=1,tp=4")`` with 2 q / 1 kv heads at hd 32:
    the engine runs the paged programs on 4 ranks of half a head each and
    answers as the same server at tp=1 does."""
    from consensus_tpu_torch.obs.metrics import Registry
    from consensus_tpu_torch.serve import create_server

    config = get_model_config("tiny-llama3", **HALF_HEAD)
    payload = {"issue": "Should the town build a new library?",
               "agent_opinions": {"A": "Yes, for the children.", "B": "No, taxes are high."},
               "method": "best_of_n", "params": {"n": 2, "max_tokens": 8}, "seed": 7}
    out = {}
    for mesh in ("dp=1,tp=1", "dp=1,tp=4"):
        server = create_server(backend="torch", port=0, registry=Registry(), mesh=mesh,
                               backend_options={"model": "tiny-llama3", "config": config,
                                                "device": "cpu", "dtype": "float32",
                                                "max_context": 256}).start()
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


def test_tp4_train_step_matches_jax_grad_and_keeps_wq_copies_equal():
    """Each rank's ``wq`` copy is a slice of the master leaf, so a head's
    columns get the sum of its two copies' gradients: the first step's
    gradients equal ``jax.grad`` on one device (relative 1e-4), and after an
    AdamW step the two ranks that share a query head hold equal ``wq``
    columns (and all four the one kv head's ``wk``/``wv``)."""
    config = jax_get_model_config("tiny-gemma2", n_layers=2, **HALF_HEAD)
    jax_params = jax_init_params(config, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, config.vocab_size, (4, 16)).astype(np.int32)
    valid = np.arange(16)[None, :] < rng.integers(8, 17, 4)[:, None]
    want = jax.grad(jax_lm_loss)(jax_params, config, jnp.asarray(tokens), jnp.asarray(valid))
    want_loss = float(jax_lm_loss(jax_params, config, jnp.asarray(tokens), jnp.asarray(valid)))
    port_config = get_model_config("tiny-gemma2", n_layers=2, **HALF_HEAD)
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
        lps = [tree["layers"][layer] for tree in ranks]
        for a, b in ((0, 1), (2, 3)):
            assert torch.equal(lps[a]["wq"], lps[b]["wq"])
        assert not torch.equal(lps[0]["wq"], lps[2]["wq"])
        for key in ("wk", "wv"):
            assert all(torch.equal(lps[0][key], lp[key]) for lp in lps[1:])
    assert all(leaf.grad is None for leaf in _leaves(params))


@pytest.mark.parametrize("model, overrides, tp, int8", [
    ("tiny-llama3", {}, 8, False), ("tiny-gemma2", {}, 8, True),
    ("tiny-llama3", STRADDLE, 4, True), ("tiny-llama3", STRADDLE, 8, False),
])
def test_sharded_restore_into_split_head_ranks(tmp_path, model, overrides, tp, int8):
    """``restore_params(shardings=param_shardings(..., config))`` reads each
    rank's copies of its query heads' ``wq`` columns (and int8 scales) and
    its kv heads' ``wk``/``wv`` columns straight from the file: bit-equal
    to ``shard_params`` of the whole tree; ``unshard_params`` takes one
    copy of each head back to it."""
    config = get_model_config(model, **overrides)
    jcfg = jax_get_model_config(model, **overrides)
    params = _port(jax_init_params(jcfg, jax.random.PRNGKey(0)), jcfg)
    if int8:
        params = quantize_params(params)
    save_params(str(tmp_path), params)
    plan = make_mesh(["cpu"] * tp, tp=tp)
    trees = restore_params(str(tmp_path), template=params,
                           shardings=param_shardings(params, plan, config))
    want = shard_params(params, plan, config)
    for t in range(tp):
        assert_params_equal(trees[0][t], want[0][t])
    wq = trees[0][0]["layers"][0]["wq"]
    assert (wq.q if int8 else wq).shape[-1] == local_config(config, tp).n_heads * config.head_dim
    assert_params_equal(unshard_params(trees[0], config), params)


def test_per_card_kv_bytes_count_the_copies(backends):
    """At tp=4 with one kv head every rank holds a copy of it: a rank's
    card holds as much KV as tp=1's one card, 4x the JAX package's
    ``n_kv_heads / tp`` figure.  gemma2-2b at tp=16: 16 copies on one card
    (4x tp=1's four kv heads), 4 on each of four cards."""
    _, one, four = backends
    c = four.config
    assert four._kv_heads_per_card == 1
    assert four._kv_bytes_per_column() == one._kv_bytes_per_column() == 2 * c.n_layers * c.head_dim * 4
    cache = make_cache(c, 3, 16, torch.float32, "cpu", params=four.params)
    assert [p.numel() * p.element_size() * 2 for p in cache.k.parts] == [
        3 * 16 * four._kv_bytes_per_column()] * 4
    gemma = get_model_config("gemma2-2b")
    assert _kv_heads_per_card(gemma, [torch.device("cuda", 0)] * 16) == 16
    assert _kv_heads_per_card(gemma, [torch.device("cuda", i // 4) for i in range(16)]) == 4
    assert (local_config(gemma, 16).n_heads, local_config(gemma, 16).n_kv_heads) == (1, 1)


# ---------------------------------------------------------------------------
# check_tp against the JAX package's shardings
# ---------------------------------------------------------------------------


def _jax_accepts(model, overrides, tp) -> bool:
    """Whether every leaf of the JAX package's ``param_shardings`` over a
    (1, tp) mesh splits its shape evenly (JAX's own ``shard_shape`` check,
    which ``device_put`` applies); where tp divides 8 also ``shard_params`` on the
    virtual devices, which must agree."""
    cfg = jax_get_model_config(model, **overrides)
    shapes = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0)))
    shardings = jax_param_shardings(shapes, AbstractMesh((1, tp), ("data", "model")))
    try:
        jax.tree.map(lambda leaf, s: s.shard_shape(leaf.shape), shapes, shardings)
        accepted = True
    except ValueError:
        accepted = False
    if 8 % tp == 0 and model.startswith("tiny"):
        try:
            jax_shard_params(jax_init_params(cfg, jax.random.PRNGKey(0)),
                             jax_make_mesh(tp=tp, dp=1).mesh)
            placed = True
        except ValueError:
            placed = False
        assert placed == accepted
    return accepted


@pytest.mark.parametrize("model, overrides, tp, refused", [
    ("tiny-llama3", {}, 2, None), ("tiny-llama3", {}, 3, "n_heads*head_dim=64"),
    ("tiny-llama3", {}, 8, None), ("tiny-llama3", {}, 16, None),
    ("tiny-llama3", {}, 64, "n_kv_heads*head_dim=32"),
    ("tiny-llama3", dict(vocab_size=516), 8, "vocab_size=516"),
    ("tiny-llama3", dict(vocab_size=516), 4, None),
    ("tiny-gemma2", {}, 8, None), ("tiny-gemma2", dict(ffn_hidden=132), 8, "ffn_hidden=132"),
    ("tiny-llama3", STRADDLE, 4, None), ("tiny-llama3", STRADDLE, 8, None),
    ("tiny-llama3", STRADDLE, 5, "n_heads*head_dim=96"),
    ("gemma2-2b", {}, 16, None), ("gemma2-2b", {}, 32, None),
    ("gemma2-2b", {}, 3, "n_heads*head_dim=2048"),
    ("gemma2-9b", {}, 32, None), ("llama3-8b", {}, 64, None),
    ("llama3-8b", {}, 6, "n_heads*head_dim=4096"),
])
def test_check_tp_refuses_exactly_where_jax_does(model, overrides, tp, refused):
    """``check_tp`` builds every (model, tp) that the JAX package's
    ``param_shardings`` splits evenly and raises ``ValueError`` naming the
    count for every one it refuses."""
    config = get_model_config(model, **overrides)
    assert _jax_accepts(model, overrides, tp) == (refused is None)
    if refused is None:
        check_tp(config, tp)
        local = local_config(config, tp)
        heads = sorted({h for t in range(tp) for h in q_heads_of_rank(config, tp, t)})
        assert heads == list(range(config.n_heads)) and local.vocab_size * tp == config.vocab_size
    else:
        with pytest.raises(ValueError, match=refused.replace("*", r"\*")):
            check_tp(config, tp)

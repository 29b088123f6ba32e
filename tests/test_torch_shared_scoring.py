"""The port's shared-context scoring against the JAX package, same weights.

JAX weights come from ``init_params(PRNGKey(0))`` in float32 and go through
``params_from_jax``.  ``shared_context_prefill`` (trunk cache, context
length, last hidden state) and ``shared_context_cont_logprobs`` run on a
right-padded context and ragged right-padded continuations, on
``tiny-gemma2`` (softcaps, a 16-token sliding window that the continuations
cross) and ``tiny-llama3``.  At the backend, ``score`` with
``shared_context_scoring`` on equals the per-call scorer with it off.
Tolerance: 1e-4 absolute (float32, different summation orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.models import transformer as jtf
from consensus_tpu.models.config import get_model_config as jax_config
from consensus_tpu_torch.backends.base import ScoreRequest
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.models import transformer as ttf
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-4
MODELS = ("tiny-gemma2", "tiny-llama3")


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, tcfg = jax_config(name), get_model_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def _inputs(vocab, ctx_len=20, ctx_width=28, cont_lengths=(9, 5, 1, 7)):
    rng = np.random.default_rng(4)
    ctx = np.zeros((1, ctx_width), np.int32)
    ctx[0, :ctx_len] = rng.integers(1, vocab, ctx_len)
    ctx_valid = np.arange(ctx_width)[None, :] < ctx_len
    width = max(cont_lengths)
    cont = np.zeros((len(cont_lengths), width), np.int32)
    cont_valid = np.arange(width)[None, :] < np.asarray(cont_lengths)[:, None]
    cont[cont_valid] = rng.integers(1, vocab, int(cont_valid.sum()))
    return ctx, ctx_valid, cont, cont_valid


@pytest.mark.parametrize("name", MODELS)
def test_shared_context_prefill_and_cont_logprobs(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    ctx, ctx_valid, cont, cont_valid = _inputs(tcfg.vocab_size)
    jtrunk, jlen, jlast = jtf.shared_context_prefill(
        jparams, jcfg, jnp.asarray(ctx), jnp.asarray(ctx_valid)
    )
    ttrunk, tlen, tlast = ttf.shared_context_prefill(
        tparams, tcfg, torch.from_numpy(ctx), torch.from_numpy(ctx_valid)
    )
    assert tlen.tolist() == np.asarray(jlen).tolist() == [20]
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL, rtol=0)
    for got, expect in ((ttrunk.k, jtrunk.k), (ttrunk.v, jtrunk.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ttrunk.key_valid.numpy(), np.asarray(jtrunk.key_valid))
    np.testing.assert_array_equal(ttrunk.key_positions.numpy(), np.asarray(jtrunk.key_positions))

    expect = jtf.shared_context_cont_logprobs(
        jparams, jcfg, jtrunk, jlen, jlast, jnp.asarray(cont), jnp.asarray(cont_valid),
        vocab_chunk=128,
    )
    got = ttf.shared_context_cont_logprobs(
        tparams, tcfg, ttrunk, tlen, tlast, torch.from_numpy(cont),
        torch.from_numpy(cont_valid), vocab_chunk=128,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL, rtol=0)
    assert (got.numpy()[~cont_valid] == 0.0).all()

    # The one-call form scores the same, and so does the full-sequence
    # scorer on each concatenation.
    whole = ttf.shared_context_token_logprobs(
        tparams, tcfg, torch.from_numpy(ctx), torch.from_numpy(ctx_valid),
        torch.from_numpy(cont), torch.from_numpy(cont_valid),
    )
    np.testing.assert_allclose(whole.numpy(), got.numpy(), atol=ATOL, rtol=0)
    for row, n in enumerate(cont_valid.sum(axis=1)):
        full = np.concatenate([ctx[0, :20], cont[row, :n]])[None]
        oracle = ttf.token_logprobs(
            tparams, tcfg, torch.from_numpy(full), torch.ones(full.shape, dtype=torch.bool)
        )[0, 20:]
        np.testing.assert_allclose(got.numpy()[row, :n], oracle.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_backend_shared_scoring_equals_per_call(name):
    """Two agent contexts with five candidates each (shared groups of 5),
    one context with two candidates and one whose candidate does not fit
    beside it (both per call): ``shared_context_scoring`` True equals
    False, request for request."""
    _, jparams, tcfg, _ = _models(name)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    kw = dict(model=name, dtype="float32", max_context=128, max_batch_rows=8, device="cpu")
    shared = TorchBackend(params=params, shared_context_scoring=True, **kw)
    per_call = TorchBackend(params=params, shared_context_scoring=False, **kw)
    candidates = [f"Statement {j}: {'we agree ' * (j + 1)}" for j in range(5)]
    requests = [
        ScoreRequest(context=f"Agent {i} holds view {i}.", continuation=c, system_prompt="Judge.")
        for i in range(2)
        for c in candidates
    ]
    requests += [ScoreRequest(context="A lone view.", continuation=c) for c in candidates[:2]]
    requests += [ScoreRequest(context="x" * 100, continuation="too long " * 4)] * 4
    got = shared.score(requests)
    expect = per_call.score(requests)
    assert len(got) == len(expect) == len(requests)
    for g, e in zip(got, expect):
        assert g.tokens == e.tokens
        np.testing.assert_allclose(g.logprobs, e.logprobs, atol=ATOL, rtol=0)
    # The two 5-row groups took the shared path: the per-call scorer saw
    # only the other six rows.
    assert shared.call_counts["score"] == per_call.call_counts["score"] == len(requests)
    assert shared.call_counts["score_batches"] == 1

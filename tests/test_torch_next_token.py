"""Next-token top-k: the port's ``next_token_topk`` / ``next_token_logits``
and ``TorchBackend.next_token_logprobs`` against the JAX package's, same
weights.

Weights: JAX's ``init_params`` (``TPUBackend``, float32, flash attention on:
the Pallas kernel in interpret mode) through ``params_from_jax`` into the
port (its flash kernel's plain version on the CPU).  Tolerances: logits and
logprobs 1e-4 absolute (float32 forwards summed in different orders).  Ids
are equal in score order up to the first near-tie (adjacent reference
scores within 1e-3); past it, each id the port picked must score within
1e-3 of the reference's pick at that rank.  The Gumbel noise is the same
bits on both sides (``utils/threefry.py``), so sampled rows are compared
like deterministic ones.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.backends.base import NextTokenRequest as JaxRequest
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.models import generate as jgen
from consensus_tpu_torch.backends.base import NextTokenRequest
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.models import generate as tgen
from consensus_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ATOL = 1e-4
TIE_MARGIN = 1e-3
K = 5


@functools.lru_cache(maxsize=None)
def _backends(model):
    kw = dict(model=model, dtype="float32", max_context=128, use_flash_attention=True,
              max_batch_rows=16)
    ref = TPUBackend(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", **kw)


def _prompt_batch(vocab, rows=6, width=24, seed=0):
    """Left-padded random prompts of mixed length (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, vocab, size=(rows, width)).astype(np.int32)
    valid = np.zeros((rows, width), bool)
    for row, n in enumerate(rng.integers(3, width + 1, size=rows)):
        valid[row, width - n:] = True
    tokens[~valid] = 0
    return tokens, valid


def _assert_same_topk(got_ids, expect_ids, scores):
    """Ids equal in score order up to the first near-tie; past it, the
    port's pick at each rank scores within TIE_MARGIN of the reference's."""
    for row in range(expect_ids.shape[0]):
        ordered = np.sort(scores[row])[::-1][: expect_ids.shape[1] + 1]
        gaps = ordered[:-1] - ordered[1:]
        exact = int(np.argmax(gaps <= TIE_MARGIN)) if (gaps <= TIE_MARGIN).any() else len(gaps)
        np.testing.assert_array_equal(got_ids[row, :exact], expect_ids[row, :exact])
        np.testing.assert_allclose(
            scores[row, got_ids[row]], scores[row, expect_ids[row]], atol=TIE_MARGIN, rtol=0
        )


@pytest.mark.parametrize("model", ["tiny-llama3", "tiny-gemma2"])
def test_next_token_logits_matches_jax(model):
    ref, port = _backends(model)
    tokens, valid = _prompt_batch(ref.config.vocab_size)
    expect = np.asarray(jgen.next_token_logits(ref.params, ref.config, tokens, valid))
    with torch.inference_mode():
        got = tgen.next_token_logits(
            port.params, port.config, torch.from_numpy(tokens), torch.from_numpy(valid)
        ).numpy()
    assert got.shape == expect.shape == (tokens.shape[0], ref.config.vocab_size)
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


@pytest.mark.parametrize("model", ["tiny-llama3", "tiny-gemma2"])
@pytest.mark.parametrize("case", ["deterministic", "gumbel", "bias", "mixed"])
def test_next_token_topk_matches_jax(model, case):
    ref, port = _backends(model)
    vocab = ref.config.vocab_size
    tokens, valid = _prompt_batch(vocab, seed=1)
    rows = tokens.shape[0]
    rng = np.random.default_rng(2)
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(7), s))(jnp.arange(rows))
    keys = np.asarray(keys)
    temperature = np.where(rng.random(rows) < 0.5, 0.7, 1.3).astype(np.float32)
    use_gumbel = {
        "deterministic": np.zeros(rows, bool), "gumbel": np.ones(rows, bool),
        "bias": np.ones(rows, bool), "mixed": np.arange(rows) % 2 == 0,
    }[case]
    bias_table = bias_index = None
    if case in ("bias", "mixed"):
        bias_table = np.zeros((2, vocab), np.float32)
        bias_table[1, rng.choice(vocab, 40, replace=False)] = -1.0e6
        bias_table[0, rng.choice(vocab, 5, replace=False)] = 0.5
        bias_index = (np.arange(rows) % 2).astype(np.int32)
    with_gumbel = bool(use_gumbel.any())
    expect_ids, expect_lp = jgen.next_token_topk(
        ref.params, ref.config, tokens, valid, keys, K, temperature, use_gumbel,
        None if bias_table is None else jnp.asarray(bias_table),
        None if bias_index is None else jnp.asarray(bias_index), with_gumbel=with_gumbel,
    )
    expect_ids, expect_lp = np.asarray(expect_ids), np.asarray(expect_lp)
    with torch.inference_mode():
        got_ids, got_lp = tgen.next_token_topk(
            port.params, port.config, torch.from_numpy(tokens), torch.from_numpy(valid),
            torch.from_numpy(keys.astype(np.int64)), K, torch.from_numpy(temperature),
            torch.from_numpy(use_gumbel),
            None if bias_table is None else torch.from_numpy(bias_table),
            None if bias_index is None else torch.from_numpy(bias_index).long(),
            with_gumbel=with_gumbel,
        )
    got_ids, got_lp = got_ids.numpy(), got_lp.numpy()
    assert got_ids.dtype == np.int32 and got_ids.shape == expect_ids.shape == (rows, K)

    # The reference's scores, from its own logits and noise.
    logits = np.asarray(jgen.next_token_logits(ref.params, ref.config, tokens, valid))
    if bias_table is not None:
        logits = logits + bias_table[bias_index]
    logprobs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    scores = logprobs / np.maximum(temperature, 1e-6)[:, None]
    if with_gumbel:
        noise = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (vocab,)))(keys))
        scores = scores + noise * use_gumbel[:, None]
    _assert_same_topk(got_ids, expect_ids, scores)
    np.testing.assert_allclose(got_lp, logprobs[np.arange(rows)[:, None], got_ids], atol=ATOL)
    np.testing.assert_allclose(np.sort(got_lp, 1), np.sort(expect_lp, 1), atol=ATOL)
    if bias_table is not None:  # banned ids never come back
        banned = bias_table[bias_index] < -1.0
        assert not banned[np.arange(rows)[:, None], got_ids].any()


def _requests(cls):
    bias = ("a", "e", " the")
    return [
        cls(user_prompt="Should the city add bike lanes?", k=4, seed=11),
        cls(user_prompt="Roads are for cars.", k=3, seed=12, temperature=0.7),
        cls(user_prompt="Roads are for cars.", k=6, mode="topk"),
        cls(user_prompt="Only where streets are wide.", system_prompt="Be brief.", k=2,
            seed=13, bias_against_tokens=bias),
        cls(user_prompt="We agree that", k=5, seed=14, temperature=0.0),
        cls(user_prompt="We agree that", k=4, seed=15, chat=True, bias_against_tokens=bias),
    ]


@pytest.mark.parametrize("model", ["tiny-llama3", "tiny-gemma2"])
def test_next_token_logprobs_matches_tpu_backend(model):
    ref, port = _backends(model)
    expect = ref.next_token_logprobs(_requests(JaxRequest))
    got = port.next_token_logprobs(_requests(NextTokenRequest))
    assert [len(r) for r in got] == [len(r) for r in expect] == [4, 3, 6, 2, 5, 4]
    for g_row, e_row in zip(got, expect):
        # Best-first by true logprob on both sides.
        assert [c.logprob for c in g_row] == sorted((c.logprob for c in g_row), reverse=True)
        np.testing.assert_allclose(
            [c.logprob for c in g_row], [c.logprob for c in e_row], atol=ATOL, rtol=0
        )
        lps = [c.logprob for c in e_row]
        for j, (g, e) in enumerate(zip(g_row, e_row)):
            tied = any(abs(lps[j] - lps[i]) <= TIE_MARGIN for i in range(len(lps)) if i != j)
            if not tied:
                assert (g.token_id, g.token) == (e.token_id, e.token)
    assert port.call_counts["next_token"] >= 6
    assert port.next_token_logprobs([]) == []


def test_pure_topk_batches_leave_the_unseeded_nonce_alone():
    _, port = _backends("tiny-llama3")
    before = port._unseeded_calls
    port.next_token_logprobs([
        NextTokenRequest(user_prompt="x", k=3, mode="topk"),
        NextTokenRequest(user_prompt="y", k=2, temperature=0.0),
    ])
    assert port._unseeded_calls == before
    port.next_token_logprobs([NextTokenRequest(user_prompt="x", k=3)])
    assert port._unseeded_calls == before + 1
    port.next_token_logprobs([NextTokenRequest(user_prompt="x", k=3, seed=5)])
    assert port._unseeded_calls == before + 1


def test_wide_batches_slice_and_bucket():
    """More requests than ``max_batch_rows`` slice; k buckets to >= 4 and
    rows to >= 8, and each row still returns its own k."""
    ref, port = _backends("tiny-llama3")
    requests = [NextTokenRequest(user_prompt=f"prompt {i}", k=1 + i % 3, seed=i) for i in range(19)]
    got = port.next_token_logprobs(requests)
    expect = ref.next_token_logprobs(
        [JaxRequest(user_prompt=r.user_prompt, k=r.k, seed=r.seed) for r in requests]
    )
    assert [len(r) for r in got] == [r.k for r in requests]
    np.testing.assert_allclose(
        [c.logprob for row in got for c in row], [c.logprob for row in expect for c in row],
        atol=ATOL, rtol=0,
    )

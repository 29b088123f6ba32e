"""The port's transformer against the JAX model, same weights, float32.

JAX weights come from ``init_params(PRNGKey(0))`` and go through
``params_from_jax``.  The no-cache forward runs the JAX flash path
(``use_flash_attention=True``, Pallas in interpret mode on the CPU) against
the port's flash path (its plain version on the CPU); the cached forward is
the einsum path on both sides.  Tolerance: 1e-4 absolute on logits and
logprobs of magnitude ~10 (float32, different summation orders).  With int8
the quantized tensors themselves must match exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.models import quant as jquant
from consensus_tpu.models import transformer as jtf
from consensus_tpu.models.config import get_model_config as jax_config
from consensus_tpu_torch.models import quant as tquant
from consensus_tpu_torch.models import transformer as ttf
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-4
MODELS = ("tiny-gemma2", "tiny-llama3")


@functools.lru_cache(maxsize=None)
def _models(name, int8):
    jcfg = dataclasses.replace(jax_config(name), use_flash_attention=True)
    tcfg = dataclasses.replace(get_model_config(name), use_flash_attention=True)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    if int8:
        jparams = jquant.quantize_params(jparams)
        tparams = tquant.quantize_params(tparams)
    return jcfg, jparams, tcfg, tparams


def _right_padded(vocab, seed=0, lengths=(24, 17, 5), width=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (len(lengths), width)).astype(np.int32)
    valid = np.arange(width)[None, :] < np.asarray(lengths)[:, None]
    tokens = np.where(valid, tokens, 0).astype(np.int32)
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return tokens, valid, positions


@pytest.mark.parametrize("name", MODELS)
def test_int8_quantization_is_exact(name):
    jcfg, jparams, tcfg, tparams = _models(name, int8=True)
    pairs = [(jparams["embed"], tparams["embed"])]
    for key in jquant.QUANTIZED_LAYER_KEYS:
        for layer in range(tcfg.n_layers):
            pairs.append(
                (
                    jquant.QTensor(
                        jparams["layers"][key].q[layer],
                        jparams["layers"][key].scale[layer],
                        jnp.float32,
                    ),
                    tparams["layers"][layer][key],
                )
            )
    for jq, tq in pairs:
        np.testing.assert_array_equal(np.asarray(jq.q), tq.q.numpy())
        np.testing.assert_allclose(np.asarray(jq.scale), tq.scale.numpy(), rtol=1e-7)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_without_cache_flash_path(name, int8):
    jcfg, jparams, tcfg, tparams = _models(name, int8)
    tokens, valid, positions = _right_padded(tcfg.vocab_size)
    jlogits, _ = jtf.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(valid))
    tlogits, _ = ttf.forward(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions), torch.from_numpy(valid)
    )
    mask = valid[:, :, None]
    np.testing.assert_allclose(tlogits.numpy() * mask, np.asarray(jlogits) * mask, atol=ATOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", MODELS)
def test_token_logprobs(name, int8):
    jcfg, jparams, tcfg, tparams = _models(name, int8)
    tokens, valid, _ = _right_padded(tcfg.vocab_size, seed=1)
    ref = jtf.token_logprobs(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid))
    out = ttf.token_logprobs(tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy() * valid, np.asarray(ref) * valid, atol=ATOL)
    streamed = ttf.token_logprobs_streamed(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), vocab_chunk=100
    )
    np.testing.assert_allclose(streamed.numpy() * valid, out.numpy() * valid, atol=ATOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_with_cache_prefill_and_step(name, int8):
    """Left-padded prefill into a cache, then one decode step (einsum path)."""
    jcfg, jparams, tcfg, tparams = _models(name, int8)
    width, total = 20, 24
    rng = np.random.default_rng(2)
    lengths = np.array([20, 12, 3])
    valid = np.arange(width)[None, :] >= (width - lengths)[:, None]
    tokens = np.where(valid, rng.integers(0, tcfg.vocab_size, (3, width)), 0).astype(np.int32)
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    step_tokens = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
    step_pos = positions[:, -1:] + 1
    step_valid = np.ones((3, 1), bool)

    jcache = jtf.make_cache(jcfg, 3, total)
    jl1, jcache = jtf.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(valid), jcache, 0)
    jl2, _ = jtf.forward(jparams, jcfg, jnp.asarray(step_tokens), jnp.asarray(step_pos), jnp.asarray(step_valid), jcache, width)

    tcache = ttf.make_cache(tcfg, 3, total, torch.float32, "cpu")
    tl1, tcache = ttf.forward(tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions), torch.from_numpy(valid), tcache, 0)
    tl2, _ = ttf.forward(tparams, tcfg, torch.from_numpy(step_tokens), torch.from_numpy(step_pos), torch.from_numpy(step_valid), tcache, width)

    mask = valid[:, :, None]
    np.testing.assert_allclose(tl1.numpy() * mask, np.asarray(jl1) * mask, atol=ATOL)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)


def test_rope_llama3_scaling_and_rms_norm():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
    pos = rng.integers(0, 9000, (2, 5)).astype(np.int32)
    scaling = get_model_config("llama3-8b").rope_scaling
    ref = jtf.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0, scaling)
    out = ttf.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0, scaling)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    w = rng.standard_normal(16, dtype=np.float32)
    for style in ("gemma", "llama"):
        ref = jtf.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, style)
        out = ttf.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, style)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

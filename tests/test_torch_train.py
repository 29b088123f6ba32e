"""The port's data-parallel train step (``consensus_tpu_torch/parallel/
train.py``) against the JAX package's ``lm_loss`` and jitted optax
``train_step``, from the same tiny-gemma2 params (``PRNGKey(0)``, float32)
and batch (numpy)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.models.config import get_model_config
from consensus_tpu.models.transformer import init_params as jax_init_params
from consensus_tpu.parallel import init_train_state as jax_init_train_state
from consensus_tpu.parallel import lm_loss as jax_lm_loss
from consensus_tpu.parallel import train_step as jax_train_step
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.parallel import init_train_state, lm_loss, make_mesh, train_step
from consensus_tpu_torch.parallel.train import shard_grads

MODEL = "tiny-gemma2"
ROWS, SEQ = 8, 16
LR = 1e-3
#: Params after each AdamW step against optax's: float32 forwards and
#: gradients agree to ~1e-6 relative, and Adam's normalised update scales a
#: gradient's rounding by at most lr / (|g| + eps) where |g| is tiny.
PARAM_ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    config = get_model_config(MODEL, n_layers=2)
    jax_params = jax_init_params(config, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, config.vocab_size, (ROWS, SEQ)).astype(np.int32)
    lengths = rng.integers(SEQ // 2, SEQ + 1, ROWS)
    valid = np.arange(SEQ)[None, :] < lengths[:, None]  # right-padded rows
    return config, jax_params, tokens, valid


def _port(config, jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), config)


def _flat(jax_params):
    """The JAX tree's leaves in the port's ``_leaves`` order, per layer."""
    out = {"embed": np.asarray(jax_params["embed"]),
           "final_norm": np.asarray(jax_params["final_norm"])}
    for key, value in jax_params["layers"].items():
        for i in range(value.shape[0]):
            out[f"layers.{i}.{key}"] = np.asarray(value[i])
    return out


def _port_flat(params):
    out = {"embed": params["embed"].detach().numpy(),
           "final_norm": params["final_norm"].detach().numpy()}
    for i, layer in enumerate(params["layers"]):
        for key, value in layer.items():
            out[f"layers.{i}.{key}"] = value.detach().numpy()
    return out


def test_lm_loss_matches_jax(setup):
    config, jax_params, tokens, valid = setup
    want = float(jax_lm_loss(jax_params, config, jnp.asarray(tokens), jnp.asarray(valid)))
    got = float(lm_loss(_port(config, jax_params), config, torch.from_numpy(tokens),
                        torch.from_numpy(valid)))
    assert got == pytest.approx(want, rel=1e-5)


def test_three_steps_follow_optax_adamw(setup):
    config, jax_params, tokens, valid = setup
    params, opt_state, optimizer = init_train_state(_port(config, jax_params), learning_rate=LR)
    jp, jstate, jopt = jax_init_train_state(jax_params, learning_rate=LR)
    assert optimizer.defaults["weight_decay"] == 1e-4
    for _ in range(3):
        jp, jstate, jloss = jax_train_step(jp, jstate, config, jopt, jnp.asarray(tokens),
                                           jnp.asarray(valid))
        params, opt_state, loss = train_step(params, opt_state, config, optimizer,
                                             torch.from_numpy(tokens), torch.from_numpy(valid))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        want, got = _flat(jp), _port_flat(params)
        assert set(want) == set(got)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_equals_dp1(setup, dp):
    """dp shards, each running its rows on its replica, with the loss over
    the global mask count: the summed gradients and the steps equal dp=1."""
    config, jax_params, tokens, valid = setup
    plan = make_mesh(["cpu"] * dp, tp=1)
    one = _port(config, jax_params)
    many = _port(config, jax_params)
    t, v = torch.from_numpy(tokens), torch.from_numpy(valid)
    init_train_state(one)
    init_train_state(many)
    loss1, grads1 = shard_grads(one, config, t, v)
    loss_n, grads_n = shard_grads(many, config, t, v, plan)
    assert float(loss_n) == pytest.approx(float(loss1), rel=1e-5)
    for a, b in zip(grads_n, grads1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-4)
    _, s1, o1 = init_train_state(one, learning_rate=LR)
    _, sn, on = init_train_state(many, learning_rate=LR)
    for _ in range(3):
        one, s1, l1 = train_step(one, s1, config, o1, t, v)
        many, sn, ln = train_step(many, sn, config, on, t, v, plan=plan)
        assert float(ln) == pytest.approx(float(l1), rel=1e-5)
    want, got = _port_flat(one), _port_flat(many)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=PARAM_ATOL, err_msg=key)


def test_tp_raises_naming_a15(setup):
    """The train step runs over dp=2 x tp=2 (queue A15, ported): its loss
    is the one-device loss and the loss falls over three steps."""
    config, jax_params, tokens, valid = setup
    t, v = torch.from_numpy(tokens), torch.from_numpy(valid)
    one, s1, o1 = init_train_state(_port(config, jax_params), learning_rate=LR)
    params, state, optimizer = init_train_state(_port(config, jax_params), learning_rate=LR)
    plan = make_mesh(["cpu"] * 4, tp=2)
    losses = []
    for _ in range(3):
        one, s1, l1 = train_step(one, s1, config, o1, t, v)
        params, state, loss = train_step(params, state, config, optimizer, t, v, plan=plan)
        assert float(loss) == pytest.approx(float(l1), rel=1e-5)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_flash_attention_has_no_gradient_as_in_jax(setup):
    """jax.grad through the Pallas flash kernel fails; so does the port's
    loss under autograd with ``use_flash_attention``."""
    config, jax_params, tokens, valid = setup
    flash = dataclasses.replace(config, use_flash_attention=True)
    with pytest.raises(Exception):
        jax.grad(jax_lm_loss)(jax_params, flash, jnp.asarray(tokens), jnp.asarray(valid))
    params, state, optimizer = init_train_state(_port(config, jax_params))
    with pytest.raises(NotImplementedError, match="no backward"):
        train_step(params, state, flash, optimizer, torch.from_numpy(tokens),
                   torch.from_numpy(valid))
    # Without gradients the flash route scores as JAX's does.
    with torch.no_grad():
        got = float(lm_loss(params, flash, torch.from_numpy(tokens), torch.from_numpy(valid)))
    want = float(jax_lm_loss(jax_params, flash, jnp.asarray(tokens), jnp.asarray(valid)))
    assert got == pytest.approx(want, rel=1e-4)

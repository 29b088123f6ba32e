"""The tensor-parallel train step (``consensus_tpu_torch/parallel/train.py``
over a plan with tp > 1) against the JAX package's ``jax.grad(lm_loss)``
and jitted optax ``train_step``, from the same tiny-gemma2 params
(``PRNGKey(0)``, float32) and batch (numpy): the first step's gradients,
reassembled from the ranks, within 1e-4 relative; the loss falling over
three steps; the sharded leaves' and the replicated leaves' updates."""

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
from consensus_tpu_torch.parallel import init_train_state, make_mesh, train_step
from consensus_tpu_torch.parallel.train import _leaves, shard_grads

torch.set_num_threads(1)

MODEL = "tiny-gemma2"
ROWS, SEQ = 8, 16
LR = 1e-3
GRAD_RTOL = 1e-4
PARAM_ATOL = 2e-5
PLANS = {"tp2": (["cpu"] * 2, 2), "dp2_tp2": (["cpu"] * 4, 2)}


@pytest.fixture(scope="module")
def setup():
    config = get_model_config(MODEL, n_layers=2)
    jax_params = jax_init_params(config, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, config.vocab_size, (ROWS, SEQ)).astype(np.int32)
    lengths = rng.integers(SEQ // 2, SEQ + 1, ROWS)
    valid = np.arange(SEQ)[None, :] < lengths[:, None]
    return config, jax_params, tokens, valid


def _port(config, jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), config)


def _jax_flat(tree):
    """The JAX tree's leaves by the port's dotted names."""
    out = {"embed": np.asarray(tree["embed"]), "final_norm": np.asarray(tree["final_norm"])}
    for key, value in tree["layers"].items():
        for i in range(value.shape[0]):
            out[f"layers.{i}.{key}"] = np.asarray(value[i])
    return out


def _port_keys(params):
    """Dotted names in the port's ``_leaves`` order."""
    keys = []
    for name, value in params.items():
        if name == "layers":
            keys += [f"layers.{i}.{key}" for i, layer in enumerate(value) for key in layer]
        else:
            keys.append(name)
    return keys


@pytest.mark.parametrize("plan", list(PLANS))
def test_first_step_gradients_match_jax_grad(setup, plan):
    config, jax_params, tokens, valid = setup
    want = jax.grad(jax_lm_loss)(jax_params, config, jnp.asarray(tokens), jnp.asarray(valid))
    params = _port(config, jax_params)
    init_train_state(params)
    devices, tp = PLANS[plan]
    loss, grads = shard_grads(params, config, torch.from_numpy(tokens),
                              torch.from_numpy(valid), make_mesh(devices, tp=tp))
    want_loss = float(jax_lm_loss(jax_params, config, jnp.asarray(tokens), jnp.asarray(valid)))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    want = _jax_flat(want)
    assert sorted(_port_keys(params)) == sorted(want)
    for key, got in zip(_port_keys(params), grads):
        ref = want[key]
        assert got.shape == ref.shape, key
        rel = np.linalg.norm(got.numpy() - ref) / max(np.linalg.norm(ref), 1e-12)
        assert rel < GRAD_RTOL, (key, rel)


def test_three_tp_steps_follow_optax_and_the_loss_falls(setup):
    config, jax_params, tokens, valid = setup
    params, state, optimizer = init_train_state(_port(config, jax_params), learning_rate=LR)
    jp, jstate, jopt = jax_init_train_state(jax_params, learning_rate=LR)
    plan = make_mesh(["cpu"] * 2, tp=2)
    losses = []
    for _ in range(3):
        jp, jstate, jloss = jax_train_step(jp, jstate, config, jopt, jnp.asarray(tokens),
                                           jnp.asarray(valid))
        params, state, loss = train_step(params, state, config, optimizer,
                                         torch.from_numpy(tokens), torch.from_numpy(valid),
                                         plan=plan)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        losses.append(float(loss))
    assert losses[2] < losses[0]
    want = _jax_flat(jp)
    for key, got in zip(_port_keys(params), _leaves(params)):
        np.testing.assert_allclose(got.detach().numpy(), want[key], atol=PARAM_ATOL, err_msg=key)

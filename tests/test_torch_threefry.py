"""The port's threefry (``consensus_tpu_torch/utils/threefry.py``) against
live ``jax.random``: every key word, bit and float is compared for exact
equality (tolerance 0), over 60 seeds at small shapes and a few seeds at the
real vocabularies (268 byte tokens, 128256 llama3, 256128 gemma2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.models.sampling import sample_tokens as jax_sample
from consensus_tpu_torch.models.sampling import sample_tokens
from consensus_tpu_torch.utils import threefry as tf

torch.set_num_threads(1)

SEEDS = range(60)
SMALL_SHAPES = [(1,), (2,), (7,), (268,), (8, 268), (7, 33), (3, 5, 7)]


def _same(jax_out, torch_out: torch.Tensor) -> bool:
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    if a.dtype == np.float32:
        return b.dtype == np.float32 and np.array_equal(a.view(np.int32), b.view(np.int32))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable is True


def test_prng_key_split_fold_in():
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
        assert _same(jk, tk)
        for num in (2, 3, 8):
            assert _same(jax.random.split(jk, num), tf.split(tk, num)), (seed, num)
        for data in (0, 1, seed, 2**31 - 1, 2**32 - 1 - seed):
            assert _same(jax.random.fold_in(jk, data), tf.fold_in(tk, data)), (seed, data)
    # Negative seeds wrap to uint32 as in JAX.
    assert _same(jax.random.PRNGKey(-5), tf.prng_key(-5))


def test_vmapped_split_and_fold_in():
    for seed in SEEDS:
        keys = jax.random.split(jax.random.PRNGKey(seed), 8)
        tkeys = tf.split(tf.prng_key(seed), 8)
        assert _same(jax.vmap(jax.random.split)(keys), tf.split(tkeys))
        data = jnp.arange(8) * 37 + seed
        assert _same(
            jax.vmap(jax.random.fold_in)(keys, data), tf.fold_in(tkeys, torch.from_numpy(np.array(data)))
        )
        step_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 1), 9)
        slot_keys = jax.vmap(lambda s: jax.random.fold_in(step_key, s))(jnp.arange(5))
        t_step = tf.fold_in(tf.fold_in(tf.prng_key(seed), 1), 9)
        assert _same(slot_keys, tf.fold_in(t_step, torch.arange(5)))


@pytest.mark.parametrize("shape", SMALL_SHAPES, ids=str)
def test_bits_uniform_gumbel(shape):
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
        assert _same(jax.random.bits(jk, shape), tf.random_bits(tk, shape)), seed
        assert _same(jax.random.uniform(jk, shape), tf.uniform(tk, shape)), seed
        assert _same(jax.random.gumbel(jk, shape), tf.gumbel(tk, shape)), seed


@pytest.mark.parametrize("vocab", [268, 128256, 256128])
def test_per_row_gumbel_at_real_vocabularies(vocab):
    for seed in range(3):
        keys = jax.random.split(jax.random.PRNGKey(seed), 8)
        ref = jax.vmap(lambda k: jax.random.gumbel(k, (vocab,)))(keys)
        assert _same(ref, tf.gumbel(tf.split(tf.prng_key(seed), 8), (vocab,))), seed
    # One key over the whole (8, V) block: counters run over the flat iota.
    jk = jax.random.PRNGKey(7)
    assert _same(jax.random.gumbel(jk, (8, vocab)), tf.gumbel(tf.prng_key(7), (8, vocab)))


def test_xla_log_over_the_float_range():
    rng = np.random.default_rng(0)
    x = np.concatenate(
        [rng.uniform(0, 1, 50000), rng.uniform(0, 100, 50000), np.exp(rng.uniform(-87, 88, 50000))]
    ).astype(np.float32)
    assert _same(jax.jit(jnp.log)(x), tf.xla_log(torch.from_numpy(x)))


@pytest.mark.parametrize("vocab", [268, 1000])
def test_categorical(vocab):
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        logits = (rng.standard_normal((8, vocab)) * 2).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(seed), 8)
        tkeys = tf.split(tf.prng_key(seed), 8)
        ref = jax.vmap(jax.random.categorical)(keys, logits)
        assert np.array_equal(np.asarray(ref), tf.categorical(tkeys, torch.from_numpy(logits)).numpy())
        one = jax.random.categorical(jax.random.PRNGKey(seed), logits)
        assert np.array_equal(np.asarray(one), tf.categorical(tf.prng_key(seed), torch.from_numpy(logits)).numpy())


@pytest.mark.parametrize(
    "top_k,top_p,temperature", [(0, 1.0, 1.0), (5, 1.0, 0.7), (0, 0.8, 1.3)]
)
def test_sample_tokens_with_keys_matches_jax(top_k, top_p, temperature):
    """The port's sampler draws from per-row keys exactly as the JAX one."""
    for seed in range(20):
        rng = np.random.default_rng(seed)
        logits = (rng.standard_normal((6, 268)) * 3).astype(np.float32)
        temps = np.full((6,), temperature, np.float32)
        temps[0] = 0.0
        keys = jax.random.split(jax.random.PRNGKey(seed), 6)
        ref = jax_sample(keys, jnp.asarray(logits), temperature=jnp.asarray(temps), top_k=top_k, top_p=top_p)
        out = sample_tokens(
            torch.from_numpy(logits), temperature=torch.from_numpy(temps), top_k=top_k,
            top_p=top_p, keys=tf.split(tf.prng_key(seed), 6),
        )
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

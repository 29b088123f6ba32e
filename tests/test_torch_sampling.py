"""The port's sampler against ``consensus_tpu.models.sampling``.

Both sides get the same Gumbel noise: the JAX sampler draws
``gumbel(key_i, (V,))`` per row inside ``jax.random.categorical``; the test
draws the same numbers with ``jax.random.gumbel`` and hands them to the
port as ``noise``.  Token ids must match exactly (logits are random normals
without near-ties at these sizes; filters compare the same float32 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.models.sampling import sample_tokens as jax_sample
from consensus_tpu_torch.models.sampling import apply_repetition_penalty, sample_tokens

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

B, V = 6, 97


def _setup(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys))
    return logits, keys, noise


@pytest.mark.parametrize(
    "top_k,top_p,temperature",
    [(0, 1.0, 1.0), (5, 1.0, 0.7), (0, 0.8, 1.3), (10, 0.5, 1.0), (0, 1.0, 0.0)],
)
def test_matches_jax_sampler(top_k, top_p, temperature):
    logits, keys, noise = _setup(seed=top_k + int(top_p * 10))
    temps = np.full((B,), temperature, np.float32)
    temps[0] = 0.0  # one greedy row in every batch
    ref = jax_sample(keys, jnp.asarray(logits), temperature=jnp.asarray(temps), top_k=top_k, top_p=top_p)
    out = sample_tokens(
        torch.from_numpy(logits), temperature=torch.from_numpy(temps),
        top_k=top_k, top_p=top_p, noise=torch.from_numpy(noise),
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_logit_bias_and_repetition_penalty():
    logits, keys, noise = _setup(seed=11)
    rng = np.random.default_rng(12)
    presence = rng.random((B, V)) < 0.2
    penalty = np.linspace(1.0, 2.0, B).astype(np.float32)
    bias = np.zeros((V,), np.float32)
    bias[[3, 7, 11]] = -1e6
    kw_j = dict(
        logit_bias=jnp.asarray(bias), presence=jnp.asarray(presence), rep_penalty=jnp.asarray(penalty)
    )
    kw_t = dict(
        logit_bias=torch.from_numpy(bias), presence=torch.from_numpy(presence),
        rep_penalty=torch.from_numpy(penalty),
    )
    for temperature in (0.0, 1.0):
        ref = jax_sample(keys, jnp.asarray(logits), temperature=temperature, **kw_j)
        out = sample_tokens(torch.from_numpy(logits), temperature=temperature, noise=torch.from_numpy(noise), **kw_t)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert not np.isin(out.numpy(), [3, 7, 11]).any()
    from consensus_tpu.models.sampling import apply_repetition_penalty as jax_penalty

    np.testing.assert_allclose(
        apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(presence), torch.from_numpy(penalty)).numpy(),
        np.asarray(jax_penalty(jnp.asarray(logits), jnp.asarray(presence), jnp.asarray(penalty))),
        rtol=1e-6,
    )


def test_per_row_generators_are_independent_of_batch():
    logits = torch.from_numpy(_setup(seed=5)[0])

    def gens(seeds):
        return [torch.Generator().manual_seed(s) for s in seeds]

    full = sample_tokens(logits, temperature=1.0, generators=gens(range(B)))
    alone = sample_tokens(logits[2:3], temperature=1.0, generators=gens([2]))
    assert int(alone[0]) == int(full[2])
    with pytest.raises(ValueError):
        sample_tokens(logits, temperature=1.0)

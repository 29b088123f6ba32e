"""The port's ring attention (``consensus_tpu_torch/parallel/
ring_attention.py``) against the JAX package's ``ring_self_attention`` on
its 8 virtual CPU devices: the cases of ``tests/test_ring_attention.py``
(2, 4 and 8 shards, causal and not, ragged masks, sharding invariance,
causality), atol 2e-5, the port's ring over CPU devices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.parallel.ring_attention import (
    full_attention_reference as jax_full_attention,
    make_sequence_mesh as jax_sequence_mesh,
    ring_self_attention as jax_ring_attention,
)
from consensus_tpu_torch.parallel.ring_attention import (
    full_attention_reference,
    make_sequence_mesh,
    ring_self_attention,
)

B, S, H, HD = 2, 64, 4, 16
ATOL = 2e-5


def _inputs(seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, HD)).astype(np.float32) for _ in range(3))
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if ragged:
        valid = np.arange(S)[None, :] < np.array([S, S // 2])[:, None]
    else:
        valid = np.ones((B, S), bool)
    return q, k, v, positions, valid


def _ring(n, arrays, causal=True):
    return ring_self_attention(
        make_sequence_mesh(n, devices=["cpu"] * 8), *map(torch.from_numpy, arrays), causal=causal
    ).numpy()


def _jax_ring(n, arrays, causal=True):
    return np.asarray(jax_ring_attention(jax_sequence_mesh(n), *map(jnp.asarray, arrays),
                                         causal=causal))


@pytest.mark.parametrize("n_devices", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_ring_and_full_attention(n_devices, causal):
    arrays = _inputs()
    got = _ring(n_devices, arrays, causal)
    np.testing.assert_allclose(got, _jax_ring(n_devices, arrays, causal), atol=ATOL)
    full = full_attention_reference(*map(torch.from_numpy, arrays), causal=causal).numpy()
    np.testing.assert_allclose(
        full, np.asarray(jax_full_attention(*map(jnp.asarray, arrays), causal=causal)), atol=ATOL)
    np.testing.assert_allclose(got, full, atol=ATOL)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_ragged_valid_masks(n_devices):
    arrays = _inputs(seed=3, ragged=True)
    mask = arrays[4][:, :, None, None]
    got = _ring(n_devices, arrays)
    np.testing.assert_allclose(got * mask, _jax_ring(n_devices, arrays) * mask, atol=ATOL)
    full = full_attention_reference(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(got * mask, full * mask, atol=ATOL)


def test_sharding_invariance():
    arrays = _inputs(seed=7)
    np.testing.assert_allclose(_ring(2, arrays), _ring(8, arrays), atol=ATOL)
    np.testing.assert_allclose(_ring(8, arrays), _jax_ring(2, arrays), atol=ATOL)


def test_causality():
    """Changing a future K/V changes no earlier query's output."""
    q, k, v, positions, valid = _inputs(seed=9)
    base = _ring(4, (q, k, v, positions, valid))
    k2, v2 = k.copy(), v.copy()
    k2[:, -1] += 10.0
    v2[:, -1] += 10.0
    perturbed = _ring(4, (q, k2, v2, positions, valid))
    np.testing.assert_allclose(base[:, :-1], perturbed[:, :-1], atol=ATOL)
    assert not np.allclose(base[:, -1], perturbed[:, -1])


def test_sequence_must_split_over_the_ring():
    arrays = _inputs()
    with pytest.raises(ValueError, match="does not split"):
        ring_self_attention(make_sequence_mesh(3, devices=["cpu"] * 3),
                            *map(torch.from_numpy, arrays))

"""The port's ``theory.py`` and ``threefry.normal`` against the JAX package's.

``threefry.normal`` is bit for bit ``jax.random.normal`` wherever XLA's
erfinv takes its polynomial in ``w = -log1p(-u^2) < 5`` (all but about 1
draw in 300); on the ``w >= 5`` branch XLA's CPU ``sqrt`` is not correctly
rounded, so there the draws are held within 1e-6 absolute.

The theory pipeline in float32 on both sides: agent and token vectors
within 1e-6 (the norms sum in different orders), utilities within 1e-6,
the Nash lottery's welfare within 5e-5 of JAX's and its p within 1e-3
(400 float32 Frank-Wolfe steps stop short of the optimum, and rounding
differences move the iterates along the flat objective), the egalitarian
lottery's worst-off utility within 1e-6, and ``run_experiment --quick``'s
alphas within a relative 1e-3 (the coalition LPs amplify float32
differences of p) and its TV within 1e-3 absolute.
The same tolerances hold the card's run against the CPU's in
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax

from consensus_tpu import theory as jax_theory
from consensus_tpu_torch import theory
from consensus_tpu_torch.utils import threefry

torch.set_num_threads(1)

B, L, D, N = 2, 3, 4, 3
VEC_ATOL = 1e-6
UTILITY_ATOL = 1e-6
P_ATOL = 1e-3
WELFARE_ATOL = 5e-5
ALPHA_RTOL = 1e-3
TV_ATOL = 1e-3


@pytest.mark.parametrize("shape", [(7,), (3, 2, 4), (64, 33)])
def test_normal_matches_jax(shape):
    exact = 0
    for seed in range(24):
        key = threefry.prng_key(seed)
        got = threefry.normal(key, shape).numpy()
        expect = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        assert got.dtype == expect.dtype == np.float32 and got.shape == expect.shape
        lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
        u = threefry.uniform(key, shape, minval=lo, maxval=1.0)
        large = (-threefry.xla_log1p(u * -u) >= 5.0).numpy()
        np.testing.assert_array_equal(got[~large], expect[~large])
        np.testing.assert_allclose(got[large], expect[large], rtol=0, atol=1e-6)
        exact += int((got == expect).sum())
    assert exact >= 0.99 * 24 * int(np.prod(shape))


def test_normal_of_split_keys_and_on_rows():
    keys = threefry.split(threefry.prng_key(11), 3)
    jax_keys = jax.random.split(jax.random.PRNGKey(11), 3)
    for k, jk in zip(keys, jax_keys):
        got = threefry.normal(k, (200,)).numpy()
        expect = np.asarray(jax.random.normal(jk, (200,)))
        np.testing.assert_allclose(got, expect, rtol=0, atol=1e-6)


def test_xla_log1p_and_erf_inv_match_jax():
    rng = np.random.default_rng(0)
    u = rng.uniform(-1, 1, 50_000).astype(np.float32)
    x = -(u * u)
    np.testing.assert_array_equal(threefry.xla_log1p(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.lax.log1p(x)))
    got = threefry.erf_inv(torch.from_numpy(u)).numpy()
    expect = np.asarray(jax.lax.erf_inv(u))
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-6)
    assert (got == expect).mean() > 0.999


@pytest.mark.parametrize("seed", [1, 5, 123])
@pytest.mark.parametrize("rho", [0.0, 0.5, 2.0, 10.0])
def test_utilities_and_lotteries_match_jax(seed, rho):
    v, w = theory.generate_params(B, L, D, N, seed=seed, device="cpu")
    jv, jw = jax_theory.generate_params(B, L, D, N, seed=seed)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=VEC_ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=VEC_ATOL)
    U, leaves = theory.compute_utilities(v, w, rho)
    jU, jleaves = jax_theory.compute_utilities(jv, jw, rho)
    np.testing.assert_array_equal(leaves.numpy(), np.asarray(jleaves))
    assert U.dtype == jU.dtype == np.float64
    np.testing.assert_allclose(U, jU, rtol=0, atol=UTILITY_ATOL)

    p = theory.nash_welfare_lottery(jU, device="cpu")
    jp = jax_theory.nash_welfare_lottery(jU)
    assert np.isclose(p.sum(), 1.0, atol=1e-6) and np.all(p >= -1e-12)
    np.testing.assert_allclose(p, jp, rtol=0, atol=P_ATOL)
    assert abs(theory.nash_welfare_value(jU, p)
               - jax_theory.nash_welfare_value(jU, jp)) <= WELFARE_ATOL

    egal = theory.egalitarian_lottery(jU)
    assert abs((jU @ egal).min() - (jU @ jax_theory.egalitarian_lottery(jU)).min()) <= 1e-6
    alpha = theory.max_coalition_improvement(jU, jp)
    assert alpha == jax_theory.max_coalition_improvement(jU, jp)
    assert theory.max_coalition_improvement(jU, p) == pytest.approx(alpha, rel=ALPHA_RTOL)


def test_enumerate_leaves_matches_jax():
    for b, depth in ((2, 3), (3, 4), (4, 1)):
        np.testing.assert_array_equal(theory.enumerate_leaves(b, depth, device="cpu").numpy(),
                                      np.asarray(jax_theory.enumerate_leaves(b, depth)))


def test_induced_policy_rollout_matches_jax():
    """On the same p* the port draws the same leaves: threefry's
    categorical is bit for bit JAX's."""
    v, w = jax_theory.generate_params(B, L, D, N, seed=5)
    U, _ = jax_theory.compute_utilities(v, w, 2.0)
    p = jax_theory.nash_welfare_lottery(U)
    for samples, seed in ((5_000, 7), (20_000, 3)):
        p_hat, tv = theory.induced_policy_rollout(p, B, L, num_samples=samples, seed=seed,
                                                  device="cpu")
        j_hat, jtv = jax_theory.induced_policy_rollout(p, B, L, num_samples=samples, seed=seed)
        np.testing.assert_array_equal(p_hat, j_hat)
        assert tv == jtv


def test_run_experiment_quick_matches_jax():
    curves, tv = theory.run_experiment(**theory.QUICK, out_plot=None, device="cpu")
    jcurves, jtv = jax_theory.run_experiment(**theory.QUICK, out_plot=None)
    assert curves.keys() == jcurves.keys()
    for k in curves:
        np.testing.assert_allclose(curves[k], jcurves[k], rtol=ALPHA_RTOL, atol=0)
    assert abs(tv - jtv) <= TV_ATOL


def test_main_quick_without_a_plot(capsys, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # any import of it fails
    assert theory.main(["--quick", "--out", "", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "TV(induced policy, p*)" in out and "final-rho alphas" in out

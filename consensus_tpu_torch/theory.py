"""Theory validation: Nash-welfare lotteries on synthetic token-level MDPs
(PyTorch port of ``consensus_tpu/theory.py``).

The paper's core claim, checked on synthetic agents: the Nash-welfare
lottery lies in the core (no coalition can block it).

* synthetic agents on a B-ary token tree of depth L: per-step softmax
  policies ``softmax(rho * w_i . (state + token_vec))``, per-leaf utility =
  product of stepwise probabilities, all ``B^L`` leaves and all agents
  batched, one step per tree level;
* the Nash-welfare lottery by Frank-Wolfe with a golden-section line search,
  a fixed number of iterations, in float32 on the device (the JAX package
  runs it in float32 too);
* the egalitarian (maximin) lottery as an exact LP and the coalition-blocking
  LPs on host scipy/HiGHS: they are tiny and exactness matters;
* the induced-policy rollout check: level-wise categorical sampling of all
  rollouts at once, then the total variation against p*.

The draws are the JAX package's: ``utils/threefry.py`` is bit for bit
``jax.random`` (``normal`` within a few ulps on about 1 draw in 300), so a
seed gives the same agents and, wherever the lotteries agree to float32
rounding, the same rollouts.

CLI: ``python -m consensus_tpu_torch.theory [--quick] [--out plot.png]
[--device cpu]``; it runs on the card unless ``--device`` says otherwise.
The plot imports matplotlib only when one is asked for (``--out ''``
skips it).
"""

from __future__ import annotations

import argparse
import itertools
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from consensus_tpu_torch.utils import threefry
from consensus_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# Synthetic utilities
# ----------------------------------------------------------------------


def generate_params(
    B: int, L: int, d: int, n_agents: int, seed: int = 123, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-norm token vectors v (L, B, d) and agent vectors w (n, d)."""
    device = resolve_device(device)
    kv, kw = threefry.split(threefry.prng_key(seed, device))
    v = threefry.normal(kv, (L, B, d))
    v = v / (torch.linalg.vector_norm(v, dim=2, keepdim=True) + 1e-12)
    w = threefry.normal(kw, (n_agents, d))
    w = w / (torch.linalg.vector_norm(w, dim=1, keepdim=True) + 1e-12)
    return v, w


def enumerate_leaves(B: int, L: int, device=None) -> torch.Tensor:
    """(B^L, L) int64 tensor of all action paths (row i = i's base-B digits)."""
    digits = torch.arange(B**L, device=resolve_device(device))
    cols = [(digits // (B ** (L - 1 - t))) % B for t in range(L)]
    return torch.stack(cols, dim=1)


def compute_utilities(v: torch.Tensor, w: torch.Tensor, rho: float) -> Tuple[np.ndarray, torch.Tensor]:
    """U (n, B^L) positive utilities (float64 on the host) and the leaf table."""
    B, L = v.shape[1], v.shape[0]
    leaves = enumerate_leaves(B, L, v.device)
    m, d = leaves.shape[0], v.shape[2]
    n = w.shape[0]
    z = torch.zeros((m, d), dtype=torch.float32, device=v.device)  # running state
    logu = torch.zeros((n, m), dtype=torch.float32, device=v.device)
    for t in range(L):
        X = z[:, None, :] + v[t][None, :, :]  # (m, B, d)
        logits = float(rho) * torch.einsum("nd,mbd->nmb", w, X)
        ls = torch.log_softmax(logits, dim=-1)
        chosen = leaves[:, t]
        logu = logu + torch.gather(ls, 2, chosen[None, :, None].expand(n, m, 1))[..., 0]
        z = z + v[t, chosen]
    # Per-agent stabilization, strictly positive where float32 allows.
    logu = logu - logu.max(dim=1, keepdim=True).values
    U = torch.exp(logu) + 1e-300  # 0 in float32, as in the JAX package
    return U.double().cpu().numpy(), leaves


# ----------------------------------------------------------------------
# Nash welfare via Frank-Wolfe
# ----------------------------------------------------------------------


def nash_welfare_value(U: np.ndarray, p: np.ndarray) -> float:
    a = U @ p
    if np.any(a <= 0):
        return -np.inf
    return float(np.sum(np.log(a)))


def _golden(a_vec: torch.Tensor, b_vec: torch.Tensor, ls_iters: int, gr: torch.Tensor):
    """argmax_gamma sum(log((1-g) a + g b)) on [0, 1] by golden section,
    the JAX package's fixed-iteration loop (both probes evaluated each
    step, the kept one selected), all on the device."""

    def F(gamma):
        return torch.log((1.0 - gamma) * a_vec + gamma * b_vec).sum()

    zero = torch.zeros((), dtype=torch.float32, device=a_vec.device)
    lo, hi = zero, zero + 1.0
    c = hi - gr * (hi - lo)
    dd = lo + gr * (hi - lo)
    Fc, Fd = F(c), F(dd)
    for _ in range(ls_iters):
        shrink_left = Fc < Fd
        lo2 = torch.where(shrink_left, c, lo)
        hi2 = torch.where(shrink_left, hi, dd)
        c2 = torch.where(shrink_left, dd, hi2 - gr * (hi2 - lo2))
        d2 = torch.where(shrink_left, lo2 + gr * (hi2 - lo2), c)
        Fc2 = torch.where(shrink_left, Fd, F(c2))
        Fd2 = torch.where(shrink_left, F(d2), Fc)
        lo, hi, c, dd, Fc, Fd = lo2, hi2, c2, d2, Fc2, Fd2
    return 0.5 * (lo + hi)


def _fw_step(Ut: torch.Tensor, p: torch.Tensor, columns: torch.Tensor, gr: torch.Tensor,
             ls_iters: int) -> torch.Tensor:
    a = Ut @ p
    g = (Ut / a[:, None]).sum(0)
    j = torch.argmax(g).reshape(1)
    # index_select, not Ut[:, j]: a tensor index would sync to the host,
    # which a CUDA graph capture refuses.
    gamma = _golden(a, torch.index_select(Ut, 1, j)[:, 0], ls_iters, gr)
    return (1.0 - gamma) * p + torch.where(columns == j, gamma, 0.0)


def nash_welfare_lottery(
    U: np.ndarray, max_iters: int = 400, ls_iters: int = 60, device=None
) -> np.ndarray:
    """Frank-Wolfe maximizer of sum_i log(U_i^T p) over the simplex, in
    float32 on ``device``; returns p as float64 on the host.  On the card
    one step (about 1500 tiny kernels: the line search is sequential) is
    captured in a CUDA graph and replayed ``max_iters`` times: the same
    kernels on the same values, without the host's launch cost each time."""
    device = resolve_device(device)
    Ut = torch.as_tensor(np.asarray(U), dtype=torch.float32, device=device)
    m = Ut.shape[1]
    gr = (torch.sqrt(torch.tensor(5.0, device=device)) - 1.0) / 2.0
    p = torch.ones(m, dtype=torch.float32, device=device) / m
    columns = torch.arange(m, device=device)
    if device.type != "cuda":
        for _ in range(max_iters):
            p = _fw_step(Ut, p, columns, gr, ls_iters)
        return p.double().numpy()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm-up outside the capture, as torch asks
        _fw_step(Ut, p, columns, gr, ls_iters)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # Captured on ``side``, a stream of ``device``: torch.cuda.graph's default
    # capture stream is made once per process, on the card current at the
    # first capture, and would record nothing for another card.
    with torch.cuda.graph(graph, stream=side):
        stepped = _fw_step(Ut, p, columns, gr, ls_iters)
    for _ in range(max_iters):
        graph.replay()
        p.copy_(stepped)
    return p.double().cpu().numpy()


# ----------------------------------------------------------------------
# Egalitarian lottery + coalition blocking (exact host LPs)
# ----------------------------------------------------------------------


def egalitarian_lottery(U: np.ndarray) -> np.ndarray:
    """Maximin lottery: argmax_p min_i U_i^T p, solved exactly as an LP."""
    from scipy.optimize import linprog

    n, m = U.shape
    c = np.zeros(m + 1)
    c[-1] = -1.0
    A_ub = np.concatenate([-U, np.ones((n, 1))], axis=1)
    b_ub = np.zeros(n)
    A_eq = np.concatenate([np.ones((1, m)), np.zeros((1, 1))], axis=1)
    res = linprog(
        c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=[1.0],
        bounds=[(0.0, 1.0)] * m + [(None, None)], method="highs",
    )
    return res.x[:m] if res.success else np.ones(m) / m


def max_coalition_improvement(U: np.ndarray, p: np.ndarray) -> float:
    """Max alpha over nonempty coalitions S: with budget |S|/n, can S give
    every member alpha x their utility under p?  alpha > 1 means p is
    blockable."""
    from scipy.optimize import linprog

    n, m = U.shape
    base = U @ p
    max_alpha = 1.0
    for r in range(1, n + 1):
        budget = r / n
        for S in itertools.combinations(range(n), r):
            rows = [np.concatenate([-U[i], [base[i]]]) for i in S]
            c = np.zeros(m + 1)
            c[-1] = -1.0
            A_eq = np.concatenate([np.ones((1, m)), np.zeros((1, 1))], axis=1)
            res = linprog(
                c,
                A_ub=np.array(rows),
                b_ub=np.zeros(len(rows)),
                A_eq=A_eq,
                b_eq=[budget],
                bounds=[(0.0, None)] * m + [(None, None)],
                method="highs",
            )
            if res.success and res.x[-1] > max_alpha:
                max_alpha = float(res.x[-1])
    return max_alpha


# ----------------------------------------------------------------------
# Induced-policy rollout (vectorized sampling)
# ----------------------------------------------------------------------


def induced_policy_rollout(
    p_star: np.ndarray, B: int, L: int, num_samples: int = 200_000, seed: int = 7,
    device=None,
) -> Tuple[np.ndarray, float]:
    """Sample leaves from the per-step policy induced by p*; return the
    empirical distribution and the TV distance to p*.

    All samples advance one level per iteration: the level-t conditional is
    ``mass[node*B + a] / mass[node]`` with node masses = partial sums of p*.
    """
    device = resolve_device(device)
    p = torch.as_tensor(np.asarray(p_star), dtype=torch.float32, device=device)
    masses: List[torch.Tensor] = [p.reshape(B**t, -1).sum(dim=1) for t in range(L + 1)]

    key = threefry.prng_key(seed, device)
    nodes = torch.zeros((num_samples,), dtype=torch.int64, device=device)
    for t in range(L):
        child_mass = masses[t + 1].reshape(B**t, B)[nodes]  # (S, B)
        parent = masses[t][nodes][:, None]
        # 1e-300 is 0 in float32, as in the JAX package.
        probs = torch.where(parent > 0, child_mass / torch.clamp(parent, min=0.0), 1.0 / B)
        key, sub = threefry.split(key)
        actions = threefry.categorical(sub, torch.log(torch.clamp(probs, min=0.0)))
        nodes = nodes * B + actions

    counts = np.bincount(nodes.cpu().numpy(), minlength=B**L)
    p_hat = counts / counts.sum()
    tv = 0.5 * float(np.abs(p_hat - np.asarray(p_star)).sum())
    return p_hat, tv


# ----------------------------------------------------------------------
# The experiment
# ----------------------------------------------------------------------


def run_experiment(
    B: int = 3,
    L: int = 4,
    d: int = 8,
    n_agents: int = 4,
    rhos: Optional[np.ndarray] = None,
    n_runs: int = 3,
    out_plot: Optional[str] = "core_violation_plot.png",
    rollout_samples: int = 100_000,
    device=None,
):
    """Sweep polarization rho; for each, compare coalition max-alpha of the
    NW lottery vs egalitarian / uniform / utilitarian-argmax baselines."""
    device = resolve_device(device)
    if rhos is None:
        rhos = np.logspace(-1, 1.5, 8)

    curves = {"nash": [], "egalitarian": [], "uniform": [], "utilitarian": []}
    for rho in rhos:
        alphas = {k: [] for k in curves}
        for run in range(n_runs):
            v, w = generate_params(B, L, d, n_agents, seed=123 + run, device=device)
            U, _ = compute_utilities(v, w, rho)
            m = U.shape[1]

            p_nash = nash_welfare_lottery(U, device=device)
            p_egal = egalitarian_lottery(U)
            p_unif = np.ones(m) / m
            p_util = np.zeros(m)
            p_util[int(np.argmax(U.sum(0)))] = 1.0

            alphas["nash"].append(max_coalition_improvement(U, p_nash))
            alphas["egalitarian"].append(max_coalition_improvement(U, p_egal))
            alphas["uniform"].append(max_coalition_improvement(U, p_unif))
            alphas["utilitarian"].append(max_coalition_improvement(U, p_util))
        for k in curves:
            curves[k].append(float(np.mean(alphas[k])))
        logger.info(
            "rho=%.3f: nash=%.4f egal=%.4f unif=%.4f util=%.4f",
            rho, curves["nash"][-1], curves["egalitarian"][-1],
            curves["uniform"][-1], curves["utilitarian"][-1],
        )

    # Policy-lottery equivalence sanity check at the final rho.
    _, tv = induced_policy_rollout(p_nash, B, L, num_samples=rollout_samples, device=device)
    logger.info("TV(induced-policy rollout, p*) = %.5f", tv)

    if out_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4.5))
        labels = {
            "nash": "Nash welfare (FW)",
            "egalitarian": "Egalitarian (LP)",
            "uniform": "Uniform",
            "utilitarian": "Utilitarian argmax",
        }
        for k, values in curves.items():
            ax.plot(rhos, values, marker="o", label=labels[k])
        ax.axhline(1.0, color="gray", lw=0.8, ls="--")
        ax.set_xscale("log")
        ax.set_xlabel("polarization ρ")
        ax.set_ylabel("max coalition improvement α")
        ax.set_title("Coalition blockability vs polarization")
        ax.legend()
        fig.tight_layout()
        fig.savefig(out_plot, dpi=120)
        logger.info("Wrote %s", out_plot)

    return curves, tv


#: ``--quick``'s sweep: the JAX package's CLI settings.
QUICK = dict(B=2, L=3, d=4, n_agents=3, rhos=np.logspace(-1, 1, 3), n_runs=1,
             rollout_samples=20_000)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Theory validation experiment")
    parser.add_argument("--quick", action="store_true", help="tiny fast sweep")
    parser.add_argument("--out", default="core_violation_plot.png")
    parser.add_argument("--device", default=None, help="default: the card (cuda)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    if args.quick:
        curves, tv = run_experiment(**QUICK, out_plot=args.out, device=args.device)
    else:
        curves, tv = run_experiment(out_plot=args.out, device=args.device)
    print(f"TV(induced policy, p*) = {tv:.5f}")
    print(f"final-rho alphas: { {k: round(v[-1], 4) for k, v in curves.items()} }")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

"""Social-welfare reductions over (candidates, agents) utility arrays
(PyTorch port of ``consensus_tpu/ops/welfare.py``).

Each function takes a numpy array or a torch tensor and answers in kind,
in float32 like the JAX version:

* egalitarian  = min_i u_i
* utilitarian  = sum_i u_i
* log-Nash     = sum_i log(max(u_i, eps)), eps = 1e-9

``sanitize_utilities`` is best-of-N's NaN/inf policy: NaN -> -10,
+inf -> +20, -inf -> -20.
"""

from __future__ import annotations

import numpy as np
import torch

UTILITY_EPSILON = 1e-9
DEFAULT_REWARD = -10.0
REWARD_CLIP_MIN = -20.0
REWARD_CLIP_MAX = 20.0


def sanitize_utilities(utilities):
    if isinstance(utilities, torch.Tensor):
        u = utilities.to(torch.float32)
        u = torch.where(torch.isnan(u), torch.full_like(u, DEFAULT_REWARD), u)
        u = torch.where(torch.isposinf(u), torch.full_like(u, REWARD_CLIP_MAX), u)
        return torch.where(torch.isneginf(u), torch.full_like(u, REWARD_CLIP_MIN), u)
    u = np.asarray(utilities, dtype=np.float32)
    u = np.where(np.isnan(u), np.float32(DEFAULT_REWARD), u)
    u = np.where(np.isposinf(u), np.float32(REWARD_CLIP_MAX), u)
    return np.where(np.isneginf(u), np.float32(REWARD_CLIP_MIN), u).astype(np.float32)


def egalitarian_welfare(utilities, axis: int = -1):
    if isinstance(utilities, torch.Tensor):
        return utilities.amin(dim=axis)
    return np.min(np.asarray(utilities), axis=axis)


def utilitarian_welfare(utilities, axis: int = -1):
    if isinstance(utilities, torch.Tensor):
        return utilities.sum(dim=axis)
    return np.sum(np.asarray(utilities), axis=axis)


def log_nash_welfare(utilities, axis: int = -1):
    if isinstance(utilities, torch.Tensor):
        return torch.log(torch.clamp(utilities, min=UTILITY_EPSILON)).sum(dim=axis)
    u = np.asarray(utilities)
    return np.sum(np.log(np.maximum(u, np.asarray(UTILITY_EPSILON, u.dtype))), axis=axis)


WELFARE_RULES = {
    "egalitarian": egalitarian_welfare,
    "utilitarian": utilitarian_welfare,
    "log_nash": log_nash_welfare,
}


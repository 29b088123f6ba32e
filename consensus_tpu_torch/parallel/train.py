"""Training step over the data-parallel mesh (PyTorch port of
``consensus_tpu/parallel/train.py``).

Teacher-forced LM loss, gradients, AdamW update.  Over a mesh with ``dp``
shards each shard runs its contiguous block of batch rows through its own
replica of the parameters; the loss is normalised by the GLOBAL count of
scored positions, so the shards' gradients sum to the gradient of the whole
batch's loss.  The sum is taken once per shard (also where two shards share
one card) and applied in one optimizer step to the master parameters; each
step places its replicas afresh from the master, so they stay equal.
Tensor parallelism raises (ROADMAP.md, queue A15).

The hand-written flash kernel has no backward, as the Pallas kernel it
replaces has none (``jax.grad`` through it fails): a loss taken with
``use_flash_attention`` raises under autograd.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.quant import QTensor
from consensus_tpu_torch.models.transformer import forward
from consensus_tpu_torch.parallel.mesh import MeshPlan, shard_params

Params = Dict[str, Any]


def _masked_target_logprobs(params: Params, config: ModelConfig, tokens, valid):
    """(sum of target logprobs over scored positions, their mask)."""
    positions = torch.clamp(torch.cumsum(valid.to(torch.int32), dim=1) - 1, min=0)
    logits, _ = forward(params, config, tokens, positions, valid)
    logprobs = torch.log_softmax(logits[:, :-1, :].to(torch.float32), dim=-1)
    targets = tokens[:, 1:].to(torch.int64)
    target_lp = torch.gather(logprobs, -1, targets[:, :, None])[..., 0]
    mask = (valid[:, :-1] & valid[:, 1:]).to(torch.float32)
    return (target_lp * mask).sum(), mask


def lm_loss(params: Params, config: ModelConfig, tokens: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over valid target positions
    (``train.py:27``); ``tokens`` right-padded (B, S) int, ``valid`` (B, S)."""
    total, mask = _masked_target_logprobs(params, config, tokens, valid)
    return -total / torch.clamp(mask.sum(), min=1.0)


def _leaves(params: Params) -> List[torch.Tensor]:
    out = []
    for name, value in params.items():
        values = [leaf for layer in value for leaf in layer.values()] if name == "layers" else [value]
        for leaf in values:
            if isinstance(leaf, QTensor):
                raise ValueError("train_step needs full-precision weights, not int8 QTensors")
            out.append(leaf)
    return out


def make_optimizer(leaves: List[torch.Tensor], learning_rate: float = 1e-4) -> torch.optim.AdamW:
    """AdamW at optax ``adamw(learning_rate)``'s defaults: b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-4 (torch's own default is 1e-2)."""
    return torch.optim.AdamW(
        leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def init_train_state(
    params: Params, learning_rate: float = 1e-4
) -> Tuple[Params, Dict[str, Any], torch.optim.AdamW]:
    """(params, optimizer state, optimizer), as ``train.py:49-54``: the
    parameters become trainable leaves, updated in place by each step."""
    leaves = _leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    optimizer = make_optimizer(leaves, learning_rate)
    return params, optimizer.state, optimizer


def _check_plan(plan: Optional[MeshPlan]) -> int:
    if plan is None:
        return 1
    if plan.tp > 1:
        raise NotImplementedError(
            "train_step over tp > 1 needs the tensor-parallel forward "
            "(ROADMAP.md, queue A15)"
        )
    return plan.dp


def shard_grads(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,
    valid: torch.Tensor,
    plan: Optional[MeshPlan] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradients in :func:`_leaves` order) of the whole batch.  With
    ``plan`` (dp shards, tp 1) the rows split into dp contiguous blocks (the
    row count must divide dp), each block runs on its shard's replica on its
    own device, every shard launched before any is waited on, and the
    shards' gradients are summed once each onto the master's devices."""
    dp = _check_plan(plan)
    if tokens.shape[0] % dp:
        raise ValueError(f"{tokens.shape[0]} batch rows do not split over dp={dp}")
    if dp == 1:
        loss = lm_loss(params, config, tokens, valid)
        return loss.detach(), list(torch.autograd.grad(loss, _leaves(params)))
    mask_count = torch.clamp((valid[:, :-1] & valid[:, 1:]).to(torch.float32).sum(), min=1.0)
    replicas = [row[0] for row in shard_params(params, plan)]
    block = tokens.shape[0] // dp

    def one_shard(s: int):
        device = plan.data_devices[s]
        rows = slice(s * block, (s + 1) * block)
        with _device_guard(device), torch.enable_grad():
            total, _ = _masked_target_logprobs(
                replicas[s], config, tokens[rows].to(device), valid[rows].to(device)
            )
            loss = -total / mask_count.to(device)
            return loss.detach(), torch.autograd.grad(loss, _leaves(replicas[s]))

    with ThreadPoolExecutor(max_workers=dp) as pool:
        parts = list(pool.map(one_shard, range(dp)))
    master = _leaves(params)
    loss = sum(part[0].to(tokens.device) for part in parts)
    grads = [sum(part[1][i].to(leaf.device) for part in parts) for i, leaf in enumerate(master)]
    return loss, grads


def train_step(
    params: Params,
    opt_state: Dict[str, Any],
    config: ModelConfig,
    optimizer: torch.optim.AdamW,
    tokens: torch.Tensor,
    valid: torch.Tensor,
    plan: Optional[MeshPlan] = None,
) -> Tuple[Params, Dict[str, Any], torch.Tensor]:
    """One AdamW step (``train.py:57``) -> (params, optimizer state, loss):
    the gradients of :func:`shard_grads` (over ``plan``'s dp shards, or one
    device without it) applied once to the master ``params``."""
    loss, grads = shard_grads(params, config, tokens, valid, plan)
    for leaf, grad in zip(_leaves(params), grads):
        leaf.grad = grad
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return params, optimizer.state, loss


def _device_guard(device: torch.device):
    """Make ``device`` current in this thread while its work is issued."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()

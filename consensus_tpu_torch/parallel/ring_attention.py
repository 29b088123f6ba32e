"""Ring attention: sequence-parallel exact attention over a ring of devices
(PyTorch port of ``consensus_tpu/parallel/ring_attention.py``).

For sequences too long for one card, the sequence axis is split over the
ring's devices and EXACT attention is computed by rotating K/V blocks one
hop around the ring per step while each device keeps only its own Q block:
a streaming-softmax accumulation (Ring Attention, Liu et al. 2023).  Per
step each device holds one (B, S/K, H, hd) K/V block; the K - 1 rotations
are device-to-device copies (peer copies over NVLink between cards).

Causality uses GLOBAL positions, so the result does not depend on how the
sequence was split.  One host thread issues every device's work; CUDA runs
it asynchronously, so the devices compute their blocks at once.  There is
no hand-written kernel behind this, as there is no Pallas kernel behind its
JAX counterpart.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from consensus_tpu_torch.parallel.mesh import default_devices

_NEG_INF = -1e30


def _attend_block(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, H, hd)
    v: torch.Tensor,  # (B, Skv, H, hd)
    q_pos: torch.Tensor,  # (B, Sq)
    kv_pos: torch.Tensor,  # (B, Skv)
    q_valid: torch.Tensor,  # (B, Sq)
    kv_valid: torch.Tensor,  # (B, Skv)
    scale: float,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's (logits-max, sum-exp, weighted-V) contributions
    (``ring_attention.py:46-70``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    mask = kv_valid[:, None, None, :] & q_valid[:, None, :, None]
    if causal:
        mask = mask & (kv_pos[:, None, None, :] <= q_pos[:, None, :, None])
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    block_max = logits.amax(dim=-1)  # (B, H, Sq)
    p = torch.exp(logits - block_max[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))  # kill exp(-1e30 - max) residue exactly
    block_sum = p.sum(dim=-1)
    block_out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return block_max, block_sum, block_out


def make_sequence_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Tuple[torch.device, ...]:
    """The ring: the first ``n_devices`` of ``devices`` (default: the
    visible cards), in ring order (``ring_attention.py:154``)."""
    ring = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    return tuple(ring[: n_devices or len(ring)])


def ring_self_attention(
    mesh: Sequence[torch.device],
    q: torch.Tensor,  # (B, S, H, hd) -- S divisible by the ring's size
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,  # (B, S) global positions
    valid: torch.Tensor,  # (B, S)
    scale: Optional[float] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Exact attention with the sequence axis split over the ring ``mesh``
    (``ring_attention.py:118``).  Inputs are whole tensors on any device;
    the output comes back whole on ``q``'s device."""
    n = len(mesh)
    seq = q.shape[1]
    if n < 1 or seq % n:
        raise ValueError(f"sequence length {seq} does not split over {n} ring devices")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    block = seq // n

    def split(t: torch.Tensor) -> List[torch.Tensor]:
        return [t[:, i * block : (i + 1) * block].to(dev) for i, dev in enumerate(mesh)]

    q_blk, k_blk, v_blk = split(q), split(k), split(v)
    pos_blk, valid_blk = split(positions), split(valid)
    kv_pos_blk, kv_valid_blk = list(pos_blk), list(valid_blk)
    batch, _, heads, _ = q.shape
    run_max = [torch.full((batch, heads, block), _NEG_INF, dtype=torch.float32, device=d) for d in mesh]
    run_sum = [torch.zeros((batch, heads, block), dtype=torch.float32, device=d) for d in mesh]
    run_out = [torch.zeros(q_blk[i].shape, dtype=torch.float32, device=d) for i, d in enumerate(mesh)]
    for step in range(n):
        for i in range(n):
            blk_max, blk_sum, blk_out = _attend_block(
                q_blk[i], k_blk[i], v_blk[i], pos_blk[i], kv_pos_blk[i],
                valid_blk[i], kv_valid_blk[i], scale, causal,
            )
            new_max = torch.maximum(run_max[i], blk_max)
            old_scale = torch.exp(run_max[i] - new_max)
            blk_scale = torch.exp(blk_max - new_max)
            run_sum[i] = run_sum[i] * old_scale + blk_sum * blk_scale
            run_out[i] = (
                run_out[i] * old_scale.transpose(1, 2)[..., None]
                + blk_out.to(torch.float32) * blk_scale.transpose(1, 2)[..., None]
            )
            run_max[i] = new_max
        if step == n - 1:
            break
        # Rotate K/V (and their positions / masks) one hop: i -> i + 1.
        k_blk, v_blk, kv_pos_blk, kv_valid_blk = (
            [blocks[i - 1].to(mesh[i]) for i in range(n)]
            for blocks in (k_blk, v_blk, kv_pos_blk, kv_valid_blk)
        )
    outs = [
        (run_out[i] / torch.clamp(run_sum[i], min=1e-30).transpose(1, 2)[..., None])
        .to(q.dtype).to(q.device)
        for i in range(n)
    ]
    return torch.cat(outs, dim=1)


def full_attention_reference(
    q, k, v, positions, valid, scale: Optional[float] = None, causal: bool = True
) -> torch.Tensor:
    """Single-device exact attention, the numerical oracle
    (``ring_attention.py:162``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, blk_sum, blk_out = _attend_block(q, k, v, positions, positions, valid, valid, scale, causal)
    out = blk_out.to(torch.float32) / torch.clamp(blk_sum, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)

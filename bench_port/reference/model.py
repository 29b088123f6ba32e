"""The plain reference: a pre-norm decoder's forward pass in float32.

RMSNorm ``x * w``, rotary embeddings on the half-split layout, grouped-query
attention written out as a softmax over a causal mask, a SwiGLU feed-forward
block and an untied head.  No kernel, no cache manager, no batching: one
sequence at a time, with an optional shared prefix whose keys and values its
continuations attend to.  It follows the architecture as published for the
two configurations of this benchmark (Mistral-7B-v0.3, DeepSeek-LLM-7B);
the one departure is that the weights are the seeded random ones of
``weights.py``, passed through the same weight quantization as the system
under test (or a coarser one for the control).

Jobs run layer by layer: each layer's weights are drawn and dequantized
once and applied to every job, so the full-precision model never exists at
once.  Matrix products run in float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch

from .weights import draw_layer, draw_table

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


@dataclasses.dataclass
class Job:
    """One sequence, and the positions whose next-token logits are wanted.

    ``rows`` = (lo, hi): logits at prefix positions lo..hi-1 (position p
    predicts token p + 1).  Each branch continues the prefix; a branch of
    length L gives L rows: the prefix's last position, then its own first
    L - 1 positions, so row i predicts branch token i."""

    prefix: List[int]
    rows: tuple = (0, 0)
    branches: List[List[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class JobLogits:
    prefix: torch.Tensor  # (hi - lo, V) float32
    branches: List[torch.Tensor]  # (L_b, V) float32 each


def _quantize(w: torch.Tensor, axis: int, bits: Optional[int]) -> torch.Tensor:
    """Symmetric absmax quantization per output channel (reduced over
    ``axis``), dequantized back to float32; ``bits=None`` keeps ``w``."""
    w32 = w.to(torch.float32)
    if bits is None:
        return w32
    qmax = float(2 ** (bits - 1) - 1)
    absmax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    return torch.clamp(torch.round(w32 / scale), -qmax, qmax) * scale


class Weights:
    """The seeded weights as the reference reads them: drawn in the
    configuration's dtype, quantized to ``bits`` (8 for the reference as the
    configuration states, 4 for the control, None for none), float32."""

    def __init__(self, cfg: Dict, seed: int, device, bits: Optional[int]):
        self.cfg, self.seed, self.device, self.bits = cfg, seed, torch.device(device), bits
        self.dtype = _DTYPES[cfg["dtype"]]

    def layer(self, index: int) -> Dict[str, torch.Tensor]:
        drawn = draw_layer(self.cfg, self.seed, index, self.device, self.dtype)
        return {k: _quantize(v, 0, self.bits) for k, v in drawn.items()}

    def table(self, name: str) -> torch.Tensor:
        return _quantize(draw_table(self.cfg, self.seed, name, self.device, self.dtype), -1, self.bits)


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    # The norms' scales are ones (weights.norm_scale), so x * w is x.
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (S, H, hd) on the half-split layout."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angle = positions.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(angle)[:, None, :], torch.sin(angle)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _block(cfg, w, x, start: int, past=None, query_chunk: int = 1024):
    """One decoder layer over a run of tokens at positions start.., after
    ``past`` keys and values (which every token sees).  -> (x, (k, v))."""
    s = x.shape[0]
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    pos = torch.arange(start, start + s, device=x.device)
    a = _rms(x, cfg["rms_eps"])
    q = _rope((a @ w["wq"]).view(s, h, hd), pos, cfg["rope_theta"])
    k = _rope((a @ w["wk"]).view(s, kv, hd), pos, cfg["rope_theta"])
    v = (a @ w["wv"]).view(s, kv, hd)
    keys, values = (k, v) if past is None else (torch.cat([past[0], k]), torch.cat([past[1], v]))
    n_past = keys.shape[0] - s
    keys_h = keys.repeat_interleave(h // kv, dim=1)
    values_h = values.repeat_interleave(h // kv, dim=1)
    out = torch.empty((s, h, hd), dtype=torch.float32, device=x.device)
    key_pos = torch.arange(keys.shape[0], device=x.device)
    for lo in range(0, s, query_chunk):
        hi = min(s, lo + query_chunk)
        logits = torch.einsum("qhd,khd->hqk", q[lo:hi], keys_h) * hd ** -0.5
        causal = key_pos[None, :] <= (n_past + torch.arange(lo, hi, device=x.device))[:, None]
        logits = logits.masked_fill(~causal[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1), values_h)
    x = x + out.reshape(s, h * hd) @ w["wo"]
    f = _rms(x, cfg["rms_eps"])
    x = x + (torch.nn.functional.silu(f @ w["w_gate"]) * (f @ w["w_up"])) @ w["w_down"]
    return x, (k, v)


@contextlib.contextmanager
def full_float32():
    """Float32 products in float32: TF32 off while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def run(cfg: Dict, weights: Weights, jobs: List[Job]) -> List[JobLogits]:
    """Every job's wanted logits, in float32."""
    device = weights.device
    with full_float32():
        embed = weights.table("embed")
        xs = [embed[torch.tensor(j.prefix, device=device)] for j in jobs]
        bxs = [[embed[torch.tensor(b, device=device)] for b in j.branches] for j in jobs]
        del embed
        for index in range(cfg["n_layers"]):
            w = weights.layer(index)
            for j, job in enumerate(jobs):
                xs[j], past = _block(cfg, w, xs[j], 0)
                bxs[j] = [
                    _block(cfg, w, bx, len(job.prefix), past)[0] for bx in bxs[j]
                ]
            del w
        head = weights.table("lm_head")
        out = []
        for j, job in enumerate(jobs):
            lo, hi = job.rows
            rows = _rms(xs[j][lo:hi], cfg["rms_eps"]) @ head.T
            last = _rms(xs[j][-1:], cfg["rms_eps"])
            branches = [
                torch.cat([last, _rms(bx[:-1], cfg["rms_eps"])]) @ head.T for bx in bxs[j]
            ]
            out.append(JobLogits(prefix=rows, branches=branches))
        return out

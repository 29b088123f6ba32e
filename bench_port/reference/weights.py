"""Seeded weights, drawn on the device one layer at a time.

Both sides of the benchmark read the same draws: the harness hands them to
the system under test, which quantizes them to int8, and the reference
draws them again after the window and works out its own int8 (or, for the
control, int4) weights from them.  Each layer has a generator of its own,
seeded from (seed, layer), so either side can draw any layer alone.

The distributions follow the usual random initialisation of a pre-norm
decoder: every projection N(0, 1/d_in), the embedding N(0, 0.02^2), norm
scales 1.  The untied head keeps the published vocabulary and is drawn
N(0, 1/d_model) with two row scales: the printable ASCII bytes, the ids
that served text is made of, at ``SERVED_HEAD_SCALE`` (their logits
N(0, 36)) and every other id at ``QUIET_HEAD_SCALE``.  So a served token is
printable ASCII all but always (the other ids share about 1e-5 of the mass)
and no generation ends at a random EOS: every seed decodes the same number
of tokens and sends text of the same length to be scored, while the head's
product and the sampler still run over the whole vocabulary.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

from .text import N_SPECIAL

#: Row scales of the head (over 1/sqrt(d_model)).
SERVED_HEAD_SCALE = 6.0
QUIET_HEAD_SCALE = 0.01
#: The printable ASCII bytes' ids in the byte tokenizer (space to tilde).
SERVED_IDS = (N_SPECIAL + 0x20, N_SPECIAL + 0x7F)


def layer_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, int]]]:
    """A layer's projections in drawing order, each with (d_in, d_out)."""
    d, h, kv, hd, f = (
        cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["ffn_hidden"]
    )
    return [
        ("wq", (d, h * hd)),
        ("wk", (d, kv * hd)),
        ("wv", (d, kv * hd)),
        ("wo", (h * hd, d)),
        ("w_gate", (d, f)),
        ("w_up", (d, f)),
        ("w_down", (f, d)),
    ]


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and a label."""
    digest = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _generator(device: torch.device, seed: int, *parts) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(stream_seed(seed, *parts))
    return generator


def draw_layer(
    cfg: Dict, seed: int, layer: int, device: torch.device, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s projections, (d_in, d_out) each, in ``dtype``: one
    draw of every element of the layer, then a slice and a scale each."""
    shapes = layer_shapes(cfg)
    total = sum(a * b for _, (a, b) in shapes)
    flat = torch.randn(
        total, generator=_generator(device, seed, "layer", layer), device=device,
        dtype=torch.float32,
    )
    out, at = {}, 0
    for name, (d_in, d_out) in shapes:
        part = flat[at : at + d_in * d_out].view(d_in, d_out)
        out[name] = (part * d_in ** -0.5).to(dtype)
        at += d_in * d_out
    del flat
    return out


def draw_table(
    cfg: Dict, seed: int, name: str, device: torch.device, dtype: torch.dtype
) -> torch.Tensor:
    """The (vocab, d_model) ``embed`` or ``lm_head`` table in ``dtype``."""
    flat = torch.randn(
        (cfg["vocab_size"], cfg["d_model"]), generator=_generator(device, seed, name),
        device=device, dtype=torch.float32,
    )
    if name == "embed":
        return (flat * 0.02).to(dtype)
    rows = torch.full((cfg["vocab_size"], 1), QUIET_HEAD_SCALE, device=device)
    rows[SERVED_IDS[0] : SERVED_IDS[1]] = SERVED_HEAD_SCALE
    return (flat * (rows * cfg["d_model"] ** -0.5)).to(dtype)


def norm_scale(cfg: Dict, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A norm's scale at its identity value (``x * w`` style: ones)."""
    return torch.ones((cfg["d_model"],), dtype=dtype, device=device)

"""Weight-only int8 quantization for the inference path (PyTorch port).

Counterpart of ``consensus_tpu/models/quant.py``.  Scheme: symmetric absmax
per output channel.  For a (d_in, d_out) matmul weight the contraction axis
is d_in, so scales are (1, d_out); the (V, D) embedding / head matrix uses
per-vocab-row scales (V, 1) shared by the row lookup and the head
projection.  Values are clipped to [-127, 127] and rounded half to even
(``torch.round``, like ``jnp.round``).

The JAX package leaves the int8 product to XLA, which fuses the int8 ->
bf16 convert into the dot's operand read.  Here the product is a plain
``torch.matmul`` on the converted weight: int8 values are exact in bf16, the
per-output-channel scale multiplies the float32 product, and the result
returns in the activation dtype.  (On the GPU a bf16 ``matmul`` rounds its
float32 accumulator to bf16 before the scale is applied -- one extra
rounding that XLA's ``preferred_element_type=f32`` avoids.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

QUANTIZED_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


#: float32(1 / 127), held exactly in a Python float.
_INV_127 = (torch.tensor(1.0, dtype=torch.float32) / 127.0).item()


@dataclasses.dataclass
class QTensor:
    """An int8 weight + float32 per-channel scales, posing as one tensor."""

    q: torch.Tensor  # int8, original weight shape
    scale: torch.Tensor  # float32, contraction axis reduced to 1
    compute_dtype: torch.dtype

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype

    @property
    def shape(self):
        return self.q.shape


def quantize(w: torch.Tensor, contract_axis: int, scale_by_reciprocal: bool = False) -> QTensor:
    """Symmetric absmax int8 quantization with scales per output channel
    (``quant.py:65-73`` of the JAX package).

    The scale is ``absmax / 127``.  PyTorch's CPU kernel divides, as the JAX
    package's eager ``quantize`` does; its CUDA kernel, given a Python
    scalar divisor, multiplies by float32(1/127) instead, which is what XLA
    compiles the JAX package's jitted ``quantize_params`` into (its
    backends and its ingest run it jitted).  The two differ by an ulp in
    about 5% of the scales.  ``scale_by_reciprocal`` takes the product on
    every device: the checkpoint routes use it, so an int8 checkpoint does
    not depend on where it was quantized and equals the JAX backend's."""
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=contract_axis, keepdim=True)
    scaled = absmax * _INV_127 if scale_by_reciprocal else absmax / 127.0
    scale = torch.where(absmax > 0, scaled, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale, compute_dtype=w.dtype)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain (d_in, d_out) tensor or a QTensor."""
    if isinstance(w, QTensor):
        if w.q.ndim != 2 or w.scale.shape[-2] != 1:
            raise ValueError(
                f"matmul expects a 2-D weight with per-output-channel scales "
                f"(1, d_out); got q {tuple(w.q.shape)}, scale {tuple(w.scale.shape)}"
            )
        y = torch.matmul(x, w.q.to(x.dtype)).to(torch.float32)
        return (y * w.scale.reshape(-1)).to(x.dtype)
    return x @ w


def take_rows(w, idx: torch.Tensor) -> torch.Tensor:
    """Row gather (embedding lookup) for plain or quantized (V, D) tables."""
    if isinstance(w, QTensor):
        rows = w.q[idx].to(torch.float32) * w.scale[idx]
        return rows.to(w.compute_dtype)
    return w[idx]


def slice_rows(w, start: int, size: int):
    """Row slice of a (V, D) table -> (rows, scales-or-None); int8 rows keep
    their (size, 1) scales so the caller applies them to the f32 tile."""
    if isinstance(w, QTensor):
        return w.q[start : start + size], w.scale[start : start + size]
    return w[start : start + size], None


def head_matmul(hidden: torch.Tensor, head) -> torch.Tensor:
    """``hidden @ head.T`` for a plain or quantized (V, D) head -> float32
    logits (..., V).  The product runs in float32 (the JAX package asks XLA
    for a float32 result; a bf16 product would round every logit to bf16)."""
    h32 = hidden.to(torch.float32)
    if isinstance(head, QTensor):
        return torch.matmul(h32, head.q.to(torch.float32).t()) * head.scale[:, 0]
    return torch.matmul(h32, head.to(torch.float32).t())


def gather_target_logits(x: torch.Tensor, head, tokens: torch.Tensor) -> torch.Tensor:
    """Per-position dot of hidden states (B, S, D) with the head rows of
    ``tokens`` (B, S) -> float32 (B, S), rounded like :func:`head_matmul`."""
    if isinstance(head, QTensor):
        rows = head.q[tokens].to(torch.float32)
        dots = (x.to(torch.float32) * rows).sum(-1)
        return dots * head.scale[tokens, 0]
    return (x.to(torch.float32) * head[tokens].to(torch.float32)).sum(-1)


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every large matmul weight of a parameter dict.

    Layer weights are (d_in, d_out) per layer: contraction axis 0, scales
    (1, d_out).  The (V, D) embedding and untied lm_head quantize over D for
    per-row scales."""
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        for key in QUANTIZED_LAYER_KEYS:
            layer[key] = quantize(layer[key], contract_axis=0)
        layers.append(layer)
    out["layers"] = layers
    out["embed"] = quantize(params["embed"], contract_axis=-1)
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"], contract_axis=-1)
    return out


def is_quantized(params: Dict[str, Any]) -> bool:
    return isinstance(params.get("embed"), QTensor)


"""Convert a JAX parameter pytree, as numpy arrays, into the port's dict.

The JAX package stacks layer weights on a leading axis, ``(n_layers, d_in,
d_out)``, and wraps int8 weights in a ``QTensor`` pytree node with ``q``
and ``scale`` children.  The port keeps the same per-layer layouts, split
into a list of per-layer dicts.  Any object with ``q`` and ``scale``
attributes counts as an int8 weight, so the caller may pass the JAX tree
after ``jax.tree.map(np.asarray, params)`` without this module importing
anything of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.quant import QTensor


def tensor_from_numpy(array, device: torch.device | str = "cpu") -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch tensor on ``device``."""
    array = np.array(array)  # a writable copy: JAX hands out read-only buffers
    if array.dtype.name == "bfloat16":
        t = torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(array)
    return t.to(device)


def _is_qtensor(leaf: Any) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "scale")


def _leaf(leaf, device, index=None):
    """One (optionally layer-indexed) leaf -> tensor or QTensor."""
    if _is_qtensor(leaf):
        q = np.asarray(leaf.q)
        scale = np.asarray(leaf.scale)
        if index is not None:
            q, scale = q[index], scale[index]
        dtype_name = str(getattr(leaf, "compute_dtype", "float32"))
        compute = torch.bfloat16 if "bfloat16" in dtype_name else torch.float32
        return QTensor(
            q=tensor_from_numpy(q, device),
            scale=tensor_from_numpy(scale.astype(np.float32), device),
            compute_dtype=compute,
        )
    array = np.asarray(leaf)
    return tensor_from_numpy(array[index] if index is not None else array, device)


def params_from_jax(
    np_tree: Dict[str, Any], config: ModelConfig, device: torch.device | str = "cpu"
) -> Dict[str, Any]:
    """JAX pytree (numpy leaves, stacked layers) -> the port's parameters."""
    layers_in = np_tree["layers"]
    layers = [
        {key: _leaf(value, device, index=i) for key, value in layers_in.items()}
        for i in range(config.n_layers)
    ]
    params: Dict[str, Any] = {
        "embed": _leaf(np_tree["embed"], device),
        "layers": layers,
        "final_norm": _leaf(np_tree["final_norm"], device),
    }
    if "lm_head" in np_tree:
        params["lm_head"] = _leaf(np_tree["lm_head"], device)
    return params

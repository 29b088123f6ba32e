"""The system under test, built from a configuration file and a seed.

Weights come from ``reference/weights.py``'s seeded draws, layer by layer in
the configuration's dtype; each layer is quantized as soon as it is drawn by
the program's own int8 scheme (``models.quant.quantize``, the step its
random-weight and checkpoint routes take per tensor), so the
full-precision model never exists at once.  The backend is
``TorchBackend`` with the configuration's options, behind a ``CallTimer``
and one ``BatchingBackend`` (the flush-snapshot path that ``Experiment``'s
concurrent mode runs).

The backend is built on its checkpoint route, which serves the model's own
vocabulary (the byte tokenizer then uses the first ids), with the weights
handed in as ``params``, so nothing is read from the checkpoint's path.
Its random-weight route would size the vocabulary to the tokenizer's 268
ids instead.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from bench_port.reference.weights import draw_layer, draw_table, norm_scale

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def model_config(cfg: Dict[str, Any]):
    from consensus_tpu_torch.models.config import ModelConfig

    fields = dict(cfg["model"])
    fields["local_layer_pattern"] = tuple(fields["local_layer_pattern"])
    if fields.get("rope_scaling") is not None:
        fields["rope_scaling"] = tuple(fields["rope_scaling"])
    return ModelConfig(**fields)


def flat_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The sizes the reference reads: the model's fields and the dtype."""
    return {**cfg["model"], "dtype": cfg["backend"]["dtype"]}


def build_params(cfg: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    from consensus_tpu_torch.models.quant import quantize

    flat = flat_config(cfg)
    dtype = _DTYPES[flat["dtype"]]
    int8 = cfg["backend"].get("quantization") == "int8"

    def prepare(w: torch.Tensor, axis: int):
        return quantize(w, contract_axis=axis) if int8 else w

    layers = []
    for index in range(flat["n_layers"]):
        drawn = draw_layer(flat, seed, index, device, dtype)
        layer = {name: prepare(w, 0) for name, w in drawn.items()}
        del drawn
        layer["attn_norm"] = norm_scale(flat, device, dtype)
        layer["ffn_norm"] = norm_scale(flat, device, dtype)
        layers.append(layer)
    return {
        "embed": prepare(draw_table(flat, seed, "embed", device, dtype), -1),
        "lm_head": prepare(draw_table(flat, seed, "lm_head", device, dtype), -1),
        "final_norm": norm_scale(flat, device, dtype),
        "layers": layers,
    }


def build_backend(cfg: Dict[str, Any], seed: int, device: torch.device, max_batch_rows: int):
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    options = dict(cfg["backend"])
    return TorchBackend(
        model=cfg["model"]["name"],
        config=model_config(cfg),
        params=build_params(cfg, seed, device),
        checkpoint=cfg["source"],
        device=str(device),
        max_batch_rows=max_batch_rows,
        **options,
    )

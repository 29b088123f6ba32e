"""Save and restore model parameters in the port's own checkpoint format
(PyTorch port of ``consensus_tpu/utils/checkpoint.py``).

The JAX package writes orbax checkpoints, which the port cannot read.  The
port writes one safetensors file, ``model.safetensors``, into the checkpoint
directory, with its own writer (``utils/safetensors_io.py``):

* the parameter dict is flattened to dotted names: ``embed``,
  ``final_norm``, ``lm_head``, ``layers.<i>.<key>``;
* an int8 weight (``models/quant.py::QTensor``) is stored as its two
  tensors, ``<name>.q`` (int8) and ``<name>.scale`` (float32), and comes
  back as the same QTensor, with no quantize pass;
* the file's metadata names the format (:data:`FORMAT`) and, for each
  QTensor, its compute dtype.

Restoring places every tensor straight on the requested device.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

import torch

from consensus_tpu_torch.models.quant import QTensor
from consensus_tpu_torch.utils import safetensors_io

#: The format's name, in the file's metadata and in an ingest manifest.
FORMAT = "consensus_tpu_torch.safetensors.v1"
PARAMS_FILE = "model.safetensors"

_DTYPE_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def flatten_params(params: Dict[str, Any]):
    """(dotted name -> tensor, QTensor name -> compute dtype name)."""
    tensors: Dict[str, torch.Tensor] = {}
    qtensors: Dict[str, str] = {}

    def put(name: str, leaf) -> None:
        if isinstance(leaf, QTensor):
            tensors[name + ".q"] = leaf.q
            tensors[name + ".scale"] = leaf.scale
            qtensors[name] = _dtype_name(leaf.compute_dtype)
        else:
            tensors[name] = leaf

    for key, value in params.items():
        if key == "layers":
            for i, layer in enumerate(value):
                for name, leaf in layer.items():
                    put(f"layers.{i}.{name}", leaf)
        else:
            put(key, value)
    return tensors, qtensors


def save_params(path: str, params: Dict[str, Any]) -> int:
    """Write a parameter dict into the checkpoint directory ``path``;
    returns the bytes written."""
    target = pathlib.Path(path)
    target.mkdir(parents=True, exist_ok=True)
    tensors, qtensors = flatten_params(params)
    metadata = {"format": FORMAT, "qtensors": json.dumps(qtensors, sort_keys=True)}
    return safetensors_io.save_file(tensors, target / PARAMS_FILE, metadata)


def restore_params(path: str, device: torch.device | str = "cpu") -> Dict[str, Any]:
    """Read a checkpoint directory written by :func:`save_params` back into
    the parameter dict, every tensor on ``device``."""
    file = pathlib.Path(path) / PARAMS_FILE
    if not file.exists():
        raise FileNotFoundError(
            f"{path} holds no {PARAMS_FILE}: not a checkpoint in the port's format "
            f"({FORMAT})"
        )
    _, metadata, _ = safetensors_io.read_header(file)
    if metadata.get("format") != FORMAT:
        raise ValueError(f"{file} is not in the port's checkpoint format {FORMAT}")
    qtensors = json.loads(metadata.get("qtensors", "{}"))
    flat = {name: tensor.to(device) for name, tensor in safetensors_io.iter_tensors(file)}

    leaves: Dict[str, Any] = {}
    for name, dtype_name in qtensors.items():
        leaves[name] = QTensor(
            q=flat.pop(name + ".q"), scale=flat.pop(name + ".scale"),
            compute_dtype=_DTYPE_NAMES[dtype_name],
        )
    leaves.update(flat)

    params: Dict[str, Any] = {}
    layers: Dict[int, Dict[str, Any]] = {}
    for name, leaf in leaves.items():
        if name.startswith("layers."):
            _, index, key = name.split(".", 2)
            layers.setdefault(int(index), {})[key] = leaf
        else:
            params[name] = leaf
    out: Dict[str, Any] = {"embed": params.pop("embed"),
                           "layers": [layers[i] for i in range(len(layers))],
                           "final_norm": params.pop("final_norm")}
    out.update(params)
    return out

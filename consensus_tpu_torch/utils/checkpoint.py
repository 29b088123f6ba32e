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

Restoring places every tensor straight on the requested device, or, with
a mesh plan's shardings, each piece on the devices that hold it.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional

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


def _unflatten(leaves: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted names -> the parameter dict (``layers`` a list)."""
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


def _check_template(template: Dict[str, Any], header: Dict[str, dict], file) -> None:
    """Every leaf of ``template`` is in the file with its shape and dtype,
    and the file holds no other tensor (``checkpoint.py:42-53``)."""
    want, _ = flatten_params(template)
    problems = []
    for name in sorted(set(want) | set(header)):
        if name not in header:
            problems.append(f"{name}: missing from the checkpoint")
        elif name not in want:
            problems.append(f"{name}: not in the template")
        else:
            entry = header[name]
            shape = tuple(int(d) for d in entry["shape"])
            dtype = safetensors_io.DTYPES.get(entry["dtype"])
            if shape != tuple(want[name].shape) or dtype != want[name].dtype:
                problems.append(
                    f"{name}: checkpoint {entry['dtype']}{list(shape)} vs template "
                    f"{want[name].dtype}{list(want[name].shape)}"
                )
    if problems:
        raise ValueError(f"{file} does not match the template: " + "; ".join(problems))


def restore_params(
    path: str,
    device: torch.device | str = "cpu",
    template: Optional[Dict[str, Any]] = None,
    shardings: Optional[Dict[str, Any]] = None,
) -> Any:
    """Read a checkpoint directory written by :func:`save_params` back into
    the parameter dict, every tensor on ``device`` (``checkpoint.py:28``).

    ``template`` (a parameter dict, any device, ``meta`` included) checks
    each leaf's shape and dtype before anything is read.  ``shardings``
    (``parallel.mesh.param_shardings`` of a mesh plan) places each leaf per
    the plan straight from the file and returns one tree per grid position,
    ``trees[d][t]``, as ``parallel.mesh.shard_params`` does: a piece that
    several positions hold (a dp replica) is read once and copied to each
    device once, and a tp slice reads only its own rows or columns."""
    file = pathlib.Path(path) / PARAMS_FILE
    if not file.exists():
        raise FileNotFoundError(
            f"{path} holds no {PARAMS_FILE}: not a checkpoint in the port's format "
            f"({FORMAT})"
        )
    header, metadata, base = safetensors_io.read_header(file)
    if metadata.get("format") != FORMAT:
        raise ValueError(f"{file} is not in the port's checkpoint format {FORMAT}")
    qtensors = json.loads(metadata.get("qtensors", "{}"))
    if template is not None:
        _check_template(template, header, file)

    def assemble(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        leaves: Dict[str, Any] = {}
        for name, dtype_name in qtensors.items():
            leaves[name] = QTensor(
                q=flat.pop(name + ".q"), scale=flat.pop(name + ".scale"),
                compute_dtype=_DTYPE_NAMES[dtype_name],
            )
        leaves.update(flat)
        return _unflatten(leaves)

    if shardings is None:
        return assemble(
            {name: tensor.to(device) for name, tensor in safetensors_io.iter_tensors(file)}
        )

    flat_shardings = _flatten_shardings(shardings)
    plan = next(iter(flat_shardings.values())).plan
    pieces: Dict[tuple, torch.Tensor] = {}  # (name, index) -> host piece
    placed: Dict[tuple, torch.Tensor] = {}  # (name, index, device) -> device piece
    trees: List[List[Dict[str, Any]]] = []
    for d, row in enumerate(plan.devices):
        trees.append([])
        for t, dev in enumerate(row):
            flat: Dict[str, torch.Tensor] = {}
            for name in sorted(header):
                if name not in flat_shardings:
                    raise ValueError(f"{file}: tensor {name!r} has no sharding")
                shape = [int(x) for x in header[name]["shape"]]
                index = flat_shardings[name].index(shape, d, t)
                key = (name, repr(index))
                if key not in pieces:
                    pieces[key] = safetensors_io.read_tensor_slice(
                        file, base, name, header[name], index
                    )
                if key + (str(dev),) not in placed:
                    placed[key + (str(dev),)] = pieces[key].to(dev)
                flat[name] = placed[key + (str(dev),)]
            trees[-1].append(assemble(flat))
    return trees


def _flatten_shardings(shardings: Dict[str, Any]) -> Dict[str, Any]:
    """A sharding tree (``param_shardings``) under the file's dotted names."""
    out: Dict[str, Any] = {}

    def put(name: str, leaf) -> None:
        if isinstance(leaf, QTensor):
            out[name + ".q"] = leaf.q
            out[name + ".scale"] = leaf.scale
        else:
            out[name] = leaf

    for key, value in shardings.items():
        if key == "layers":
            for i, layer in enumerate(value):
                for name, leaf in layer.items():
                    put(f"layers.{i}.{name}", leaf)
        else:
            put(key, value)
    return out

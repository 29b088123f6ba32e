"""Read and write the safetensors file format with no library but torch.

A safetensors file is an 8-byte little-endian header length ``N``, then
``N`` bytes of JSON, then the raw tensor bytes.  The JSON maps each tensor
name to ``{"dtype": "BF16", "shape": [...], "data_offsets": [begin, end]}``
(offsets into the byte buffer after the header) and may hold a
``"__metadata__"`` map of strings.  Tensors are stored C-contiguous and
little-endian.

The card's machine has neither the ``safetensors`` package nor
``transformers``, so the loader (``models/loader.py``) and the port's own
checkpoint format (``utils/checkpoint.py``) read and write the format
here.  Each tensor is read straight from the file into a host buffer of its
own dtype and moved from there to its device once.
"""

from __future__ import annotations

import json
import pathlib
import struct
import sys
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

#: safetensors dtype names <-> torch dtypes, for the dtypes the port stores.
DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}

#: A header over this size is not a safetensors header (the format's own cap).
_MAX_HEADER_BYTES = 100 * 1024 * 1024

if sys.byteorder != "little":  # pragma: no cover - every supported host is little-endian
    raise ImportError("safetensors_io reads little-endian tensors on a little-endian host only")


def read_header(path: str | pathlib.Path) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """(tensor entries, metadata, byte offset of the data buffer) of a file."""
    with open(path, "rb") as f:
        prefix = f.read(8)
        if len(prefix) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (length,) = struct.unpack("<Q", prefix)
        if length > _MAX_HEADER_BYTES:
            raise ValueError(f"{path}: header length {length} is not a safetensors header")
        header = json.loads(f.read(length).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    return header, metadata, 8 + length


def _read_tensor(f, base: int, name: str, entry: dict, path) -> torch.Tensor:
    dtype_name = entry["dtype"]
    if dtype_name not in DTYPES:
        raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype_name}")
    dtype = DTYPES[dtype_name]
    shape = [int(s) for s in entry["shape"]]
    begin, end = (int(o) for o in entry["data_offsets"])
    itemsize = torch.empty((), dtype=dtype).element_size()
    numel = 1
    for s in shape:
        numel *= s
    if end - begin != numel * itemsize:
        raise ValueError(
            f"{path}: tensor {name!r} spans {end - begin} bytes, its shape {shape} "
            f"of {dtype_name} needs {numel * itemsize}"
        )
    buffer = torch.empty(end - begin, dtype=torch.uint8)
    f.seek(base + begin)
    if end > begin and f.readinto(buffer.numpy()) != end - begin:
        raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
    return buffer.view(dtype).reshape(shape)


def read_tensor_slice(
    path: str | pathlib.Path, base: int, name: str, entry: dict, index: Tuple[slice, ...]
) -> torch.Tensor:
    """The piece ``tensor[index]`` of one tensor of a file (``base`` and
    ``entry`` from :func:`read_header`), read through a memory map: only the
    bytes of the piece are copied out of the file."""
    import numpy as np

    dtype_name = entry["dtype"]
    if dtype_name not in DTYPES:
        raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype_name}")
    dtype = DTYPES[dtype_name]
    shape = tuple(int(s) for s in entry["shape"])
    begin, _ = (int(o) for o in entry["data_offsets"])
    itemsize = torch.empty((), dtype=dtype).element_size()
    raw = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[itemsize]
    if not all(shape):
        return torch.empty(shape, dtype=dtype)[index].clone()
    mapped = np.memmap(path, dtype=raw, mode="r", offset=base + begin, shape=shape)
    piece = np.array(mapped[index])  # a copy: the map is read-only and closed below
    del mapped
    return torch.from_numpy(piece).view(dtype)


def iter_tensors(path: str | pathlib.Path) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) for every tensor of one file, in name order
    (the order of ``safetensors.safe_open(...).keys()``).  Each tensor is a
    buffer of its own, read when it is yielded."""
    header, _, base = read_header(path)
    with open(path, "rb") as f:
        for name in sorted(header):
            yield name, _read_tensor(f, base, name, header[name], path)


def save_file(
    tensors: Mapping[str, torch.Tensor],
    path: str | pathlib.Path,
    metadata: Optional[Mapping[str, str]] = None,
) -> int:
    """Write ``tensors`` (any device) to ``path`` in the safetensors format;
    returns the bytes written.  Tensors are written in name order, one after
    another; the header is padded with spaces to a multiple of 8 bytes, as
    the format's own writer does, so every tensor starts 8-byte aligned."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    order = sorted(tensors)
    for name in order:
        tensor = tensors[name]
        if tensor.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {tensor.dtype} has no safetensors name")
        nbytes = tensor.numel() * tensor.element_size()
        header[name] = {
            "dtype": _NAMES[tensor.dtype],
            "shape": list(tensor.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            tensor = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if tensor.numel():
                f.write(tensor.view(torch.uint8).numpy())
    return 8 + len(blob) + offset

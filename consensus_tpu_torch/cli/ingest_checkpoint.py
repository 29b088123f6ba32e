"""One-command checkpoint ingest: HF safetensors dir -> the port's own
checkpoint (PyTorch port of ``consensus_tpu/cli/ingest_checkpoint.py``).

It loads the HF directory through the loader (``models/loader.py``),
optionally int8-quantizes, both on the host CPU, and writes ``params`` (the
port's format, ``utils/checkpoint.py``: one safetensors file) plus an
``ingest.json`` manifest.  A ``TorchBackend(checkpoint=<out>)`` then
restores the leaves straight to the card in their stored form, with no
load and quantize pass at every process start.

The manifest's ``format`` key names the port's format.  The JAX package's
ingest writes an orbax ``params`` directory and a manifest without that
key; the port refuses such a directory with an error naming this command
and never tries to read it.

Usage:
    python -m consensus_tpu_torch.cli.ingest_checkpoint \
        --hf-dir /path/to/gemma-2-2b-it --out checkpoints/gemma2-2b-int8 \
        [--model gemma2-2b] [--quantization int8] [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib

logger = logging.getLogger(__name__)

#: The command that writes the port's checkpoints, for error messages.
COMMAND = "python -m consensus_tpu_torch.cli.ingest_checkpoint"


def read_manifest(checkpoint: str | pathlib.Path) -> dict:
    """The ``ingest.json`` of an ingested directory, refusing one the JAX
    package wrote (an orbax checkpoint: no ``format`` key, or another)."""
    from consensus_tpu_torch.utils.checkpoint import FORMAT

    path = pathlib.Path(checkpoint)
    meta = json.loads((path / "ingest.json").read_text())
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path} was ingested in another format ({meta.get('format') or 'orbax'}, "
            f"the JAX package's ingest), which the PyTorch port cannot read; "
            f"re-ingest the HF directory ({meta.get('source', 'its source')}) with "
            f"`{COMMAND} --hf-dir <hf dir> --out <dir>` (format {FORMAT})"
        )
    return meta


def ingest(
    hf_dir: str,
    out: str,
    model: str | None = None,
    quantization: str = "int8",
    dtype: str = "bfloat16",
) -> pathlib.Path:
    import torch

    from consensus_tpu_torch.models.config import get_model_config
    from consensus_tpu_torch.models.loader import infer_config_name, load_params
    from consensus_tpu_torch.utils.checkpoint import FORMAT, save_params

    if model is None:
        model = infer_config_name(hf_dir)
        if model is None:
            raise ValueError(
                f"cannot infer model preset from {hf_dir}/config.json; "
                "pass --model explicitly"
            )
        logger.info("inferred model preset: %s", model)
    config = get_model_config(model)
    torch_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    if quantization not in (None, "none", "int8"):
        raise ValueError(f"unknown quantization: {quantization!r}")

    # Convert on the host CPU: the output must not depend on a card, and the
    # loader quantizes each tensor as it lands, so the full-precision tree
    # never exists at once.
    params = load_params(hf_dir, config, torch_dtype, device="cpu",
                         int8=quantization == "int8")

    out_path = pathlib.Path(out)
    out_path.mkdir(parents=True, exist_ok=True)
    save_params(str(out_path / "params"), params)
    manifest = {
        "format": FORMAT,
        "model": model,
        "quantization": quantization if quantization != "none" else None,
        "dtype": dtype,
        "source": str(pathlib.Path(hf_dir).absolute()),
    }
    (out_path / "ingest.json").write_text(json.dumps(manifest, indent=2))
    logger.info("ingested %s -> %s (%s)", hf_dir, out_path, manifest)
    return out_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hf-dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--model", default=None)
    parser.add_argument("--quantization", default="int8")
    parser.add_argument("--dtype", default="bfloat16")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ingest(args.hf_dir, args.out, args.model, args.quantization, args.dtype)


if __name__ == "__main__":
    main()

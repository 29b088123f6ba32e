"""Load HuggingFace safetensors checkpoints into the port's parameter dict
(PyTorch port of ``consensus_tpu/models/loader.py``).

Maps HF Gemma-2 / Llama-3 parameter names onto the per-layer layout of
:func:`consensus_tpu_torch.models.transformer.init_params`, with the JAX
loader's name map, transposes and errors.  It only reads local files.

HF layouts handled:
  Gemma-2:  model.layers.{i}.self_attn.{q,k,v,o}_proj.weight,
            .mlp.{gate,up,down}_proj.weight,
            .input_layernorm / .post_attention_layernorm /
            .pre_feedforward_layernorm / .post_feedforward_layernorm,
            model.embed_tokens.weight (tied LM head), model.norm.weight
  Llama-3:  same attention/mlp names, input_layernorm /
            post_attention_layernorm only, untied lm_head.weight

The files are read by the port's own safetensors reader
(``utils/safetensors_io.py``): shards ``model-0000k-of-0000n.safetensors``
in name order, bf16 / f16 / f32.  Each tensor goes straight to the target
dtype and device, one at a time, with ``int8`` quantized as soon as it
lands, so neither a float32 copy of the model (the JAX loader's stack of
float32 blanks) nor, with ``int8``, the whole full-precision tree exists at
once.  The int8 scales round as the JAX backend's jitted
``quantize_params`` rounds them, on any device
(``quantize(scale_by_reciprocal=True)``).  Casting a bf16 or f32 tensor
once to the target dtype rounds as the JAX loader's float32 detour does, so
the parameters are the same.  A layer tensor the checkpoint lacks stays
zero, as the JAX loader's blanks do.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional

import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.quant import QUANTIZED_LAYER_KEYS, quantize
from consensus_tpu_torch.utils.safetensors_io import iter_tensors


def _open_safetensors(model_dir: pathlib.Path):
    """Yield (name, CPU tensor) for every tensor across all shards."""
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"No .safetensors files under {model_dir}")
    for file in files:
        yield from iter_tensors(file)


def _layer_shapes(c: ModelConfig) -> Dict[str, tuple]:
    h, kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    shapes = {
        "attn_norm": (c.d_model,),
        "wq": (c.d_model, h * hd),
        "wk": (c.d_model, kv * hd),
        "wv": (c.d_model, kv * hd),
        "wo": (h * hd, c.d_model),
        "ffn_norm": (c.d_model,),
        "w_gate": (c.d_model, c.ffn_hidden),
        "w_up": (c.d_model, c.ffn_hidden),
        "w_down": (c.ffn_hidden, c.d_model),
    }
    if c.use_post_norms:
        shapes["post_attn_norm"] = (c.d_model,)
        shapes["post_ffn_norm"] = (c.d_model,)
    return shapes


def load_params(
    model_dir: str,
    config: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
    int8: bool = False,
) -> Dict[str, Any]:
    """Read a local HF checkpoint directory into the port's parameters, on
    ``device`` in ``dtype``; with ``int8`` every matmul weight is quantized
    as the JAX backend's jitted ``quantize_params`` quantizes the loaded
    tree (and as the port's ``quantize_params`` does on the card)."""
    model_dir_path = pathlib.Path(model_dir)
    c = config
    device = torch.device(device)
    shapes = _layer_shapes(c)
    layers = [{} for _ in range(c.n_layers)]
    params: Dict[str, Any] = {"layers": layers}

    # HF stores projections as (out, in); the runtime right-multiplies, so
    # every matrix is transposed on the way in.
    proj_map = {
        "self_attn.q_proj.weight": ("wq", True),
        "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True),
        "self_attn.o_proj.weight": ("wo", True),
        "mlp.gate_proj.weight": ("w_gate", True),
        "mlp.up_proj.weight": ("w_up", True),
        "mlp.down_proj.weight": ("w_down", True),
        "input_layernorm.weight": ("attn_norm", False),
        "post_attention_layernorm.weight": (
            "post_attn_norm" if c.use_post_norms else "ffn_norm",
            False,
        ),
        "pre_feedforward_layernorm.weight": ("ffn_norm", False),
        "post_feedforward_layernorm.weight": ("post_ffn_norm", False),
    }

    def place(tensor: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        tensor = tensor.to(device)
        if transpose:
            tensor = tensor.t()
        return tensor.to(dtype).contiguous()

    def table(tensor: torch.Tensor):
        """The (V, D) embedding or head: per-row scales under int8."""
        tensor = place(tensor)
        return quantize(tensor, contract_axis=-1, scale_by_reciprocal=True) if int8 else tensor

    for name, tensor in _open_safetensors(model_dir_path):
        if name == "model.embed_tokens.weight":
            params["embed"] = table(tensor)
            continue
        if name == "model.norm.weight":
            params["final_norm"] = place(tensor)
            continue
        if name == "lm_head.weight":
            if not c.tie_lm_head:  # a tied head reads the embedding
                params["lm_head"] = table(tensor)
            continue
        if not name.startswith("model.layers."):
            continue
        rest = name[len("model.layers."):]
        layer_str, suffix = rest.split(".", 1)
        layer_idx = int(layer_str)
        if suffix not in proj_map:
            continue
        target, transpose = proj_map[suffix]
        if target not in shapes:
            # A Gemma-2 norm in a checkpoint read as Llama: the JAX loader
            # fails on the missing stack with this KeyError too.
            raise KeyError(target)
        value = place(tensor, transpose)
        if tuple(value.shape) != shapes[target]:
            raise ValueError(
                f"Checkpoint at {model_dir}: {name} has shape {tuple(tensor.shape)}, "
                f"{c.name} wants {shapes[target]} for {target}"
            )
        if int8 and target in QUANTIZED_LAYER_KEYS:
            value = quantize(value, contract_axis=0, scale_by_reciprocal=True)
        layers[layer_idx][target] = value

    if "embed" not in params:
        raise ValueError(f"Checkpoint at {model_dir} missing model.embed_tokens.weight")
    if "final_norm" not in params:
        raise ValueError(f"Checkpoint at {model_dir} missing model.norm.weight")
    if not c.tie_lm_head and "lm_head" not in params:
        raise ValueError(f"Checkpoint at {model_dir} missing lm_head.weight (untied head)")

    for layer in layers:
        for key, shape in shapes.items():
            if key not in layer:
                blank = torch.zeros(shape, dtype=dtype, device=device)
                layer[key] = (
                    quantize(blank, contract_axis=0, scale_by_reciprocal=True)
                    if int8 and key in QUANTIZED_LAYER_KEYS else blank
                )
    ordered = {"embed": params["embed"], "layers": layers, "final_norm": params["final_norm"]}
    if "lm_head" in params:
        ordered["lm_head"] = params["lm_head"]
    return ordered


def infer_config_name(model_dir: str) -> Optional[str]:
    """Guess the preset name from an HF config.json, if present."""
    config_file = pathlib.Path(model_dir) / "config.json"
    if not config_file.exists():
        return None
    hf = json.loads(config_file.read_text())
    model_type = hf.get("model_type", "")
    hidden = hf.get("hidden_size")
    if model_type == "gemma2":
        return {2304: "gemma2-2b", 3584: "gemma2-9b"}.get(hidden)
    if model_type == "llama":
        return {4096: "llama3-8b"}.get(hidden)
    return None

"""The port's HF checkpoint loader and safetensors reader against the JAX
package's loader and the ``safetensors`` library.

Tiny HF Gemma-2 (tied head, four norms a layer) and Llama-3 (untied head,
two norms) models are built with ``transformers`` and saved with
``save_pretrained``, as ``tests/test_hf_numerics.py`` does; the same
directory goes through ``consensus_tpu.models.loader.load_params`` and
``consensus_tpu_torch.models.loader.load_params``.  Tolerances: params
exactly equal (float32 and bfloat16 targets, and int8 against the JAX
package's jitted ``quantize_params`` of its loaded tree); logits of the two transformers on
those params within 1e-4 absolute (float32 forwards summed in different
orders).  The port's reader equals ``safetensors.safe_open`` exactly over
bf16 / f16 / f32 (and the int8 / int32 / bool the port's own format
stores) and over shards; the loader raises what the JAX loader raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as torch_save_file

from consensus_tpu.models import transformer as jax_transformer
from consensus_tpu.models.config import get_model_config as jax_model_config
from consensus_tpu.models.loader import infer_config_name as jax_infer_config_name
from consensus_tpu.models.loader import load_params as jax_load_params
from consensus_tpu.models.quant import quantize_params as jax_quantize_params
from consensus_tpu.models.transformer import init_params as jax_init_params
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.loader import infer_config_name, load_params
from consensus_tpu_torch.models.quant import QTensor, quantize_params
from consensus_tpu_torch.models.transformer import forward
from consensus_tpu_torch.utils import safetensors_io
from tests.test_hf_numerics import _hf_tiny_gemma2, _hf_tiny_llama3, _save_hf_model
from tests.test_loader import _export_hf

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4
HF_MODELS = {"tiny-gemma2": _hf_tiny_gemma2, "tiny-llama3": _hf_tiny_llama3}


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    return {
        name: _save_hf_model(build(), tmp_path_factory.mktemp(name))
        for name, build in HF_MODELS.items()
    }


def _leaves(params):
    """(name, tensor) pairs of the port's parameter dict, QTensors split."""
    out = {}
    for key, value in params.items():
        items = (
            [(f"layers.{i}.{k}", v) for i, layer in enumerate(value) for k, v in layer.items()]
            if key == "layers" else [(key, value)]
        )
        for name, leaf in items:
            if isinstance(leaf, QTensor):
                out[name + ".q"], out[name + ".scale"] = leaf.q, leaf.scale
            else:
                out[name] = leaf
    return out


def assert_params_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        assert torch.equal(la[name], lb[name]), name


def _jax_to_port(jax_params, model):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), get_model_config(model))


@pytest.mark.parametrize("model", sorted(HF_MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_equal_jax_loader(hf_dirs, model, dtype):
    ref = jax_load_params(hf_dirs[model], jax_model_config(model), getattr(jnp, dtype))
    got = load_params(hf_dirs[model], get_model_config(model), getattr(torch, dtype))
    assert ("lm_head" in got) == (not get_model_config(model).tie_lm_head)
    assert_params_equal(got, _jax_to_port(ref, model))


@pytest.mark.parametrize("model", sorted(HF_MODELS))
def test_logits_match_jax(hf_dirs, model):
    config = get_model_config(model)
    rng = np.random.default_rng(42)
    tokens = rng.integers(0, config.vocab_size, size=(2, 48))
    positions = np.broadcast_to(np.arange(48), (2, 48)).copy()
    valid = np.ones((2, 48), dtype=bool)
    valid[0, :7] = False  # left padding, positions restarting at the first real token
    positions[0] = np.concatenate([np.zeros(7, int), np.arange(41)])
    ref_params = jax_load_params(hf_dirs[model], jax_model_config(model), jnp.float32)
    expect, _ = jax_transformer.forward(
        ref_params, jax_model_config(model), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(positions, jnp.int32), jnp.asarray(valid),
    )
    params = load_params(hf_dirs[model], config, torch.float32)
    got, _ = forward(params, config, torch.from_numpy(tokens), torch.from_numpy(positions),
                     torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(expect)[valid], atol=LOGIT_ATOL)


@pytest.mark.parametrize("model", sorted(HF_MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_load_equals_quantize_params(hf_dirs, model, dtype):
    """int8 as it lands equals the JAX package's jitted ``quantize_params``
    of its loaded tree (what its backend and ingest run), bit for bit, and
    differs from the port's CPU ``quantize_params`` (a true division) by at
    most one rounding of a scale."""
    config = get_model_config(model)
    quantized = load_params(hf_dirs[model], config, getattr(torch, dtype), int8=True)
    ref = jax.jit(jax_quantize_params)(
        jax_load_params(hf_dirs[model], jax_model_config(model), getattr(jnp, dtype)))
    assert_params_equal(quantized, _jax_to_port(ref, model))
    divided = quantize_params(load_params(hf_dirs[model], config, getattr(torch, dtype)))
    scales = [(a.scale, b.scale) for a, b in zip(
        [quantized["embed"]] + [layer["wq"] for layer in quantized["layers"]],
        [divided["embed"]] + [layer["wq"] for layer in divided["layers"]])]
    for a, b in scales:
        torch.testing.assert_close(a, b, rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("model", sorted(HF_MODELS))
def test_sharded_export_roundtrip(tmp_path, model):
    """The JAX test's HF exporter at 3 shards: both loaders read the
    JAX-initialized params back exactly."""
    config = jax_model_config(model)
    params = jax_init_params(config, jax.random.PRNGKey(1))
    _export_hf(params, config, tmp_path, shards=3)
    assert len(list(tmp_path.glob("model-*-of-00003.safetensors"))) == 3
    got = load_params(str(tmp_path), get_model_config(model), torch.float32)
    assert_params_equal(got, _jax_to_port(params, model))
    assert_params_equal(got, _jax_to_port(jax_load_params(str(tmp_path), config, jnp.float32),
                                          model))


_READER_CASES = {
    "bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
    "i8": torch.int8, "i32": torch.int32, "bool": torch.bool,
}


@pytest.mark.parametrize("name", sorted(_READER_CASES))
def test_reader_equals_safe_open(tmp_path, name):
    dtype = _READER_CASES[name]
    gen = torch.Generator().manual_seed(len(name))
    base = {
        "a.weight": torch.randn(5, 7, generator=gen) * 40,
        "b": torch.randn(3, generator=gen),
        "c.scalar": torch.randn((), generator=gen),
        "d.empty": torch.randn(0, 4, generator=gen),
    }
    tensors = {k: v.to(dtype) for k, v in base.items()}
    files = []
    for shard, keys in enumerate((["a.weight", "c.scalar"], ["b", "d.empty"])):
        path = tmp_path / f"model-{shard + 1:05d}-of-00002.safetensors"
        torch_save_file({k: tensors[k] for k in keys}, str(path), metadata={"format": "pt"})
        files.append(path)
    seen = {}
    for path in files:
        with safe_open(str(path), framework="pt") as f:
            ref = {k: f.get_tensor(k) for k in f.keys()}
            names = list(f.keys())
        got = dict(safetensors_io.iter_tensors(path))
        assert list(got) == names
        for k in names:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            assert torch.equal(got[k], ref[k]), k
        seen.update(got)
        assert safetensors_io.read_header(path)[1] == {"format": "pt"}
    assert sorted(seen) == sorted(tensors)
    # ... and the port's writer is read back by the library.
    out = tmp_path / "ours.safetensors"
    nbytes = safetensors_io.save_file(tensors, out, metadata={"k": "v"})
    assert nbytes == out.stat().st_size
    with safe_open(str(out), framework="pt") as f:
        assert f.metadata() == {"k": "v"}
        for k in tensors:
            assert torch.equal(f.get_tensor(k), tensors[k]), k


def test_reader_refuses_a_short_file(tmp_path):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(b"\x10\x00\x00")
    with pytest.raises(ValueError, match="too short"):
        list(safetensors_io.iter_tensors(path))


def _both_raise(path, model):
    with pytest.raises(Exception) as ref:
        jax_load_params(str(path), jax_model_config(model))
    with pytest.raises(type(ref.value)) as got:
        load_params(str(path), get_model_config(model))
    assert str(got.value) == str(ref.value)
    return got.value


def test_missing_embed_raises(tmp_path):
    config = get_model_config("tiny-gemma2")
    np_save_file({"model.norm.weight": np.zeros((config.d_model,), np.float32)},
                 str(tmp_path / "model.safetensors"))
    assert "embed_tokens" in str(_both_raise(tmp_path, "tiny-gemma2"))


def test_missing_norm_raises(tmp_path):
    config = get_model_config("tiny-gemma2")
    np_save_file({"model.embed_tokens.weight": np.zeros((config.vocab_size, config.d_model),
                                                        np.float32)},
                 str(tmp_path / "model.safetensors"))
    assert "model.norm.weight" in str(_both_raise(tmp_path, "tiny-gemma2"))


def test_untied_head_required(tmp_path):
    config = get_model_config("tiny-llama3")
    params = jax_init_params(jax_model_config("tiny-llama3"), jax.random.PRNGKey(4))
    np_save_file({
        "model.embed_tokens.weight": np.asarray(params["embed"], np.float32),
        "model.norm.weight": np.asarray(params["final_norm"], np.float32),
    }, str(tmp_path / "model.safetensors"))
    assert config.tie_lm_head is False
    assert "lm_head" in str(_both_raise(tmp_path, "tiny-llama3"))


def test_no_safetensors_raises(tmp_path):
    assert "No .safetensors" in str(_both_raise(tmp_path, "tiny-gemma2"))


def test_gemma2_norms_read_as_llama_raise(hf_dirs, tmp_path):
    """A Gemma-2 checkpoint (four norms a layer) read with a Llama config
    (two): both loaders fail on the post-feed-forward norm."""
    import shutil

    shutil.copytree(hf_dirs["tiny-gemma2"], tmp_path / "g", dirs_exist_ok=True)
    error = _both_raise(tmp_path / "g", "tiny-llama3")
    assert isinstance(error, (KeyError, ValueError))


@pytest.mark.parametrize(
    "hf_config,expected",
    [
        ({"model_type": "gemma2", "hidden_size": 2304}, "gemma2-2b"),
        ({"model_type": "gemma2", "hidden_size": 3584}, "gemma2-9b"),
        ({"model_type": "llama", "hidden_size": 4096}, "llama3-8b"),
        ({"model_type": "mistral", "hidden_size": 4096}, None),
    ],
)
def test_infer_config_name(hf_config, expected, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(hf_config))
    assert infer_config_name(str(tmp_path)) == expected == jax_infer_config_name(str(tmp_path))


def test_infer_config_name_no_file(tmp_path):
    assert infer_config_name(str(tmp_path)) is None

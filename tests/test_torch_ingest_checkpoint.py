"""Checkpoint ingest (HF dir -> the port's int8 safetensors checkpoint) and
``TorchBackend(checkpoint=...)`` against the JAX package's
``TPUBackend(checkpoint=...)``, as ``tests/test_ingest_checkpoint.py``
pins the JAX loop.

A tiny HF Gemma-2 directory (``save_pretrained``) goes three ways: the
port's raw-HF route, the port's ingest + restore, and the JAX backend's
raw-HF route.  The port's two routes must hold bit-equal params and give
identical scores and tokens; against JAX, score logprobs within 1e-4
absolute (float32 forwards summed in different orders) and generated ids
equal where every greedy pick's top-two margin exceeds 1e-3.  Manifest
mismatches raise as the JAX backend's do; a directory the JAX package
ingested (orbax) raises an error naming the port's ingest command; with
a checkpoint the vocab is the model's, not the tokenizer's.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.cli.ingest_checkpoint import ingest as jax_ingest
from consensus_tpu_torch.backends import get_backend
from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.cli import ingest_checkpoint
from consensus_tpu_torch.cli.ingest_checkpoint import ingest
from consensus_tpu_torch.models.quant import QTensor, is_quantized
from consensus_tpu_torch.utils.checkpoint import FORMAT, restore_params, save_params
from tests.test_torch_loader import assert_params_equal

torch.set_num_threads(1)

ATOL = 1e-4
MARGIN = 1e-3
MODEL = "tiny-gemma2"
OPTIONS = dict(model=MODEL, dtype="float32", max_context=128)
SCORES = [
    ScoreRequest(context="The town", continuation=" voted today"),
    ScoreRequest(context="Issue: bikes", continuation="Yes, build them.", role="user"),
    ScoreRequest(context="raw", continuation=" text", chat=False),
]
PROMPTS = [GenerationRequest(user_prompt=p, max_tokens=8, temperature=0.0, seed=1)
           for p in ("Hi", "Should the city add bike lanes?")]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from tests.test_hf_numerics import _hf_tiny_gemma2, _save_hf_model

    return _save_hf_model(_hf_tiny_gemma2(), tmp_path_factory.mktemp("hf"))


@pytest.fixture(scope="module")
def ingested(hf_dir, tmp_path_factory):
    return ingest(hf_dir, str(tmp_path_factory.mktemp("ing") / "out"), model=MODEL,
                  quantization="int8", dtype="float32")


def test_ingest_writes_manifest_and_params(ingested, hf_dir):
    meta = json.loads((ingested / "ingest.json").read_text())
    assert meta == {"format": FORMAT, "model": MODEL, "quantization": "int8",
                    "dtype": "float32", "source": str(pathlib.Path(hf_dir).absolute())}
    assert (ingested / "params" / "model.safetensors").exists()
    assert is_quantized(restore_params(str(ingested / "params")))


def test_restored_backend_matches_hf_loaded(hf_dir, ingested):
    direct = TorchBackend(checkpoint=hf_dir, quantization="int8", device="cpu", **OPTIONS)
    restored = TorchBackend(checkpoint=str(ingested), quantization="int8", device="cpu",
                            **OPTIONS)
    assert is_quantized(restored.params)  # restored already int8, no re-pass
    assert_params_equal(restored.params, direct.params)
    for a, b in zip(direct.score(SCORES), restored.score(SCORES)):
        assert a.tokens == b.tokens and a.logprobs == b.logprobs
    assert [r.token_ids for r in direct.generate(PROMPTS)] == [
        r.token_ids for r in restored.generate(PROMPTS)]


def _greedy_margins(backend, request, ids):
    """The top-two logit margin at every greedy step of ``ids``."""
    from consensus_tpu_torch.models.transformer import forward

    prompt = backend.tokenizer.encode(backend._render_prompt(request))
    seq = torch.tensor([list(prompt) + list(ids)])
    positions = torch.arange(seq.shape[1])[None]
    logits, _ = forward(backend.params, backend.config, seq, positions,
                        torch.ones_like(seq, dtype=torch.bool))
    steps = logits[0, len(prompt) - 1: len(prompt) - 1 + len(ids)]
    top = torch.topk(steps, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


@pytest.mark.parametrize("quantization", ["int8", None])
def test_port_checkpoint_matches_jax_backend(hf_dir, tmp_path, quantization):
    ref = TPUBackend(checkpoint=hf_dir, quantization=quantization, shared_context_scoring=False,
                     **OPTIONS)
    out = ingest(hf_dir, str(tmp_path / "ing"), model=MODEL,
                 quantization=quantization or "none", dtype="float32")
    for checkpoint in (hf_dir, str(out)):
        port = TorchBackend(checkpoint=checkpoint, quantization=quantization,
                            shared_context_scoring=False, device="cpu", **OPTIONS)
        assert port.config.vocab_size == ref.config.vocab_size == 512
        for e, g in zip(ref.score(SCORES), port.score(SCORES)):
            assert g.tokens == e.tokens
            np.testing.assert_allclose(g.logprobs, e.logprobs, atol=ATOL)
        expect = ref.generate(PROMPTS)
        got = port.generate(PROMPTS)
        compared = 0
        for request, e, g in zip(PROMPTS, expect, got):
            margins = _greedy_margins(port, request, g.token_ids)
            if min(margins, default=1.0) > MARGIN:
                assert g.token_ids == e.token_ids
                assert g.text == e.text
                compared += 1
        assert compared >= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_params_equal_the_jax_backends(hf_dir, dtype):
    """The raw-HF route with int8: the port quantizes each tensor as it
    lands, JAX's backend jits ``quantize_params`` over the loaded tree; the
    int8 values and scales are the same bit for bit."""
    import jax

    from consensus_tpu_torch.models.convert import params_from_jax

    options = dict(OPTIONS, dtype=dtype)
    port = TorchBackend(checkpoint=hf_dir, quantization="int8", device="cpu", **options)
    ref = TPUBackend(checkpoint=hf_dir, quantization="int8", **options)
    assert_params_equal(port.params,
                        params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config))


def test_checkpoint_keeps_the_models_vocab(hf_dir):
    """The JAX backend resizes the vocab to the tokenizer's only without a
    checkpoint (``tpu.py:197``): the byte tokenizer then uses the first
    268 of tiny-gemma2's 512 ids."""
    port = TorchBackend(checkpoint=hf_dir, device="cpu", **OPTIONS)
    ref = TPUBackend(checkpoint=hf_dir, **OPTIONS)
    assert port.config.vocab_size == ref.config.vocab_size == 512
    assert port.tokenizer.vocab_size == ref.tokenizer.vocab_size == 268
    random = TorchBackend(device="cpu", **OPTIONS)
    assert random.config.vocab_size == TPUBackend(**OPTIONS).config.vocab_size == 268


@pytest.mark.parametrize("field, options, match", [
    ("model", dict(OPTIONS, model="tiny-llama3"), "model: ingested 'tiny-gemma2'"),
    ("dtype", dict(OPTIONS, dtype="bfloat16"), "dtype: ingested 'float32'"),
    ("quantization", dict(OPTIONS), "quantization: ingested 'int8' vs backend None"),
])
def test_manifest_mismatch_raises(ingested, field, options, match):
    quantization = options.pop("quantization", None) if field == "quantization" else "int8"
    with pytest.raises(ValueError, match="does not match this backend") as got:
        TorchBackend(checkpoint=str(ingested), quantization=quantization, device="cpu", **options)
    assert match in str(got.value)
    with pytest.raises(ValueError) as ref:
        TPUBackend(checkpoint=str(ingested), quantization=quantization, **options)
    assert str(got.value) == str(ref.value)


def test_orbax_directory_raises_naming_the_ports_ingest(hf_dir, tmp_path, monkeypatch):
    out = jax_ingest(hf_dir, str(tmp_path / "orbax"), model=MODEL, quantization="int8",
                     dtype="float32")
    assert (out / "params").is_dir() and "format" not in json.loads(
        (out / "ingest.json").read_text())

    def never(*args, **kwargs):
        raise AssertionError("the port tried to read an orbax checkpoint")

    monkeypatch.setattr("consensus_tpu_torch.utils.checkpoint.restore_params", never)
    with pytest.raises(ValueError, match="python -m consensus_tpu_torch.cli.ingest_checkpoint"):
        TorchBackend(checkpoint=str(out), quantization="int8", device="cpu", **OPTIONS)


def test_checkpoint_reaches_the_backend_through_get_backend(hf_dir, ingested):
    spec = {"name": "tpu", "checkpoint": str(ingested), "quantization": "int8",
            "device": "cpu", **OPTIONS}
    backend = get_backend(spec)
    assert isinstance(backend, TorchBackend) and is_quantized(backend.params)
    direct = get_backend("torch", checkpoint=hf_dir, tokenizer="byte", device="cpu", **OPTIONS)
    assert direct.config.vocab_size == 512 and not is_quantized(direct.params)


def test_save_restore_roundtrip_keeps_qtensors(tmp_path):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(8, 4, generator=gen)
    from consensus_tpu_torch.models.quant import quantize

    params = {
        "embed": quantize(torch.randn(16, 8, generator=gen).to(torch.bfloat16), contract_axis=-1),
        "layers": [{"wq": quantize(w.to(torch.bfloat16), contract_axis=0),
                    "attn_norm": torch.ones(8, dtype=torch.bfloat16)} for _ in range(2)],
        "final_norm": torch.zeros(8, dtype=torch.bfloat16),
        "lm_head": torch.randn(16, 8, generator=gen),
    }
    nbytes = save_params(str(tmp_path / "params"), params)
    assert nbytes == (tmp_path / "params" / "model.safetensors").stat().st_size
    back = restore_params(str(tmp_path / "params"))
    assert isinstance(back["layers"][1]["wq"], QTensor)
    assert back["layers"][1]["wq"].compute_dtype == torch.bfloat16
    assert_params_equal(back, params)
    assert list(back) == ["embed", "layers", "final_norm", "lm_head"]


def test_ingest_cli(hf_dir, tmp_path):
    ingest_checkpoint.main(["--hf-dir", hf_dir, "--out", str(tmp_path / "cli"),
                            "--model", MODEL, "--quantization", "none", "--dtype", "float32"])
    meta = json.loads((tmp_path / "cli" / "ingest.json").read_text())
    assert meta["quantization"] is None and meta["format"] == FORMAT
    restored = TorchBackend(checkpoint=str(tmp_path / "cli"), device="cpu", **OPTIONS)
    direct = TorchBackend(checkpoint=hf_dir, device="cpu", **OPTIONS)
    assert_params_equal(restored.params, direct.params)

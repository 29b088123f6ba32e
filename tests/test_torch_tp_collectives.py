"""Tensor parallelism's collectives and containers (``consensus_tpu_torch/
parallel/tensor.py``) and the sharded forward's scoring against the JAX
package's: the port of ``tests/test_parallel.py::
test_sharded_scoring_matches_single_device`` (its inputs, atol 2e-4) at
tp=2 and at dp=2 x tp=2, the streamed route against the materialised one,
the collectives' determinism and gradients, and the divisibility check
(a tp need not divide the query or kv heads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.models.config import get_model_config as jax_get_model_config
from consensus_tpu.models.transformer import init_params as jax_init_params
from consensus_tpu.models.transformer import token_logprobs as jax_token_logprobs
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.transformer import (
    forward,
    token_logprobs,
    token_logprobs_streamed,
)
from consensus_tpu_torch.parallel import (
    Ranked,
    TPParams,
    all_reduce,
    check_tp,
    gather_vocab,
    kv_heads_of_rank,
    local_config,
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
    tp_params,
)
from consensus_tpu_torch.parallel.tensor import kv_zeros

torch.set_num_threads(1)

ATOL = 2e-4
TINY_MODELS = ["tiny-gemma2", "tiny-llama3"]


@pytest.fixture(scope="module", params=TINY_MODELS)
def scoring_case(request):
    """The JAX test's model, params and (8, 16) token batch, and JAX's
    unsharded logprobs (equal to its sharded ones, which it pins)."""
    cfg = jax_get_model_config(request.param)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab_size, jnp.int32)
    valid = jnp.ones((8, 16), jnp.bool_)
    expected = np.asarray(jax_token_logprobs(params, cfg, tokens, valid))
    port = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    return (get_model_config(request.param), port, torch.from_numpy(np.array(tokens)),
            torch.from_numpy(np.array(valid)), expected)


def test_sharded_scoring_tp2_matches_jax(scoring_case):
    config, params, tokens, valid, expected = scoring_case
    sharded = tp_params(params, config, ["cpu", "cpu"])
    got = token_logprobs(sharded, config, tokens, valid)
    np.testing.assert_allclose(got.numpy(), expected, atol=ATOL)


def test_sharded_scoring_dp2_tp2_matches_jax(scoring_case):
    """Both mesh axes: the rows split over dp=2, each block scored by its
    shard's tp=2 ranks, the blocks gathered in row order."""
    config, params, tokens, valid, expected = scoring_case
    plan = make_mesh(["cpu"] * 4, tp=2)
    trees = shard_params(params, plan)
    blocks_t, blocks_v = shard_batch(plan, tokens, valid)
    got = torch.cat([
        token_logprobs(TPParams(ranks=tuple(trees[d]), devices=plan.devices[d]), config, t, v)
        for d, (t, v) in enumerate(zip(blocks_t, blocks_v))
    ])
    np.testing.assert_allclose(got.numpy(), expected, atol=ATOL)


@pytest.mark.parametrize("vocab_chunk", [64, 100])
def test_streamed_route_matches_materialised(scoring_case, vocab_chunk):
    """The per-rank streaming logsumexp merged on the lead equals the full
    (B, S, V) log-softmax, whatever tile width splits the vocab slices."""
    config, params, tokens, valid, expected = scoring_case
    sharded = tp_params(params, config, ["cpu", "cpu"])
    streamed = token_logprobs_streamed(sharded, config, tokens, valid, vocab_chunk=vocab_chunk)
    full = token_logprobs(sharded, config, tokens, valid)
    np.testing.assert_allclose(streamed.numpy(), full.numpy(), atol=1e-5)
    np.testing.assert_allclose(streamed.numpy(), expected, atol=ATOL)


def test_tp1_tree_keeps_its_forward(scoring_case):
    """A plain dict runs the unsharded code: tp_params over one device is
    a TPParams whose forward gives the same logits to float tolerance,
    while the plain dict itself is bit-identical run to run."""
    config, params, tokens, valid, _ = scoring_case
    positions = torch.arange(16, dtype=torch.int32)[None].expand(8, 16)
    a, _ = forward(params, config, tokens, positions, valid)
    b, _ = forward(params, config, tokens, positions, valid)
    assert torch.equal(a, b)
    c, _ = forward(tp_params(params, config, ["cpu"]), config, tokens, positions, valid)
    np.testing.assert_allclose(c.numpy(), a.numpy(), atol=1e-5)


def test_all_reduce_sums_in_rank_order_onto_every_rank():
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(5, 7, generator=gen) for _ in range(4)]
    out = all_reduce(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert len(out) == 4
    for o in out:
        assert torch.equal(o, want)  # bit-identical replicas
    assert torch.equal(all_reduce(parts)[0], out[0])  # deterministic


def test_gather_vocab_and_replicate():
    slices = [torch.full((2, 3), float(t)) for t in range(3)]
    full = gather_vocab(slices)
    assert full.shape == (2, 9)
    assert torch.equal(full[:, 3:6], slices[1])
    copies = replicate(full, [torch.device("cpu")] * 2)
    assert all(c is full for c in copies)


def test_collectives_are_differentiable():
    """gradcheck (float64) through all_reduce and gather_vocab as written:
    no custom backward."""
    gen = torch.Generator().manual_seed(1)
    a, b = (torch.randn(3, 4, dtype=torch.float64, generator=gen, requires_grad=True)
            for _ in range(2))

    def reduced(x, y):
        first, second = all_reduce([x * 2.0, y.sin()])
        return first * second

    assert torch.autograd.gradcheck(reduced, (a, b))

    def gathered(x, y):
        return gather_vocab([x, y.exp()]).logsumexp(dim=-1)

    assert torch.autograd.gradcheck(gathered, (a, b))


def test_ranked_maps_over_ranks():
    """Indexing, assignment, torch functions, methods and arithmetic run on
    every rank's part; a plain tensor argument is a replicated input."""
    parts = [torch.arange(24.0).reshape(2, 3, 4) + 100 * t for t in range(2)]
    r = Ranked([p.clone() for p in parts])
    assert r.shape == (2, 3, 4) and r.dtype == torch.float32
    idx = torch.tensor([1, 0])
    gathered = r[idx]
    assert isinstance(gathered, Ranked)
    for t in range(2):
        assert torch.equal(gathered.parts[t], parts[t][idx])
    joined = torch.cat([r, torch.zeros(2, 1, 4)], dim=1)
    assert joined.shape == (2, 4, 4) and torch.equal(joined.parts[1][:, :3], parts[1])
    r[:, 0] = torch.ones(2, 4)
    assert all(torch.equal(p[:, 0], torch.ones(2, 4)) for p in r.parts)
    scaled = (r * 2.0 - 1.0).index_select(0, idx)
    assert torch.equal(scaled.parts[1], (r.parts[1] * 2.0 - 1.0)[idx])
    values, scales = (r.abs().amax(dim=-1, keepdim=True), torch.round(r / 3.0))
    assert isinstance(values, Ranked) and isinstance(scales, Ranked)


def test_kv_zeros_holds_local_heads_per_rank():
    config = get_model_config("tiny-llama3")
    params = tp_params(
        {"embed": torch.zeros(config.vocab_size, config.d_model),
         "final_norm": torch.zeros(config.d_model), "layers": []},
        config, ["cpu", "cpu"],
    )
    shape = (config.n_layers, 3, 5, config.n_kv_heads, config.head_dim)
    z = kv_zeros(params, shape, torch.float32, "cpu")
    assert isinstance(z, Ranked) and len(z.parts) == 2
    assert all(p.shape == (config.n_layers, 3, 5, config.n_kv_heads // 2, config.head_dim)
               and p.is_contiguous() for p in z.parts)
    plain = kv_zeros({"embed": torch.zeros(1)}, shape, torch.float32, "cpu")
    assert isinstance(plain, torch.Tensor) and plain.shape == shape


def test_local_config_divides_heads_ffn_and_vocab():
    config = get_model_config("llama3-8b")
    local = local_config(config, 4)
    assert (local.n_heads, local.n_kv_heads, local.ffn_hidden, local.vocab_size) == (
        8, 2, config.ffn_hidden // 4, config.vocab_size // 4)
    assert local.head_dim == config.head_dim and local.q_scale == config.q_scale
    assert local_config(config, 1) is config


@pytest.mark.parametrize("model, tp, divisor", [
    ("tiny-llama3", 3, "n_heads"), ("tiny-gemma2", 4, "n_kv_heads"),
    ("llama3-8b", 16, "n_kv_heads"), ("tiny-llama3", 8, "n_heads"),
])
def test_a_tp_that_does_not_divide_raises(model, tp, divisor):
    """A tp that does not divide the query columns ``n_heads*head_dim``
    raises naming them; one that cuts a query head builds at the model
    level (each rank holds a copy of the head it cuts, ``q_heads_of_rank``),
    and the backend then raises where the byte tokenizer's vocab of 268
    does not split, as ``TPUBackend`` does.  One that does not divide the
    kv heads passes: each rank holds the one kv head its query heads read
    (``kv_heads_of_rank``), and a tiny model builds."""
    config = get_model_config(model)
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    if divisor == "n_kv_heads":
        check_tp(config, tp)
        local = local_config(config, tp)
        assert (local.n_heads, local.n_kv_heads) == (config.n_heads // tp, 1)
        assert [kv_heads_of_rank(config, tp, r)
                for r in range(tp)] == [(r * config.n_kv_heads // tp,) for r in range(tp)]
        if model.startswith("tiny"):
            backend = TorchBackend(model=model, config=config, device="cpu",
                                   mesh_devices=["cpu"] * tp, tp=tp)
            assert backend._tp == tp and backend.params.kv_heads == 1
        return
    if config.n_heads * config.head_dim % tp:
        with pytest.raises(ValueError, match=r"n_heads\*head_dim=64"):
            check_tp(config, tp)
        with pytest.raises(ValueError, match=r"n_heads\*head_dim"):
            TorchBackend(model=model, config=config, device="cpu",
                         mesh_devices=["cpu"] * tp, tp=tp)
        return
    check_tp(config, tp)
    assert config.n_heads % tp and local_config(config, tp).n_heads == 1
    params = params_from_jax(
        jax.tree.map(np.asarray, jax_init_params(jax_get_model_config(model),
                                                 jax.random.PRNGKey(0))), config)
    tokens = torch.randint(0, config.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    valid = torch.ones_like(tokens, dtype=torch.bool)
    np.testing.assert_allclose(
        token_logprobs(tp_params(params, config, ["cpu"] * tp), config, tokens, valid).numpy(),
        token_logprobs(params, config, tokens, valid).numpy(), atol=2e-4)
    with pytest.raises(ValueError, match="vocab_size=268"):
        TorchBackend(model=model, device="cpu", mesh_devices=["cpu"] * tp, tp=tp)


def test_isolation_covers_the_tensor_module():
    from tests.test_torch_isolation import _modules

    assert "consensus_tpu_torch.parallel.tensor" in _modules()

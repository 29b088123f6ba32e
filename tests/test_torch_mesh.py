"""The port's device mesh and layout rules (``consensus_tpu_torch/parallel/
mesh.py``) against the JAX package's on its 8 virtual CPU devices
(``tests/conftest.py``): the ports of ``tests/test_parallel.py:26-50`` and
``tests/test_mesh_serving.py:55-120``, each shard of ``shard_params``
bit-equal to the matching JAX shard, and ``shard_batch``'s row blocks."""

import jax
import numpy as np
import pytest
import torch

from consensus_tpu.models.config import get_model_config as jax_get_model_config
from consensus_tpu.models.quant import quantize_params as jax_quantize_params
from consensus_tpu.models.transformer import init_params as jax_init_params
from consensus_tpu.parallel import make_mesh as jax_make_mesh
from consensus_tpu.parallel import parse_mesh_spec as jax_parse_mesh_spec
from consensus_tpu.parallel import shard_batch as jax_shard_batch
from consensus_tpu.parallel import shard_params as jax_shard_params
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.quant import QTensor
from consensus_tpu_torch.parallel import (
    PARTITION_RULES,
    make_mesh,
    match_partition_rules,
    param_shardings,
    parse_mesh_spec,
    shard_batch,
    shard_params,
)
from consensus_tpu_torch.parallel.mesh import MODEL_AXIS, MeshPlan

TINY_MODELS = ["tiny-gemma2", "tiny-llama3"]
CPU8 = ["cpu"] * 8


def _port_params(cfg_name, int8=False):
    cfg = jax_get_model_config(cfg_name)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    if int8:
        params = jax_quantize_params(params)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg)


class TestMeshSpec:
    def test_make_mesh_shapes(self):
        plan = make_mesh(CPU8, tp=2)
        ref = jax_make_mesh(tp=2)
        assert (plan.dp, plan.tp, plan.n_devices) == (ref.dp, ref.tp, ref.n_devices) == (4, 2, 8)
        assert all(d == torch.device("cpu") for row in plan.devices for d in row)

    def test_explicit_dp_uses_the_first_devices(self):
        plan = make_mesh(CPU8, tp=1, dp=3)
        ref = jax_make_mesh(tp=1, dp=3)
        assert (plan.dp, plan.tp) == (ref.dp, ref.tp) == (3, 1)

    @pytest.mark.parametrize("kwargs", [{"tp": 3}, {"tp": 2, "dp": 5}, {"tp": 0}])
    def test_make_mesh_refusals(self, kwargs):
        with pytest.raises(ValueError):
            make_mesh(CPU8, **kwargs)
        if kwargs.get("tp"):
            with pytest.raises(ValueError):
                jax_make_mesh(**kwargs)

    def test_a_card_may_repeat(self):
        plan = make_mesh(["cpu", "cpu"], tp=1)
        assert plan.dp == 2 and plan.distinct_devices == 1

    def test_no_card_and_no_devices_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()

    @pytest.mark.parametrize("spec", [None, "dp=4,tp=2", "tp=2", {"dp": 3}, "dp=2, tp=1,",
                                      {"tp": 4}])
    def test_parse_accepts_what_jax_accepts(self, spec):
        assert parse_mesh_spec(spec) == jax_parse_mesh_spec(spec)

    def test_parse_keeps_a_plan_sizes(self):
        plan = make_mesh(CPU8, tp=2)
        assert parse_mesh_spec(plan) == jax_parse_mesh_spec(jax_make_mesh(tp=2)) == {
            "dp": 4, "tp": 2}
        assert isinstance(plan, MeshPlan)

    @pytest.mark.parametrize("spec", ["replicas=4", {"dp": 0}, "dp", "dp=1,tp=-2", {"pp": 2}])
    def test_parse_rejects_what_jax_rejects(self, spec):
        with pytest.raises(ValueError):
            jax_parse_mesh_spec(spec)
        with pytest.raises(ValueError):
            parse_mesh_spec(spec)


@pytest.mark.parametrize("cfg_name", TINY_MODELS)
class TestPartitionRules:
    def test_rules_are_the_jax_rules(self, cfg_name):
        from consensus_tpu.parallel.mesh import PARTITION_RULES as JAX_RULES

        assert [(p, tuple(s)) for p, s in PARTITION_RULES] == [
            (p, tuple(s)) for p, s in JAX_RULES]

    def test_rules_cover_every_param_path(self, cfg_name):
        cfg, jax_params, params = _port_params(cfg_name)
        from consensus_tpu.parallel import match_partition_rules as jax_match

        specs = match_partition_rules(params)
        want = jax_match(jax_params)
        assert len(specs["layers"]) == cfg.n_layers
        for layer in specs["layers"]:
            assert set(layer) == set(want["layers"])
            for key, spec in layer.items():
                assert tuple(spec) == tuple(want["layers"][key])[1:], key
        for key in set(want) - {"layers"}:
            assert tuple(specs[key]) == tuple(want[key]), key
        assert tuple(specs["layers"][0]["wq"])[-1] == MODEL_AXIS
        assert tuple(specs["layers"][0]["wo"])[0] == MODEL_AXIS
        assert tuple(specs["embed"])[0] == MODEL_AXIS

    def test_unmatched_param_path_fails_loudly(self, cfg_name):
        _, _, params = _port_params(cfg_name)
        params["layers"][0]["mystery_weight"] = torch.ones(4, 4)
        params["other"] = torch.ones(3, 3)
        with pytest.raises(ValueError, match="layers/mystery_weight, other"):
            match_partition_rules(params)

    def test_int8_scale_spec(self, cfg_name):
        """QTensor q shards like the weight; squeezed scale axes replicate,
        as the JAX package's ``_leaf_sharding`` gives them."""
        from consensus_tpu.parallel import param_shardings as jax_param_shardings

        _, jax_q, qparams = _port_params(cfg_name, int8=True)
        shardings = param_shardings(qparams, make_mesh(CPU8, tp=2))
        want = jax_param_shardings(jax_q, jax_make_mesh(tp=2).mesh)
        for key in ("wq", "wo", "w_down"):
            got = shardings["layers"][0][key]
            assert isinstance(got, QTensor)
            assert tuple(got.q.spec) == tuple(want["layers"][key].q.spec)[1:]
            assert tuple(got.scale.spec) == tuple(want["layers"][key].scale.spec)[1:]
        assert all(a is None for a in shardings["layers"][0]["wo"].scale.spec)
        assert tuple(shardings["embed"].scale.spec) == tuple(want["embed"].scale.spec)


def _jax_positions(mesh):
    return {dev.id: idx for idx, dev in np.ndenumerate(mesh.devices)}


def _check_shards(jax_leaf, port_trees, getter, positions):
    """Every JAX shard of ``jax_leaf`` equals the port's tree at its grid
    position (``getter(tree)`` -> the port leaf or, for layer leaves, the
    list of per-layer leaves)."""
    for shard in jax_leaf.addressable_shards:
        d, t = positions[shard.device.id]
        got = getter(port_trees[d][t])
        data = np.asarray(shard.data)
        if isinstance(got, list):
            got = np.stack([g.numpy() for g in got])
        else:
            got = got.numpy()
        assert got.shape == data.shape
        np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("cfg_name", TINY_MODELS)
@pytest.mark.parametrize("dp, tp, int8", [(4, 2, False), (8, 1, False), (4, 2, True)])
def test_shard_params_equal_jax_addressable_shards(cfg_name, dp, tp, int8):
    _, jax_params, params = _port_params(cfg_name, int8=int8)
    jax_plan = jax_make_mesh(tp=tp, dp=dp)
    sharded = jax_shard_params(jax_params, jax_plan.mesh)
    trees = shard_params(params, make_mesh(CPU8, tp=tp, dp=dp))
    assert len(trees) == dp and all(len(row) == tp for row in trees)
    positions = _jax_positions(jax_plan.mesh)
    for key, leaf in sharded["layers"].items():
        parts = (("q", lambda x: x.q), ("scale", lambda x: x.scale)) if int8 and hasattr(
            leaf, "q") else (("", lambda x: x),)
        for _, pick in parts:
            _check_shards(pick(leaf), trees,
                          lambda tree, k=key, f=pick: [f(layer[k]) for layer in tree["layers"]],
                          positions)
    for key in set(sharded) - {"layers"}:
        leaf = sharded[key]
        picks = (lambda x: x.q, lambda x: x.scale) if hasattr(leaf, "q") else (lambda x: x,)
        for pick in picks:
            _check_shards(pick(leaf), trees, lambda tree, k=key, f=pick: f(tree[k]), positions)
    # dp replicas over one device share one tree.
    assert trees[0][0] is trees[1][0]


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_shard_batch_blocks(dp):
    rng = np.random.default_rng(dp)
    tokens = rng.integers(0, 100, (16, 12)).astype(np.int32)
    valid = rng.random((16, 12)) > 0.3
    jax_plan = jax_make_mesh(tp=1, dp=dp)
    jt, jv = jax_shard_batch(jax_plan.mesh, tokens, valid)
    pt, pv = shard_batch(make_mesh(CPU8, tp=1, dp=dp), torch.from_numpy(tokens),
                         torch.from_numpy(valid))
    positions = _jax_positions(jax_plan.mesh)
    for jax_arr, blocks in ((jt, pt), (jv, pv)):
        assert len(blocks) == dp
        for shard in jax_arr.addressable_shards:
            d, _ = positions[shard.device.id]
            np.testing.assert_array_equal(blocks[d].numpy(), np.asarray(shard.data))
    np.testing.assert_array_equal(torch.cat(pt).numpy(), tokens)

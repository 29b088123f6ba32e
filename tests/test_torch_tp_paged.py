"""The paged serving programs under tensor parallelism against the JAX
package's under its dp=4 x tp=2 mesh: the port of ``tests/
test_mesh_serving.py::TestShardedPagedPrograms`` (prefill -> 3 greedy
decodes -> gather, tokens equal, rtol/atol 2e-4), with the port's page pool
per rank (each rank's kv heads on its own pages under one host-side table),
on both tiny models, plus the K-step window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.models import stepper as jax_stepper
from consensus_tpu.models.config import get_model_config as jax_get_model_config
from consensus_tpu.models.transformer import init_params as jax_init_params
from consensus_tpu.models.transformer import project_logits as jax_project_logits
from consensus_tpu.ops.kv_pages import BlockTable as JaxBlockTable
from consensus_tpu.ops.kv_pages import PagePool as JaxPagePool
from consensus_tpu.parallel import make_mesh as jax_make_mesh
from consensus_tpu.parallel import shard_params as jax_shard_params
from consensus_tpu_torch.models import stepper
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.transformer import project_logits
from consensus_tpu_torch.ops.kv_pages import BlockTable, PagePool
from consensus_tpu_torch.parallel import Ranked, tp_params

torch.set_num_threads(1)

TINY_MODELS = ["tiny-gemma2", "tiny-llama3"]
PAGE_SIZE, NUM_PAGES, MAX_BLOCKS, N_DECODE = 4, 16, 8, 3


def _run(lib, params, cfg, prompt):
    """prefill -> N_DECODE greedy decodes -> gather over one stream in row 0
    of a 2-row table (row 1 pads into the sink), as the JAX test runs it.
    ``lib`` holds the side's stepper, page classes, array constructor and
    mesh keywords.  Returns (greedy tokens, logit trace)."""
    step, pool_cls, table_cls, arr, to_np, mesh_kw, state_kw = lib
    pool = pool_cls(NUM_PAGES, PAGE_SIZE)
    state = step.make_page_state(cfg, NUM_PAGES, PAGE_SIZE, **state_kw)
    sink = NUM_PAGES
    table = table_cls(0)
    table.append_tokens(pool, 8)
    tok = np.zeros((2, 8), np.int32)
    cvalid = np.zeros((2, 8), bool)
    wp = np.full((2, 8), sink, np.int32)
    wo = np.zeros((2, 8), np.int32)
    tok[0] = prompt
    cvalid[0] = True
    for t in range(8):
        wp[0, t] = table.pages[t // PAGE_SIZE]
        wo[0, t] = t % PAGE_SIZE
    tables = np.full((2, MAX_BLOCKS), -1, np.int32)
    tables[0] = table.as_array(MAX_BLOCKS)
    hidden, state = step.paged_prefill_chunk(
        params, cfg, arr(tok), arr(cvalid), state, arr(tables),
        arr(np.asarray([8, 0], np.int32)), arr(wp), arr(wo), **mesh_kw,
    )
    project = jax_project_logits if step is jax_stepper else project_logits
    trace = [to_np(project(params, cfg, hidden)[0])]
    tokens = []
    last = trace[0]
    for _ in range(N_DECODE):
        nxt = int(np.argmax(last))
        tokens.append(nxt)
        table.append_tokens(pool, 1)
        page, offset = table.write_cursor(pool)
        tables = np.full((2, MAX_BLOCKS), -1, np.int32)
        tables[0] = table.as_array(MAX_BLOCKS)
        lg, state = step.paged_decode_step(
            params, cfg, arr(np.asarray([nxt, 0], np.int32)), state, arr(tables),
            arr(np.asarray([table.num_tokens, 0], np.int32)),
            arr(np.asarray([page, sink], np.int32)), arr(np.asarray([offset, 0], np.int32)),
            **mesh_kw,
        )
        last = to_np(lg[0])
        trace.append(last)
    g_logits, state = step.paged_gather_step(
        params, cfg, arr(np.asarray([int(prompt[-1]), 0], np.int32)), state, arr(tables),
        arr(np.asarray([table.num_tokens, 0], np.int32)), **mesh_kw,
    )
    trace.append(to_np(g_logits[0]))
    return tokens, trace, state


@pytest.fixture(scope="module", params=TINY_MODELS)
def case(request):
    cfg = jax_get_model_config(request.param)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    prompt = np.random.RandomState(2).randint(1, cfg.vocab_size, size=(8,)).astype(np.int32)
    plan = jax_make_mesh(dp=4, tp=2)
    jax_lib = (jax_stepper, JaxPagePool, JaxBlockTable, jnp.asarray, np.asarray,
               {"mesh": plan.mesh}, {"dtype": jnp.float32, "mesh": plan.mesh})
    ref_tokens, ref_trace, _ = _run(jax_lib, jax_shard_params(params, plan.mesh), cfg, prompt)
    port_cfg = get_model_config(request.param)
    port = params_from_jax(jax.tree.map(np.asarray, params), port_cfg)
    return port_cfg, port, prompt, ref_tokens, ref_trace


def _port_lib(params):
    return (stepper, PagePool, BlockTable, torch.from_numpy, lambda t: t.numpy(), {},
            {"dtype": torch.float32, "params": params})


def test_tp2_paged_programs_match_jax_mesh(case):
    cfg, port, prompt, ref_tokens, ref_trace = case
    sharded = tp_params(port, cfg, ["cpu", "cpu"])
    tokens, trace, state = _run(_port_lib(sharded), sharded, cfg, prompt)
    assert tokens == ref_tokens
    for ref, got in zip(ref_trace, trace):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    assert isinstance(state.k_pages, Ranked)
    assert all(p.shape[3] == cfg.n_kv_heads // 2 and p.is_contiguous()
               for p in state.k_pages.parts)


def test_tp2_page_contents_are_the_heads_of_tp1(case):
    """Each rank's pages hold its block of kv heads: concatenated in rank
    order they are tp=1's pages (to float tolerance)."""
    cfg, port, prompt, _, _ = case
    sharded = tp_params(port, cfg, ["cpu", "cpu"])
    _, _, whole = _run(_port_lib(None), port, cfg, prompt)
    _, _, parts = _run(_port_lib(sharded), sharded, cfg, prompt)
    joined = torch.cat(parts.k_pages.parts, dim=3)
    np.testing.assert_allclose(joined[:, :NUM_PAGES].numpy(), whole.k_pages[:, :NUM_PAGES].numpy(),
                               atol=1e-5)


def test_tp2_decode_window_matches_tp1(case):
    """The engine's K-step window (``paged_decode_steps``) over a tp=2 pool
    emits tp=1's greedy tokens and carries the same logits."""
    cfg, port, prompt, _, _ = case
    sharded = tp_params(port, cfg, ["cpu", "cpu"])
    out = {}
    for name, params in (("tp1", port), ("tp2", sharded)):
        state = stepper.make_page_state(cfg, NUM_PAGES, PAGE_SIZE, torch.float32, "cpu", params)
        tables = torch.tensor([[0, 1, 2, 3, -1, -1, -1, -1]], dtype=torch.int32)
        tok = torch.from_numpy(prompt[None])
        hidden, state = stepper.paged_prefill_chunk(
            params, cfg, tok, torch.ones_like(tok, dtype=torch.bool), state, tables,
            torch.tensor([8], dtype=torch.int32), torch.tensor([[0] * 4 + [1] * 4], dtype=torch.int32),
            torch.tensor([[0, 1, 2, 3] * 2], dtype=torch.int32),
        )
        logits = project_logits(params, cfg, hidden)
        res = stepper.paged_decode_steps(
            params, cfg, logits, state, tables, torch.tensor([8], dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int64), torch.zeros(1, dtype=torch.bool),
            torch.tensor([6], dtype=torch.int32), torch.zeros(1, dtype=torch.bool),
            torch.zeros(1), num_steps=6, sampling=False,
        )
        out[name] = res
    assert torch.equal(out["tp1"][0], out["tp2"][0])
    np.testing.assert_allclose(out["tp2"][2].numpy(), out["tp1"][2].numpy(), atol=2e-4)

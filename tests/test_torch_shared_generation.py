"""The port's shared-trunk, segmented and int8-KV generation against the JAX
package, same weights.

JAX weights come from ``init_params(PRNGKey(0))`` in float32 and go through
``params_from_jax``.  Tolerances: ``quantize_kv`` exactly (both round half
to even); ``forward_trunk_tail`` hidden states with frozen blocks, int8
tails and an int8 trunk within 1e-4 absolute (float32, different summation
orders); greedy tokens exactly, on inputs whose greedy picks are checked to
be tie-free (top-1 minus top-2 logit > 1e-3 at every step the port takes).
Sampled rows draw from per-row threefry keys, bit for bit JAX's (pinned by
``tests/test_torch_threefry.py``); the batch-independence case compares the
port with itself.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.models import generate as jgen
from consensus_tpu.models import transformer as jtf
from consensus_tpu.models.config import get_model_config as jax_config
from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.models import generate as tgen
from consensus_tpu_torch.models import transformer as ttf
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.models.sampling import gumbel_noise
from consensus_tpu_torch.utils import threefry

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-4
TIE_MARGIN = 1e-3
MODELS = ("tiny-gemma2", "tiny-llama3")
#: Greedy decodes run on tiny-llama3: tiny-gemma2's head is its 0.02-scale
#: embedding, whose logits lie so close together that near-ties are common.
GREEDY_MODEL = "tiny-llama3"
CTX, MAX_NEW, SEG = 24, 32, 16


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg = jax_config(name)
    tcfg = get_model_config(name)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


def test_quantize_kv_exact():
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((3, 7, 2, 16)) * rng.uniform(0.01, 30, (3, 7, 2, 1))).astype(
        np.float32
    )
    arr[0, 0, 0] = 0.0  # an all-zero head: scale 0, values 0
    arr[1, 2, 1, :4] = [2.5, -2.5, 127.0, -127.0]  # exact halves after scaling
    jq, js = jtf.quantize_kv(jnp.asarray(arr))
    tq, ts = ttf.quantize_kv(torch.from_numpy(arr))
    assert tq.dtype == torch.int8 and ts.shape == (3, 7, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tgen._quantize_kv is ttf.quantize_kv


def _int8(arr):
    q, s = jtf.quantize_kv(jnp.asarray(arr))
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("variant", ["frozen", "int8_tail", "int8_trunk"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_trunk_tail_blocks(name, variant):
    """One decode step at tail column 3 after two frozen 8-column blocks:
    dense blocks and tail over a shared trunk (three slots, one role); int8
    blocks and tail; and the classic layout (one slot, three roles) with an
    int8 trunk too."""
    jcfg, jparams, tcfg, tparams = _models(name)
    n_slots, n_roles = (1, 3) if variant == "int8_trunk" else (3, 1)
    rows, write_col, ts, widths = n_slots * n_roles, 3, 8, (8, 8)
    rng = np.random.default_rng(11)
    starts = np.array([0, 5, 17][:n_roles])
    valid = np.arange(CTX)[None, :] >= starts[:, None]
    key_pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    kv_shape = (tcfg.n_layers, None, None, tcfg.n_kv_heads, tcfg.head_dim)

    def normal(n_rows, width):
        shape = kv_shape[:1] + (n_rows, width) + kv_shape[3:]
        return rng.standard_normal(shape, dtype=np.float32)

    trunk_k, trunk_v = normal(n_roles, CTX), normal(n_roles, CTX)
    frozen_k = [normal(rows, w) for w in widths]
    frozen_v = [normal(rows, w) for w in widths]
    tail_k, tail_v = normal(rows, ts), normal(rows, ts)
    base = np.tile(key_pos[:, -1], n_slots)  # (Rows,) last prompt position
    frozen_pos, offset = [], 0
    for w in widths:
        frozen_pos.append((base[:, None] + 1 + offset + np.arange(w)[None]).astype(np.int32))
        offset += w
    tail_pos = (base[:, None] + 1 + offset + np.arange(ts)[None]).astype(np.int32)
    positions = tail_pos[:, write_col].copy()
    tokens = rng.integers(0, tcfg.vocab_size, rows).astype(np.int32)

    quantized = variant != "frozen"
    if quantized:
        frozen_k = [_int8(b) for b in frozen_k]
        frozen_v = [_int8(b) for b in frozen_v]
        tail_k, tail_v = _int8(tail_k), _int8(tail_v)
    if variant == "int8_trunk":
        trunk_k, trunk_v = _int8(trunk_k), _int8(trunk_v)

    def jax_tree(block):
        return tuple(jnp.asarray(a) for a in block) if isinstance(block, tuple) else jnp.asarray(block)

    def torch_tree(block):
        if isinstance(block, tuple):
            return tuple(torch.from_numpy(a.copy()) for a in block)
        return torch.from_numpy(block.copy())

    jtrunk = jtf.KVCache(jax_tree(trunk_k), jax_tree(trunk_v), jnp.asarray(key_pos), jnp.asarray(valid))
    jh, jk, jv = jtf.forward_trunk_tail(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jtrunk,
        jax_tree(tail_k), jax_tree(tail_v), jnp.asarray(tail_pos),
        jnp.asarray(write_col, jnp.int32), n_slots, n_roles,
        frozen_k=[jax_tree(b) for b in frozen_k], frozen_v=[jax_tree(b) for b in frozen_v],
        frozen_positions=[jnp.asarray(p) for p in frozen_pos],
    )
    ttrunk = ttf.KVCache(
        torch_tree(trunk_k), torch_tree(trunk_v), torch.from_numpy(key_pos), torch.from_numpy(valid)
    )
    th, tk, tv = ttf.forward_trunk_tail(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions), ttrunk,
        torch_tree(tail_k), torch_tree(tail_v), torch.from_numpy(tail_pos), write_col,
        n_slots, n_roles, frozen_k=[torch_tree(b) for b in frozen_k],
        frozen_v=[torch_tree(b) for b in frozen_v],
        frozen_positions=[torch.from_numpy(p) for p in frozen_pos],
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    if quantized:
        # The written column's scales agree to float tolerance; its int8
        # values within one step (a rounding tie may fall either way).
        np.testing.assert_allclose(
            tk[1][:, :, write_col].numpy(), np.asarray(jk[1])[:, :, write_col], atol=ATOL, rtol=1e-5
        )
        diff = tk[0][:, :, write_col].numpy().astype(int) - np.asarray(jk[0])[:, :, write_col]
        assert np.abs(diff).max() <= 1
    else:
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


class _Margins:
    """Records the top-1 minus top-2 logit of every row at every step the
    port's decode loops sample from (wraps ``generate.project_logits``:
    call 0 is the prefill, call i the logits step i samples from).  With
    ``sampled`` it wraps ``generate.sample_tokens`` instead and records the
    margin of what the draw takes the argmax of: logits / temperature plus
    the row's Gumbel noise."""

    def __init__(self, monkeypatch, sampled=False):
        self.values = []
        if sampled:
            original_sample = tgen.sample_tokens

            def sampling(logits, temperature=1.0, keys=None, **kwargs):
                temp = torch.as_tensor(temperature, dtype=torch.float32).reshape(-1, 1)
                scores = logits / torch.clamp(temp, min=1e-6) + gumbel_noise(keys, logits.shape[-1])
                top2 = torch.topk(scores, 2, dim=-1).values
                self.values.append((top2[:, 0] - top2[:, 1]).numpy())
                return original_sample(logits, temperature=temperature, keys=keys, **kwargs)

            monkeypatch.setattr(tgen, "sample_tokens", sampling)
            return
        original = tgen.project_logits

        def recording(params, config, hidden):
            logits = original(params, config, hidden)
            top2 = torch.topk(logits, 2, dim=-1).values
            self.values.append((top2[:, 0] - top2[:, 1]).numpy())
            return logits

        monkeypatch.setattr(tgen, "project_logits", recording)

    def check(self, num_generated, max_new, survivors=None):
        """Row r samples at steps 0..min(num_generated[r], max_new - 1); rows
        past ``num_generated`` (bucket padding) never sample.  When the batch
        halves, the ``survivors`` (original row ids) come first."""
        n_gen = np.asarray(num_generated)
        rows = np.arange(len(n_gen))
        for step, margin in enumerate(self.values[:max_new]):
            if len(margin) == 1:  # a shared prompt's prefill serves every row
                margin = np.repeat(margin, len(rows))
            if len(margin) < len(rows):
                rows = np.concatenate([survivors, np.full(len(margin) - len(survivors), -1)])
            for j, row in enumerate(rows[: len(margin)]):
                if 0 <= row < len(n_gen) and step <= min(n_gen[row], max_new - 1):
                    assert margin[j] > TIE_MARGIN, f"near-tie greedy pick: row {row}, step {step}"
        self.values.clear()


def _shared_prompt(vocab, seed=3):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((1, CTX), np.int32)
    valid = np.arange(CTX)[None, :] >= 5  # left-padded by five columns
    tokens[valid] = rng.integers(1, vocab, int(valid.sum()))
    return tokens, valid


def _row_prompts(vocab, rows, seed=8):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((rows, CTX), np.int32)
    valid = np.zeros((rows, CTX), bool)
    for row in range(rows):
        n = CTX - (row % 6) * 3  # lengths differ: per-row positions
        tokens[row, CTX - n:] = rng.integers(1, vocab, n)
        valid[row, CTX - n:] = True
    return tokens, valid


def _assert_same(got, expect):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(expect.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(), np.asarray(expect.num_generated))
    np.testing.assert_array_equal(got.hit_eos.numpy(), np.asarray(expect.hit_eos))


@pytest.mark.parametrize(
    "route, kv_quant",
    [("shared", False), ("shared_segmented", False), ("shared_segmented", True),
     ("segmented", True)],
)
def test_greedy_tokens_match_jax(route, kv_quant, monkeypatch):
    """Greedy decode of four rows, exactly as the JAX generator decodes them:
    the monolithic shared trunk, the segmented shared trunk with dense and
    int8 KV, and the segmented classic layout with int8 KV (per-row prompts
    of different lengths)."""
    jcfg, jparams, tcfg, tparams = _models(GREEDY_MODEL)
    batch = 4
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(jnp.arange(batch))
    jtemp = jnp.zeros((batch,), jnp.float32)
    margins = _Margins(monkeypatch)
    if route == "segmented":
        tokens, valid = _row_prompts(tcfg.vocab_size, batch)
        expect = jgen.generate_tokens_segmented(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid), keys, MAX_NEW,
            seg_len=SEG, temperature=jtemp, kv_quant=kv_quant,
        )
        got = tgen.generate_tokens_segmented(
            tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), MAX_NEW,
            seg_len=SEG, temperature=0.0, kv_quant=kv_quant,
        )
    else:
        tokens, valid = _shared_prompt(tcfg.vocab_size)
        jargs = (jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid))
        targs = (tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), batch, MAX_NEW)
        if route == "shared":
            expect = jgen.generate_tokens_shared_trunk(
                *jargs, batch=batch, key=keys, max_new_tokens=MAX_NEW, temperature=jtemp
            )
            got = tgen.generate_tokens_shared_trunk(*targs, temperature=0.0)
        else:
            expect = jgen.generate_tokens_shared_trunk_segmented(
                *jargs, batch=batch, key=keys, max_new_tokens=MAX_NEW, seg_len=SEG,
                temperature=jtemp, kv_quant=kv_quant,
            )
            got = tgen.generate_tokens_shared_trunk_segmented(
                *targs, seg_len=SEG, temperature=0.0, kv_quant=kv_quant
            )
    margins.check(got.num_generated, MAX_NEW)
    _assert_same(got, expect)
    assert int(got.num_generated.min()) == MAX_NEW  # no EOS ids: full budget


@pytest.mark.parametrize("decode", [True, False], ids=["decode-kernel", "einsum"])
def test_classic_generate_takes_trunk_tail_route(decode, monkeypatch):
    """Classic ``generate_tokens`` decodes as the reference's: per-row
    trunks plus one full-budget tail through ``forward_trunk_tail`` (the
    decode kernel's route under ``use_decode_attention``), one call a step,
    and bucket-padding rows start done.  Greedy tokens equal the JAX
    package's (its decode kernel in interpret mode)."""
    jcfg, jparams, tcfg, tparams = _models(GREEDY_MODEL)
    jcfg = dataclasses.replace(jcfg, use_decode_attention=decode)
    tcfg = dataclasses.replace(tcfg, use_decode_attention=decode)
    batch = 8
    tokens, valid = _row_prompts(tcfg.vocab_size, batch, seed=1)
    valid[6:] = False  # two bucket-padding rows: no prompt token
    tokens[6:] = 0
    calls = []
    original = tgen.forward_trunk_tail

    def counting(*args, **kwargs):
        calls.append(args[8] if len(args) > 8 else kwargs["write_col"])
        assert args[9:11] == (1, batch)  # n_slots=1, n_roles=B
        return original(*args, **kwargs)

    monkeypatch.setattr(tgen, "forward_trunk_tail", counting)
    margins = _Margins(monkeypatch)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.arange(batch))
    expect = jgen.generate_tokens(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid), keys, MAX_NEW,
        temperature=jnp.zeros((batch,), jnp.float32),
    )
    got = tgen.generate_tokens(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), MAX_NEW, temperature=0.0
    )
    margins.check(got.num_generated, MAX_NEW)
    _assert_same(got, expect)
    assert calls == list(range(MAX_NEW)), calls
    assert got.num_generated[6:].tolist() == [0, 0]


@pytest.mark.parametrize("route", ["classic", "shared", "shared_segmented", "segmented"])
def test_sampled_tokens_match_jax(route, monkeypatch):
    """Temperature 1 with per-row keys: the port splits and draws exactly as
    the JAX generators do, so the sampled tokens are the same (every draw's
    argmax margin checked > 1e-3)."""
    jcfg, jparams, tcfg, tparams = _models(GREEDY_MODEL)
    batch = 4
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i))(jnp.arange(batch))
    tkeys = threefry.fold_in(threefry.prng_key(9), torch.arange(batch))
    jtemp = jnp.ones((batch,), jnp.float32)
    ttemp = torch.ones((batch,))
    margins = _Margins(monkeypatch, sampled=True)
    if route in ("classic", "segmented"):
        tokens, valid = _row_prompts(tcfg.vocab_size, batch, seed=5)
        jargs = (jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid), jkeys, MAX_NEW)
        targs = (tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), MAX_NEW)
        if route == "classic":
            expect = jgen.generate_tokens(*jargs, temperature=jtemp)
            got = tgen.generate_tokens(*targs, keys=tkeys, temperature=ttemp)
        else:
            expect = jgen.generate_tokens_segmented(*jargs, seg_len=SEG, temperature=jtemp, kv_quant=True)
            got = tgen.generate_tokens_segmented(
                *targs, keys=tkeys, seg_len=SEG, temperature=ttemp, kv_quant=True
            )
    else:
        tokens, valid = _shared_prompt(tcfg.vocab_size, seed=6)
        jargs = (jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid))
        targs = (tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), batch, MAX_NEW)
        if route == "shared":
            expect = jgen.generate_tokens_shared_trunk(
                *jargs, batch=batch, key=jkeys, max_new_tokens=MAX_NEW, temperature=jtemp
            )
            got = tgen.generate_tokens_shared_trunk(*targs, keys=tkeys, temperature=ttemp)
        else:
            expect = jgen.generate_tokens_shared_trunk_segmented(
                *jargs, batch=batch, key=jkeys, max_new_tokens=MAX_NEW, seg_len=SEG,
                temperature=jtemp, kv_quant=True,
            )
            got = tgen.generate_tokens_shared_trunk_segmented(
                *targs, keys=tkeys, seg_len=SEG, temperature=ttemp, kv_quant=True
            )
    margins.check(got.num_generated, MAX_NEW)
    _assert_same(got, expect)


def test_compaction_matches_jax(monkeypatch):
    """Sixteen per-row prompts, greedy, with EOS ids taken from the port's
    own greedy stream so that at least half the rows end in the first
    segment: the batch halves to 8 rows at the boundary, in the port and in
    the JAX loop, and the tokens agree row for row."""
    jcfg, jparams, tcfg, tparams = _models(GREEDY_MODEL)
    batch = 16
    tokens, valid = _row_prompts(tcfg.vocab_size, batch, seed=4)
    probe = tgen.generate_tokens_segmented(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), MAX_NEW,
        seg_len=SEG, temperature=0.0,
    ).tokens.numpy()
    # Most frequent first-segment ids first, until 8..15 rows would end.
    counts = np.bincount(probe[:, :SEG].ravel(), minlength=tcfg.vocab_size)
    eos = []
    for token_id in np.argsort(-counts, kind="stable"):
        ended = np.isin(probe[:, :SEG], eos + [int(token_id)]).any(axis=1).sum()
        if ended < batch:
            eos.append(int(token_id))
        if np.isin(probe[:, :SEG], eos).any(axis=1).sum() >= batch // 2:
            break
    assert batch // 2 <= np.isin(probe[:, :SEG], eos).any(axis=1).sum() < batch

    seen = []
    original = tgen._decode_segment

    def recording(*args, **kwargs):
        seen.append(kwargs["n_slots"] * kwargs["n_roles"])
        return original(*args, **kwargs)

    monkeypatch.setattr(tgen, "_decode_segment", recording)
    margins = _Margins(monkeypatch)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(jnp.arange(batch))
    expect = jgen.generate_tokens_segmented(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(valid), keys, MAX_NEW, seg_len=SEG,
        temperature=jnp.zeros((batch,), jnp.float32), eos_ids=jnp.asarray(eos, jnp.int32),
    )
    got = tgen.generate_tokens_segmented(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid), MAX_NEW,
        seg_len=SEG, temperature=0.0, eos_ids=torch.tensor(eos, dtype=torch.int32),
    )
    n_gen = got.num_generated.numpy()
    margins.check(n_gen, MAX_NEW, survivors=np.flatnonzero(n_gen >= SEG))
    _assert_same(got, expect)
    assert seen == [batch, batch // 2], seen
    assert bool(got.hit_eos.any()) and not bool(got.hit_eos.all())


def test_seeded_row_independent_of_batch():
    """A sampled row decodes the same tokens alone and inside an 8-row batch
    whose other rows end early, through a segment boundary: its key moves
    with it and splits once per step either way."""
    _, _, tcfg, tparams = _models("tiny-llama3")
    tokens, valid = _shared_prompt(tcfg.vocab_size, seed=2)
    args = (tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(valid))

    def run(seeds, eos):
        keys = torch.stack([threefry.prng_key(s) for s in seeds])
        return tgen.generate_tokens_shared_trunk_segmented(
            *args, len(seeds), MAX_NEW, keys=keys, seg_len=SEG, temperature=1.0,
            eos_ids=torch.tensor(eos, dtype=torch.int32), kv_quant=True,
        )

    seeds = [100 + i for i in range(8)]
    free = run(seeds, [-1]).tokens.numpy()
    # EOS: ids the other rows draw in their first steps and row 0 never does.
    eos = sorted({int(t) for t in free[1:, :3].ravel()} - set(free[0].tolist()))
    alone = run(seeds[:1], eos)
    batched = run(seeds, eos)
    np.testing.assert_array_equal(batched.tokens[0].numpy(), alone.tokens[0].numpy())
    assert int(alone.num_generated[0]) == int(batched.num_generated[0]) == MAX_NEW
    assert int(batched.num_generated[1:].max()) < MAX_NEW // 2


@pytest.fixture(scope="module")
def backends():
    kw = dict(model=GREEDY_MODEL, dtype="float32", max_context=64, decode_segment_len=16)
    ref = TPUBackend(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", **kw)


def test_backend_default_routes_match_jax(backends, monkeypatch):
    """With the reference's defaults, four identical greedy requests take
    the shared-trunk segmented route with int8 KV and one request the
    classic segmented route with an int8 prompt trunk; the text equals
    TPUBackend's."""
    ref, port = backends
    routes = []
    for fn in ("generate_tokens_shared_trunk_segmented", "generate_tokens_segmented"):
        original = getattr(tgen, fn)
        monkeypatch.setattr(
            tgen, fn,
            lambda *a, _fn=fn, _orig=original, **k: routes.append(_fn) or _orig(*a, **k),
        )
    margins = _Margins(monkeypatch)
    shared = [
        GenerationRequest(user_prompt="Draft a statement on parks.", max_tokens=40,
                          temperature=0.0, seed=i)
        for i in range(4)
    ]
    solo = [GenerationRequest(user_prompt="Should we tax sugar?", max_tokens=40, temperature=0.0)]
    got = port.generate(shared)
    margins.check([len(r.token_ids) for r in got], 48)
    got += port.generate(solo)
    margins.check([len(r.token_ids) for r in got[-1:]], 48)
    expect = ref.generate(shared) + ref.generate(solo)
    assert routes == ["generate_tokens_shared_trunk_segmented", "generate_tokens_segmented"]
    assert [g.text for g in got] == [e.text for e in expect]
    assert [g.finish_reason for g in got] == [e.finish_reason for e in expect]
    assert port.kv_cache_identity() == (GREEDY_MODEL, "int8", ("tp", 1))


@pytest.mark.parametrize(
    "option",
    ["shared_trunk_generation", "segmented_decode", "decode_segment_len", "kv_quant",
     "shared_context_scoring", "pin_generation_budget"],
)
def test_backend_defaults_match_reference(option):
    ref = inspect.signature(TPUBackend.__init__).parameters[option].default
    port = inspect.signature(TorchBackend.__init__).parameters[option].default
    assert port == ref

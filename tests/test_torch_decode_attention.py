"""The port's decode attention against the JAX Pallas kernel (interpret mode).

On the CPU the port's wrapper runs its plain PyTorch version; both it and
the plain version are held against ``consensus_tpu.ops.decode_attention``
run with ``interpret=True``, on the cases of tests/test_decode_attention.py
plus a trunk whose width is not a block multiple.  Tolerance: 2e-5 absolute
in float32 (the JAX suite's own bound; the two sides sum in different
orders).  The CUDA kernel is held against the plain version on the card by
the ``cuda`` test below and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.ops.decode_attention import decode_attention as jax_decode
from consensus_tpu_torch.ops import decode_attention as da

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(seed, n_slots, n_roles, kv=2, reps=2, hd=128, w0=96, ts=16):
    rng = np.random.default_rng(seed)
    rows = n_slots * n_roles
    q = rng.standard_normal((rows, kv * reps, hd), dtype=np.float32)
    trunk_k = rng.standard_normal((n_roles, w0, kv, hd), dtype=np.float32)
    trunk_v = rng.standard_normal((n_roles, w0, kv, hd), dtype=np.float32)
    tail_k = rng.standard_normal((rows, ts, kv, hd), dtype=np.float32)
    tail_v = rng.standard_normal((rows, ts, kv, hd), dtype=np.float32)
    return q, trunk_k, trunk_v, tail_k, tail_v


def _both(arrays, starts, qpos, write_col, n_slots, n_roles, scale, block_k=64, **kw):
    ref = jax_decode(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(starts, jnp.int32),
        jnp.asarray(qpos, jnp.int32), jnp.asarray(write_col, jnp.int32),
        n_slots=n_slots, n_roles=n_roles, scale=scale, block_k=block_k,
        interpret=True, **kw,
    )
    args = [torch.from_numpy(a) for a in arrays]
    sts = torch.tensor(starts, dtype=torch.int32)
    qps = torch.full((n_roles,), qpos, dtype=torch.int32)
    wrapped = da.decode_attention(*args, sts, qps, write_col, n_slots, n_roles, scale, **kw)
    plain = da.decode_attention_reference(*args, sts, qps, write_col, n_slots, n_roles, scale, **kw)
    return np.asarray(ref), wrapped.numpy(), plain.numpy()


def _check(ref, *outs):
    for out in outs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, None), (50.0, 48), (None, 24)])
def test_matches_jax_kernel(softcap, window):
    arrays = _inputs(0, n_slots=3, n_roles=2)
    _check(*_both(arrays, [5, 17], 101, 7, 3, 2, 0.088, softcap=softcap, window=window))


def test_first_step_write_col_zero():
    """write_col=0: only the current token's own tail column is visible."""
    arrays = _inputs(1, n_slots=2, n_roles=3, w0=64, ts=8)
    _check(*_both(arrays, [0, 9, 30], 63, 0, 2, 3, 0.1, block_k=32))


def test_single_slot_trunk_session():
    """Lookahead trunk sessions: n_slots=1."""
    arrays = _inputs(2, n_slots=1, n_roles=3, w0=128, ts=32)
    _check(*_both(arrays, [2, 0, 64], 140, 12, 1, 3, 0.0884, softcap=30.0, window=96))


def test_trunk_not_a_block_multiple():
    """W0=100 against 64-key blocks; one role's span is its last column."""
    arrays = _inputs(3, n_slots=2, n_roles=3, w0=100, ts=12)
    ref, wrapped, plain = _both(arrays, [99, 40, 0], 110, 5, 2, 3, 0.09)
    _check(ref, wrapped, plain)


def test_gqa_wide_group():
    """Four query heads per kv head, four slots (the llama3-8b grouping)."""
    arrays = _inputs(4, n_slots=4, n_roles=2, kv=1, reps=4, w0=80, ts=10)
    _check(*_both(arrays, [30, 3], 60, 9, 4, 2, 0.0884))


def test_empty_trunk_span_sees_only_its_tail_column():
    """A role whose trunk span is empty, under a window of 1, attends only
    its own tail column 0: the output is that column's value, exactly."""
    q, tk, tv, lk, lv = (torch.from_numpy(a) for a in _inputs(5, n_slots=1, n_roles=2, w0=16, ts=4))
    out = da.decode_attention_reference(
        q, tk, tv, lk, lv, torch.tensor([16, 0]), torch.tensor([100, 100]), 0, 1, 2, 0.1,
        window=1,
    )
    assert torch.isfinite(out).all()
    one_key = da.decode_attention_reference(
        q[:1], tk[:1], tv[:1], lk[:1], lv[:1], torch.tensor([16]), torch.tensor([100]), 0, 1, 1,
        0.1,
    )
    torch.testing.assert_close(out[:1], one_key, atol=1e-6, rtol=0)
    torch.testing.assert_close(out[0], lv[0, 0].repeat_interleave(2, dim=0), atol=1e-6, rtol=0)


def test_cpu_wrapper_does_not_count_launches():
    before = da.launches.count
    arrays = [torch.from_numpy(a) for a in _inputs(6, n_slots=1, n_roles=2)]
    da.decode_attention(*arrays, torch.tensor([0, 3]), torch.tensor([99, 96]), 2, 1, 2, 0.1)
    assert da.launches.count == before


def test_shape_mismatch_raises():
    q, tk, tv, lk, lv = (torch.from_numpy(a) for a in _inputs(7, n_slots=2, n_roles=2))
    with pytest.raises(ValueError, match="slots"):
        da.decode_attention(q, tk, tv, lk, lv, torch.zeros(2), torch.zeros(2), 0, 3, 2, 0.1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode-attention kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_slots,heads,kv,hd,softcap,window",
    [(4, 32, 8, 128, None, None), (1, 32, 8, 128, None, None), (4, 16, 8, 256, 50.0, 256)],
)
def test_kernel_matches_plain_version_on_card(cuda_device, n_slots, heads, kv, hd, softcap, window):
    """bf16 inputs; the plain version computes in fp32 from the same bf16
    values.  Tolerance atol 5e-3 + rtol 1e-2: bf16 output rounding (2^-8
    relative) plus fp32 sums in another order, as in chip_smoke.py."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n_roles, w0, ts, write_col = 3, 700, 50, 37
    rows = n_slots * n_roles

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)

    args = (randn(rows, heads, hd), randn(n_roles, w0, kv, hd), randn(n_roles, w0, kv, hd),
            randn(rows, ts, kv, hd), randn(rows, ts, kv, hd))
    starts = torch.tensor([0, 350, w0 - 1], dtype=torch.int32, device=cuda_device)
    qpos = (w0 - starts) + write_col
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    before = da.launches.count
    out = da.decode_attention(*args, starts, qpos, write_col, n_slots, n_roles, **kw)
    torch.cuda.synchronize()
    assert da.launches.count == before + 1
    ref = da.decode_attention_reference(*args, starts, qpos, write_col, n_slots, n_roles, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-3, rtol=1e-2)

"""The port's flash attention against the JAX Pallas kernel (interpret mode).

On the CPU the port's wrapper runs its plain PyTorch version; both it and
the plain version are held against ``consensus_tpu.ops.flash_attention``
run with ``interpret=True``, on the cases of tests/test_flash_attention.py.
Tolerance: 2e-5 absolute in float32 (the JAX suite's own bound; the two
sides sum in different orders).  The CUDA kernel is held against the plain
version on the card by the ``cuda`` test below and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_tpu.ops.flash_attention import flash_attention as jax_flash
from consensus_tpu_torch.ops import flash_attention as fa

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(seed, batch=2, seq=128, heads=2, hd=32, kv_heads=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, seq, heads, hd), dtype=np.float32)
    k = rng.standard_normal((batch, seq, kv_heads or heads, hd), dtype=np.float32)
    v = rng.standard_normal((batch, seq, kv_heads or heads, hd), dtype=np.float32)
    return q, k, v


def _both(q, k, v, lengths, starts=None, blocks=(64, 64), **kw):
    reps = q.shape[2] // k.shape[2]
    kj, vj = np.repeat(k, reps, axis=2), np.repeat(v, reps, axis=2)
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(kj), jnp.asarray(vj), jnp.asarray(lengths),
        None if starts is None else jnp.asarray(starts),
        block_q=blocks[0], block_k=blocks[1], interpret=True, **kw,
    )
    args = [torch.from_numpy(a) for a in (q, k, v)]
    lens = torch.tensor(lengths, dtype=torch.int32)
    sts = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    wrapped = fa.flash_attention(*args, lens, sts, **kw)
    plain = fa.flash_attention_reference(*args, lens, sts, **kw)
    return np.asarray(ref), wrapped.numpy(), plain.numpy()


def _check(ref, *outs):
    for out in outs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


CASES = {
    "blocks-128x128": dict(blocks=(128, 128), lengths=[128, 128]),
    "blocks-64x32": dict(blocks=(64, 32), lengths=[128, 128]),
    "blocks-32x64": dict(blocks=(32, 64), lengths=[128, 128]),
    "ragged": dict(lengths=[128, 42]),
    "softcap-window": dict(lengths=[128, 128], softcap=50.0, window=16),
    "non-causal": dict(lengths=[128, 128], causal=False),
    "left-padded": dict(lengths=[128, 42], starts=[0, 86]),
    "left-padded-window": dict(lengths=[64, 120], starts=[64, 8], softcap=50.0, window=16),
    "empty-row": dict(lengths=[100, 0]),
    "gqa-kv-heads": dict(lengths=[128, 70], kv_heads=1, heads=4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_kernel(name):
    case = dict(CASES[name])
    lengths = case.pop("lengths")
    starts = case.pop("starts", None)
    blocks = case.pop("blocks", (64, 64))
    shape = {k: case.pop(k) for k in ("heads", "kv_heads") if k in case}
    q, k, v = _inputs(seed=len(name), **shape)
    ref, wrapped, plain = _both(q, k, v, lengths, starts, blocks, **case)
    _check(ref, wrapped, plain)
    if name == "empty-row":
        assert not wrapped[1].any()


def test_seq_not_a_block_multiple():
    q, k, v = _inputs(seed=6, batch=1, seq=100)
    ref, wrapped, plain = _both(q, k, v, [77])
    assert wrapped.shape == (1, 100, 2, 32)
    _check(ref, wrapped, plain)
    # Outside the span the output is exactly zero on both sides.
    assert not wrapped[:, 77:].any() and not np.asarray(ref)[:, 77:].any()


def test_cpu_wrapper_does_not_count_launches():
    before = fa.launches.count
    q, k, v = (torch.from_numpy(a) for a in _inputs(seed=1))
    fa.flash_attention(q, k, v, torch.tensor([128, 128], dtype=torch.int32))
    assert fa.launches.count == before


def _bf16_at_offset(shape, offset):
    """A contiguous bf16 CPU view of ``shape`` that starts ``offset``
    elements into its storage."""
    numel = int(np.prod(shape))
    return torch.zeros(numel + offset, dtype=torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("offset, message", [(0, None), (8, None), (1, "aligned"), (4, "aligned")])
def test_cuda_input_check_takes_only_tma_aligned_addresses(offset, message):
    """The kernel's tensor maps need each of q, k, v contiguous from a
    16-byte aligned address: a view at a storage offset of 1 or 4 bf16
    (2 or 8 bytes) raises, 0 or 8 (16 bytes) passes.  The wrapper never
    copies such a tensor quietly; ``contiguous()`` keeps the view."""
    shape_q, shape_kv = (2, 130, 8, 256), (2, 130, 4, 256)
    lengths = torch.tensor([130, 3], dtype=torch.int32)
    starts = torch.tensor([0, 127], dtype=torch.int32)
    for name in ("q", "k", "v"):
        tensors = {
            "q": _bf16_at_offset(shape_q, offset if name == "q" else 0),
            "k": _bf16_at_offset(shape_kv, offset if name == "k" else 0),
            "v": _bf16_at_offset(shape_kv, offset if name == "v" else 0),
        }
        assert tensors[name].contiguous().data_ptr() == tensors[name].data_ptr()
        if message is None:
            fa._check_cuda_inputs(tensors["q"], tensors["k"], tensors["v"], lengths, starts)
        else:
            with pytest.raises(ValueError, match=f"{name} must be contiguous from a 16-byte {message}"):
                fa._check_cuda_inputs(tensors["q"], tensors["k"], tensors["v"], lengths, starts)


def test_cuda_input_check_refuses_strided_views():
    q = _bf16_at_offset((2, 8, 130, 128), 0).transpose(1, 2)
    k = v = _bf16_at_offset((2, 130, 2, 128), 0)
    with pytest.raises(ValueError, match="q must be contiguous"):
        fa._check_cuda_inputs(q, k, v, torch.tensor([130, 3]), torch.tensor([0, 127]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "head_dim,softcap,window,seq,lengths,starts",
    [
        (128, None, None, 300, [300, 171, 0, 64], [0, 129, 0, 0]),
        (256, 50.0, 256, 300, [300, 171, 0, 64], [0, 129, 0, 0]),
        # Causal tile boundaries: S = 200 is not a multiple of the 128-query
        # tile, and left-padded spans start inside a tile.
        (128, None, None, 200, [200, 73, 130, 1], [0, 127, 70, 199]),
        # A TMA edge: S = 130 puts the second query tile 2 rows deep and the
        # K/V boxes past S (zero-filled on load, clipped on store);
        # left-padded starts inside a tile and a row of length 0.
        (256, 50.0, None, 130, [130, 67, 0, 3], [0, 63, 130, 127]),
    ],
)
def test_kernel_matches_plain_version_on_card(cuda_device, head_dim, softcap, window, seq,
                                              lengths, starts):
    """bf16 inputs; the plain version computes in fp32 from the same bf16
    values.  Tolerance atol 5e-3 + rtol 1e-2: bf16 output rounding (2^-8
    relative) and bf16 P in P.V, as in chip_smoke.py."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    shape_q, shape_kv = (4, seq, 8, head_dim), (4, seq, 2, head_dim)
    q = torch.randn(shape_q, generator=g, device=cuda_device).to(torch.bfloat16)
    k = torch.randn(shape_kv, generator=g, device=cuda_device).to(torch.bfloat16)
    v = torch.randn(shape_kv, generator=g, device=cuda_device).to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    starts = torch.tensor(starts, dtype=torch.int32, device=cuda_device)
    kw = dict(scale=head_dim ** -0.5, softcap=softcap, window=window)
    before = fa.launches.count
    out = fa.flash_attention(q, k, v, lengths, starts, **kw)
    torch.cuda.synchronize()
    assert fa.launches.count == before + 1
    ref = fa.flash_attention_reference(q, k, v, lengths, starts, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-3, rtol=1e-2)

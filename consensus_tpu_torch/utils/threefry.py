"""Threefry-2x32 random numbers, bit for bit those of ``jax.random``.

The JAX package draws every sampled token from ``jax.random`` keys
(``consensus_tpu/models/sampling.py``, ``generate.py``, ``stepper.py``), so
a seed names one exact stream there.  This module reproduces the subset of
``jax.random`` those paths call, with ``jax_threefry_partitionable`` on (the
default of jax 0.9): ``prng_key`` (``PRNGKey``), ``split``, ``fold_in``,
``random_bits``, ``uniform``, ``gumbel`` and ``categorical``.  The same
seed then gives the same draws in both packages.

A key is an int64 tensor whose last dimension holds the two uint32 words
(``(2,)``, or ``(B, 2)`` for per-row keys).  torch's uint32 support is
partial and differs between builds, so every word lives in an int64 and is
masked back to 32 bits after each add and rotate; this runs unchanged on
the CPU and on the card, and keys stay on the device they were made on.

Leading key dimensions act as ``jax.vmap`` does: ``gumbel(keys (B, 2),
(V,))`` is ``vmap(lambda k: jax.random.gumbel(k, (V,)))(keys)``.

The floats: ``uniform`` is JAX's mantissa fill, exact in any arithmetic.
``gumbel`` is ``-log(-log(u))`` with XLA's CPU lowering of ``log`` (the
Cephes single-precision polynomial its LLVM emitter expands, with the
multiply-adds it contracts into FMAs), evaluated here step by step in
float32, each FMA through float64 (a float32 product is exact there).
``torch.log`` rounds differently in ~15% of inputs.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple:
    """The Threefry-2x32 block (20 rounds) on broadcastable uint32-in-int64
    words, as ``jax._src.prng._threefry2x32_lowering``.  ``x0`` is masked
    only at the end: it stays below 2**38, and only its low 32 bits reach
    ``x1`` (through the masked XOR); six elementwise kernels a round."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK
        x0 = x0 + ks[(block + 1) % 3]
        x1 = (x1 + (ks[(block + 2) % 3] + (block + 1))) & _MASK
    return x0 & _MASK, x1


def prng_key(seed: int, device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed that fits int32 (x64 off):
    the words are (0, seed mod 2**32)."""
    if not -(2**31) <= int(seed) < 2**31:
        raise OverflowError(f"seed {seed} does not fit int32")
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _words(key: torch.Tensor):
    if key.shape[-1] != 2:
        raise ValueError(f"a key's last dimension holds 2 words, got shape {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def _counters(n: int, device) -> tuple:
    """The partitionable scheme's counters: a uint64 iota as (hi, lo)."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, iota & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    k1, k2 = _words(key)
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the count (0, data mod
    2**32).  ``data`` may be a tensor broadcasting against the key's
    leading dimensions (``vmap(fold_in)``)."""
    k1, k2 = _words(key)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element, (*key_batch, *shape) int64 in [0, 2**32)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    k1, k2 = _words(key)
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], hi, lo)
    return (b1 ^ b2).reshape(key.shape[:-1] + shape)


def uniform(
    key: torch.Tensor, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits in [1, 2),
    minus 1, scaled, clamped below at ``minval``."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = (torch.tensor(maxval, dtype=torch.float32) - lo).item()
    if span != 1.0:  # (a product by 1 is exact: gumbel's span skips it)
        floats = floats * span
    return torch.clamp(floats + lo.item(), min=lo.item())


_TINY = torch.finfo(torch.float32).tiny
# Cephes logf coefficients, float32 (the constants of XLA's CPU expansion).
_LOG_P = (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRT_HALF = 0.707106781186547524


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


_LOG_P = tuple(_f32(p) for p in _LOG_P)
_LOG_Q1 = _f32(_LOG_Q1)
_SQRT_HALF = _f32(_SQRT_HALF)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the float64 product of two float32s is
    exact, so one float64 add then one rounding to float32."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive finite float32 values exactly as XLA's CPU
    backend computes it (Cephes ``logf``: frexp, a degree-8 polynomial in
    three interleaved chains, ``e * ln2`` split in two parts)."""
    x = torch.clamp(x, min=_TINY)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _SQRT_HALF
    e = e - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, e * _LOG_Q1)
    t = t - t2 * 0.5
    t = t + y
    return t + e * _LOG_Q2


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"), float32, (*key_batch, *shape)."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    return -xla_log(-xla_log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for one key (2,), or
    ``vmap(categorical)(keys, logits)`` for per-row keys (B, 2) and logits
    (B, V): argmax of Gumbel noise plus the logits, int64."""
    if keys.dim() == 1:
        noise = gumbel(keys, logits.shape)
    else:
        noise = gumbel(keys, logits.shape[keys.dim() - 1:])
    return torch.argmax(noise + logits.float(), dim=-1)

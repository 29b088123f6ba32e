"""One-position decode attention over a shared trunk plus per-row tails
(PyTorch port).

Replaces ``consensus_tpu/ops/decode_attention.py::decode_attention`` (the
Pallas TPU kernel, ``_kernel`` :51-146, wrapper :155-273, ``pallas_call``
:245).  The kernel itself is CUDA C++ for Hopper in
``csrc/decode_attention.cu``, built with ``nvcc`` at first use and called
through ``ctypes`` (see ``ops/build.py``).

Every fused token-search step (``models/stepper.py``) runs one new query
position per (slot x role) row.  Row ``p * R + r`` (slot-major) attends:

* the TRUNK of role ``r`` -- ``(R, W0, KV, hd)``, shared by every slot,
  valid on ``[start_r, W0)`` with RoPE position ``c - start_r``;
* its own TAIL -- ``(Rows, Ts, KV, hd)``, valid on columns ``<= write_col``.

The query position is uniform across slots (``qpos_r`` per role), so a
sliding window keeps trunk column ``c`` when ``qpos_r - (c - start_r) <
window`` and tail column ``j`` when ``write_col - j < window``.  The softcap
applies before the mask; a row with no valid key comes out as 0.

``paged_attention`` at the end of the module (the fused score matrix's
attention over a page pool) is plain PyTorch, as its JAX counterpart is
plain ``jnp``: no TPU kernel stands behind it.

Dispatch: a CPU tensor runs :func:`decode_attention_reference`, the plain
PyTorch version; a CUDA tensor launches the kernel (bf16, head_dim 128 or
256, any number of slots) or raises.  There is no fallback from one to the
other.

What bounds the kernel on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16): the
bytes -- q and out once, each role's trunk K/V over its valid span once
(not once per slot), each row's tail K/V over columns ``0..write_col`` --
against ``4 * hd * H`` FLOPs per (row, key).  At the llama3-8b beam shape
(P=4, R=6, H=32, KV=8, hd=128, W0=1024, Ts=200) that is ~10-20 MB, a few
microseconds; ``chip_smoke.py`` computes it from each run's spans and the
figures are in PERF.md.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128, 256)
#: Keys per block of the kernel's first pass: the trunk and each slot's
#: tail columns 0..write_col split into chunks of this many keys.
KEY_CHUNK = 256


class LaunchCounter:
    """Counts kernel launches; ``chip_smoke.py`` zeroes it before driving
    the token-search path and reads it after.  ``shapes`` maps each (q,
    trunk, tail) shape launched to ``[launches, (starts, qpos, write_col)
    of its latest launch]``, so a benchmark can time the kernel at the
    shapes and spans the path gave it.  Thread-safe: an experiment's worker
    threads launch kernels at once.  Each launch also adds one to the obs
    registry's ``kernel_launches_total{kernel}`` counter, which a server's
    ``/metrics`` exposes (``reset`` leaves that monotonic counter alone)."""

    def __init__(self, kernel: str) -> None:
        self._lock = threading.Lock()
        self._registry_counter = None
        self.kernel = kernel
        self.reset()

    def _count_in_registry(self) -> None:
        if self._registry_counter is None:
            from consensus_tpu_torch.obs.metrics import get_registry

            self._registry_counter = get_registry().counter(
                "kernel_launches_total",
                "Launches of the hand-written CUDA kernels, by kernel.",
                labels=("kernel",),
            ).labels(self.kernel)
        self._registry_counter.inc()

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.shapes: Dict[tuple, list] = {}

    def add(self, shape: tuple, args: tuple) -> None:
        self._count_in_registry()
        with self._lock:
            self.count += 1
            entry = self.shapes.setdefault(shape, [0, None])
            entry[0] += 1
            entry[1] = args


launches = LaunchCounter("decode_attention")
_SIGNATURE_LOCK = threading.Lock()


def _masks(starts, qpos, write_col, w0, ts, window, device):
    """(trunk (R, W0), tail (Ts,)) validity, as the module docstring says."""
    starts = starts.to(device=device, dtype=torch.int64)
    qpos = torch.as_tensor(qpos, device=device).to(torch.int64).expand(starts.shape)
    write_col = torch.as_tensor(write_col, device=device).to(torch.int64)
    cols = torch.arange(w0, device=device)
    trunk_ok = cols[None, :] >= starts[:, None]
    tail_cols = torch.arange(ts, device=device)
    tail_ok = tail_cols <= write_col
    if window is not None:
        trunk_ok = trunk_ok & (qpos[:, None] - (cols[None, :] - starts[:, None]) < window)
        tail_ok = tail_ok & (write_col - tail_cols < window)
    return trunk_ok, tail_ok


def decode_attention_reference(
    q: torch.Tensor,
    trunk_k: torch.Tensor,
    trunk_v: torch.Tensor,
    tail_k: torch.Tensor,
    tail_v: torch.Tensor,
    starts: torch.Tensor,
    qpos,
    write_col,
    n_slots: int,
    n_roles: int,
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain version: float32 logits over [trunk | tail] for every row
    at once, masked softmax, float32 value sum.  Returns (Rows, H, hd) in
    q's dtype."""
    rows, heads, hd = q.shape
    _, w0, kv, _ = trunk_k.shape
    ts = tail_k.shape[1]
    reps = heads // kv
    qg = q.float().reshape(n_slots, n_roles, kv, reps, hd)
    tail_kg = tail_k.float().reshape(n_slots, n_roles, ts, kv, hd)
    tail_vg = tail_v.float().reshape(n_slots, n_roles, ts, kv, hd)
    logits = torch.cat(
        [
            torch.einsum("prgmd,rtgd->prgmt", qg, trunk_k.float()),
            torch.einsum("prgmd,prtgd->prgmt", qg, tail_kg),
        ],
        dim=-1,
    ) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    trunk_ok, tail_ok = _masks(starts, qpos, write_col, w0, ts, window, q.device)
    mask = torch.cat(
        [
            trunk_ok[None].expand(n_slots, n_roles, w0),
            tail_ok.expand(n_slots, n_roles, ts),
        ],
        dim=-1,
    )[:, :, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    weights = torch.where(mask.any(-1, keepdim=True), weights, torch.zeros_like(weights))
    out = torch.einsum("prgmt,rtgd->prgmd", weights[..., :w0], trunk_v.float()) + torch.einsum(
        "prgmt,prtgd->prgmd", weights[..., w0:], tail_vg
    )
    return out.reshape(rows, heads, hd).to(q.dtype)


def _check_shapes(q, trunk_k, trunk_v, tail_k, tail_v, n_slots, n_roles) -> None:
    if q.dim() != 3 or trunk_k.dim() != 4 or tail_k.dim() != 4:
        raise ValueError(
            "decode_attention: q must be (Rows, H, hd), trunk (R, W0, KV, hd), "
            "tail (Rows, Ts, KV, hd)"
        )
    rows, heads, hd = q.shape
    r, _, kv, thd = trunk_k.shape
    if trunk_v.shape != trunk_k.shape or tail_v.shape != tail_k.shape:
        raise ValueError("decode_attention: k and v shapes differ")
    if rows != n_slots * n_roles or r != n_roles or tail_k.shape[0] != rows:
        raise ValueError(
            f"decode_attention: q has {rows} rows, trunk {r} roles, tail "
            f"{tail_k.shape[0]} rows; want {n_slots} slots x {n_roles} roles"
        )
    if thd != hd or tail_k.shape[2:] != (kv, hd) or heads % kv:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, trunk {tuple(trunk_k.shape)} "
            f"and tail {tuple(tail_k.shape)} do not agree on heads and head_dim"
        )


def _check_cuda_inputs(q, trunk_k, trunk_v, tail_k, tail_v) -> None:
    for name, t in (("q", q), ("trunk_k", trunk_k), ("trunk_v", trunk_v),
                    ("tail_k", tail_k), ("tail_v", tail_v)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention kernel takes bfloat16; {name} is {t.dtype}")
        if not t.is_contiguous():
            # The kernel reads the per-layer cache views in place; a copy here
            # would move more bytes than the kernel itself.
            raise ValueError(f"decode_attention: {name} must be contiguous")
    hd = q.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode_attention kernel supports head_dim {KERNEL_HEAD_DIMS}, got {hd}")


def decode_attention(
    q: torch.Tensor,  # (Rows, H, hd), Rows = n_slots * n_roles, slot-major
    trunk_k: torch.Tensor,  # (R, W0, KV, hd)
    trunk_v: torch.Tensor,
    tail_k: torch.Tensor,  # (Rows, Ts, KV, hd)
    tail_v: torch.Tensor,
    starts: torch.Tensor,  # (R,) int -- trunk valid-span starts
    qpos,  # (R,) int tensor -- per-role query position (uniform across slots)
    write_col: int,  # current tail column, a host int
    n_slots: int,
    n_roles: int,
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Fused one-position GQA decode attention over shared trunk + tails;
    (Rows, H, hd) in q's dtype.  See the module docstring."""
    _check_shapes(q, trunk_k, trunk_v, tail_k, tail_v, n_slots, n_roles)
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, trunk_k, trunk_v, tail_k, tail_v, starts, qpos, write_col,
            n_slots, n_roles, scale, softcap, window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    from consensus_tpu_torch.ops.build import load_library

    write_col = int(write_col)
    if not 0 <= write_col < tail_k.shape[1]:
        raise ValueError(f"decode_attention: write_col {write_col} outside the tail")
    q = q.contiguous()
    _check_cuda_inputs(q, trunk_k, trunk_v, tail_k, tail_v)
    starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    qpos = torch.as_tensor(qpos).to(device=q.device, dtype=torch.int32).expand(n_roles).contiguous()
    out = torch.empty_like(q)
    launch_kernel(
        load_library("decode_attention"), q, trunk_k, trunk_v, tail_k, tail_v,
        starts, qpos, write_col, out, n_slots, n_roles, scale, softcap, window,
    )
    launches.add(
        (tuple(q.shape), tuple(trunk_k.shape), tuple(tail_k.shape)), (starts, qpos, write_col)
    )
    return out


def _kernel_call(lib: ctypes.CDLL):
    """The kernel's entry point with its C signature declared (``restype``
    before ``argtypes``, under a lock, as ``flash_attention._kernel_call``)."""
    fn = lib.consensus_decode_attention_fwd
    if fn.argtypes is None:
        with _SIGNATURE_LOCK:
            if fn.argtypes is None:
                fn.restype = ctypes.c_int
                fn.argtypes = (
                    [ctypes.c_void_p] * 10
                    + [ctypes.c_int] * 11
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                )
    return fn


def launch_kernel(lib: ctypes.CDLL, q, trunk_k, trunk_v, tail_k, tail_v, starts, qpos,
                  write_col: int, out, n_slots: int, n_roles: int, scale: float,
                  softcap, window) -> None:
    """One launch of ``lib``'s kernel on checked CUDA tensors, writing
    ``out``; raises on a launch error.  The first pass splits the trunk and
    the tail columns ``0..write_col`` into ``KEY_CHUNK``-key chunks and
    writes fp32 partials to scratch allocated here; the second pass merges
    them.  Counts nothing: callers other than :func:`decode_attention` (a
    check of a deliberately broken build) must not move the launch
    counter."""
    rows, heads, hd = q.shape
    _, w0, kv, _ = trunk_k.shape
    ts = tail_k.shape[1]
    group_rows = n_slots * (heads // kv)
    n_trunk = -(-w0 // KEY_CHUNK)
    n_tail = -(-(write_col + 1) // KEY_CHUNK)
    n_splits = n_trunk + n_tail
    part_ml = torch.empty(
        (n_roles * kv, n_splits, group_rows, 2), dtype=torch.float32, device=q.device
    )
    part_acc = torch.empty(
        (n_roles * kv, n_splits, group_rows, hd), dtype=torch.float32, device=q.device
    )
    err = _kernel_call(lib)(
        q.data_ptr(), trunk_k.data_ptr(), trunk_v.data_ptr(), tail_k.data_ptr(),
        tail_v.data_ptr(), starts.data_ptr(), qpos.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(),
        n_slots, n_roles, heads, kv, hd, w0, ts, write_col, n_trunk, n_tail, KEY_CHUNK,
        float(scale), float(softcap or 0.0), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# Paged attention: gather K/V through per-row block tables
# ---------------------------------------------------------------------------


def paged_attention(
    q: torch.Tensor,  # (B, S, H, hd) -- S query positions per row
    k_pages: torch.Tensor,  # (num_pages [+ sink], page_size, KV, hd)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) int, -1 padded
    lengths: torch.Tensor,  # (B,) int -- valid tokens in the row's stream
    q_positions: torch.Tensor,  # (B, S) int -- query RoPE positions
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA attention over a PAGED KV cache (``ops/decode_attention.py:281-337``
    of the JAX package, plain ``jnp`` there too: it has no Pallas kernel).

    A row's token t sits at page ``table[t // page_size]``, offset ``t %
    page_size``, with RoPE position t (streams are contiguous from 0), so
    causality is position arithmetic.  The gather materializes a (B,
    max_blocks * page_size, KV, hd) view; -1 table entries gather page 0 and
    are masked by ``lengths``, like the columns past a row's length in its
    last page.  Returns (B, S, H, hd) in q's dtype."""
    b, s, h, hd = q.shape
    page_size, kv = k_pages.shape[1], k_pages.shape[2]
    t_len = block_tables.shape[1] * page_size
    safe_tables = block_tables.clamp(min=0).long()
    keys = k_pages[safe_tables].reshape(b, t_len, kv, hd)
    values = v_pages[safe_tables].reshape(b, t_len, kv, hd)

    kpos = torch.arange(t_len, device=q.device)[None, :]
    mask = (kpos[:, None, :] <= q_positions[:, :, None]) & (kpos < lengths[:, None])[:, None, :]
    if window is not None:
        mask = mask & (q_positions[:, :, None] - kpos[:, None, :] < window)

    qg = q.reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, keys).to(torch.float32) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bgrst,btgd->bsgrd", weights, values).reshape(b, s, h, hd)

"""Flash attention for the teacher-forced scoring path (PyTorch port).

Replaces ``consensus_tpu/ops/flash_attention.py::flash_attention`` (the
Pallas TPU kernel, ``_kernel`` :43-116, ``pallas_call`` :181).  The kernel
itself is CUDA C++ for Hopper in ``csrc/flash_attention.cu``, built with
``nvcc`` at first use and called through ``ctypes`` (see ``ops/build.py``).

Masking model, as in the JAX kernel: each batch row holds ONE contiguous
valid span ``[start, start + length)``; positions are the global iota, the
causal and window tests compare those positions, an optional softcap
applies before the mask, and any query position with no valid key comes
out as 0.  Right-padded scoring rows have ``start == 0``; left-padded rows
have ``start == S - length``.

The call keeps the JAX signature -- q, k, v as ``(B, S, H, hd)`` -- and also
takes k, v with fewer heads ``(B, S, KV, hd)`` when ``H % KV == 0``: query
head ``h`` then reads kv head ``h // (H // KV)``, so the model passes its
grouped K/V without repeating them.

Dispatch: a CPU tensor runs :func:`flash_attention_reference`, the plain
PyTorch version; a CUDA tensor launches the kernel (bf16 only, head_dim
128 or 256, each of q, k, v contiguous from a 16-byte aligned address: a
contiguous view at an odd storage offset raises) or raises.  There is no
fallback from one to the other.

What bounds the kernel on an H100 (989 TFLOP/s dense bf16, 3.35 TB/s):
the larger of its causal FLOPs over the bf16 rate and its bytes over the
HBM rate, where the bytes are o in full plus q and the GQA k, v over each
row's span only (outside the span the output is 0 and no tile is read).
At the llama3-8b scoring shape (B=32, S=768, H=32, KV=8, hd=128) with every
row full that is ~1.5e11 FLOPs (~0.16 ms) against ~0.5 GB (~0.15 ms), so
operations set it; with ragged rows both shrink.  ``chip_smoke.py``
computes the bound from each run's lengths; the figures are in PERF.md.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128, 256)
#: The kernel reads q, k, v and writes o through TMA tensor maps, whose base
#: address must be a multiple of 16 bytes.
TMA_ALIGN = 16


class LaunchCounter:
    """Counts kernel launches; ``chip_smoke.py`` zeroes it before driving
    the main path and reads it after.  ``last_shapes`` holds the (q, k)
    shapes of the latest launch and ``last_spans`` its (lengths, starts)
    tensors, so a benchmark can time the kernel at the shapes and spans the
    main path gave it.  Thread-safe: an experiment's worker threads launch
    kernels at once.  Each launch also adds one to the obs registry's
    ``kernel_launches_total{kernel}`` counter and to
    ``kernel_launches_by_device_total{kernel,device}``, which a server's
    ``/metrics`` exposes (``reset`` leaves those monotonic counters alone).
    ``by_device`` counts the launches on each card (``"cuda:1"`` -> N), so a
    run over a device mesh can show that every card launched."""

    def __init__(self, kernel: str) -> None:
        self._lock = threading.Lock()
        #: The registry's children, made once: ``kernel_launches_total``'s,
        #: and ``kernel_launches_by_device_total``'s per device.
        self._total_child = None
        self._device_children: Dict[str, object] = {}
        self.kernel = kernel
        self.reset()

    def _count_in_registry(self, device: str) -> None:
        """Call with ``self._lock`` held."""
        child = self._device_children.get(device)
        if child is None:
            from consensus_tpu_torch.obs.metrics import get_registry

            registry = get_registry()
            if self._total_child is None:
                self._total_child = registry.counter(
                    "kernel_launches_total",
                    "Launches of the hand-written CUDA kernels, by kernel.",
                    labels=("kernel",),
                ).labels(self.kernel)
            child = self._device_children[device] = registry.counter(
                "kernel_launches_by_device_total",
                "Launches of the hand-written CUDA kernels, by kernel and card.",
                labels=("kernel", "device"),
            ).labels(self.kernel, device)
        self._total_child.inc()
        child.inc()

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_device: Dict[str, int] = {}
            self.last_shapes: Optional[tuple] = None
            self.last_spans: Optional[tuple] = None

    def add(self, shapes: tuple, spans: tuple, device: torch.device) -> None:
        key = str(device)
        with self._lock:
            self._count_in_registry(key)
            self.count += 1
            self.by_device[key] = self.by_device.get(key, 0) + 1
            self.last_shapes = shapes
            self.last_spans = spans


launches = LaunchCounter("flash_attention")
_SIGNATURE_LOCK = threading.Lock()


def _span_mask(lengths: torch.Tensor, starts: torch.Tensor, seq: int) -> torch.Tensor:
    pos = torch.arange(seq, device=lengths.device)
    starts = starts.to(torch.int64)[:, None]
    ends = starts + lengths.to(torch.int64)[:, None]
    return (pos[None, :] >= starts) & (pos[None, :] < ends)  # (B, S)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    causal: bool = True,
) -> torch.Tensor:
    """The plain version: masked softmax attention in float32, whole
    (B, H, S, S) logits at once.  Returns (B, S, H, hd) in q's dtype."""
    batch, seq, heads, head_dim = q.shape
    if scale is None:
        scale = head_dim ** -0.5
    if starts is None:
        starts = torch.zeros_like(lengths)
    reps = heads // k.shape[2]
    if reps > 1:
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    valid = _span_mask(lengths, starts, seq)
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    pos = torch.arange(seq, device=q.device)
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    if window is not None:
        mask = mask & ((pos[:, None] - pos[None, :]) < window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    weights = torch.where(mask.any(-1, keepdim=True), weights, torch.zeros_like(weights))
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(q.dtype)


def _kernel_call(lib: ctypes.CDLL):
    """The kernel's entry point with its C signature declared.  ``restype``
    is set before ``argtypes``, under a lock: a thread that sees
    ``argtypes`` set sees the whole signature."""
    fn = lib.consensus_flash_attention_fwd
    if fn.argtypes is None:
        with _SIGNATURE_LOCK:
            if fn.argtypes is None:
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p,
                ]
    return fn


def _check_cuda_inputs(q, k, v, lengths, starts) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"flash_attention kernel takes bfloat16; {name} is {t.dtype}"
            )
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, heads, hd)")
    batch, seq, heads, head_dim = q.shape
    if k.shape != v.shape or k.shape[:2] != (batch, seq) or k.shape[3] != head_dim:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if heads % k.shape[2]:
        raise ValueError(
            f"flash_attention: {heads} query heads not a multiple of {k.shape[2]} kv heads"
        )
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel supports head_dim {KERNEL_HEAD_DIMS}, got {head_dim}"
        )
    for name, t in (("lengths", lengths), ("starts", starts)):
        if t.shape != (batch,) or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be ({batch},) on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % TMA_ALIGN:
            raise ValueError(
                f"flash_attention kernel: {name} must be contiguous from a "
                f"{TMA_ALIGN}-byte aligned address (its TMA tensor map's rule); it has "
                f"strides {t.stride()} and a storage offset of {t.storage_offset()} elements"
            )


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd), H % KV == 0 (KV == H is the JAX call)
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int -- valid-span length per row
    starts: Optional[torch.Tensor] = None,  # (B,) int -- span start (default 0)
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Attention over rows with one contiguous valid span; (B, S, H, hd) in
    q's dtype, zero outside the span.  See the module docstring."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # The Pallas kernel this replaces has no backward either: jax.grad
        # through it fails, on every device.
        raise NotImplementedError(
            "flash_attention has no backward; take gradients with "
            "use_flash_attention off"
        )
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, lengths, starts, scale, softcap, window, causal
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from consensus_tpu_torch.ops.build import load_library

    batch, seq, heads, head_dim = q.shape
    if scale is None:
        scale = head_dim ** -0.5
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_cuda_inputs(q, k, v, lengths, starts)
    out = torch.empty_like(q)
    if batch == 0 or seq == 0:
        return out
    launch_kernel(
        load_library("flash_attention"), q, k, v, out, lengths, starts,
        scale, softcap, window, causal,
    )
    launches.add((tuple(q.shape), tuple(k.shape)), (lengths, starts), q.device)
    return out


def launch_kernel(lib: ctypes.CDLL, q, k, v, out, lengths, starts,
                  scale: float, softcap, window, causal) -> None:
    """One launch of ``lib``'s kernel on checked, contiguous CUDA tensors,
    writing ``out``; raises on a launch error.  Counts nothing: callers
    other than :func:`flash_attention` (a check of a deliberately broken
    build) must not move the launch counter."""
    batch, seq, heads, head_dim = q.shape
    # The launch runs in q's device context: the kernel's shared-memory
    # limit is set there, and the stream passed is that device's.
    with torch.cuda.device(q.device):
        err = _kernel_call(lib)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), starts.data_ptr(),
            batch, seq, heads, k.shape[2], head_dim,
            float(scale), float(softcap or 0.0), int(window or 0), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")

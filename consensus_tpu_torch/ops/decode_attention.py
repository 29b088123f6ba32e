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

The kernel is one launch: the blocks that split one (role, kv head) group's
keys form a thread-block cluster and merge their partial softmax sums in
distributed shared memory (the design is in the ``.cu`` file's header).
:func:`launch_plan` sizes the split on the host from the grid and how many
clusters the card holds at once; :func:`split_units` is the key tiles each
block of a cluster walks, as the kernel computes them on the device.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128, 256)
#: Keys per pipeline stage of the kernel, by head_dim (its K and V ~34 KB
#: either way); a group's keys are cut into tiles of this many.
STAGE_KEYS = {128: 64, 256: 32}
#: Query rows one block holds: four 16-row tiles of the tensor-core product.
BLOCK_ROWS = 64
#: Blocks of one cluster, the most that split one group's keys: 8, the
#: largest portable cluster size.
MAX_SPLITS = 8
#: A block's fixed time -- its start, Q's and its first tile's latency, the
#: cluster's merge -- in key tiles' time, for weighing splits against waves
#: (on an H100: ~5-6 us against ~1-1.5 us a tile, per-block traces of the
#: kernel).
FIXED_TILES = 4
#: CUDA's limit on grid dims y and z (the (role, kv head) groups and the row
#: blocks).
MAX_GRID_YZ = 65535


class LaunchPlan(NamedTuple):
    """How one call is cut: ``splits`` blocks (one cluster) share each
    (role, kv head, row block) group's keys; a block holds the query rows of
    ``slots_per_block`` slots, and ``row_blocks`` blocks cover the slots."""

    splits: int
    slots_per_block: int
    row_blocks: int

    def grid(self, n_roles: int, kv: int) -> Tuple[int, int, int]:
        return (self.splits, n_roles * kv, self.row_blocks)


def block_rows(n_slots: int, heads: int, kv: int) -> int:
    """Query rows one block holds: whole slots, at most ``BLOCK_ROWS``."""
    reps = heads // kv
    if reps > BLOCK_ROWS:
        raise ValueError(f"decode_attention kernel holds at most {BLOCK_ROWS} query heads "
                         f"per kv head, got {reps}")
    return min(n_slots, BLOCK_ROWS // reps) * reps


@functools.lru_cache(maxsize=4096)
def launch_plan(n_slots: int, n_roles: int, heads: int, kv: int, head_dim: int, w0: int,
                write_col: int, sms: int, max_splits: int = MAX_SPLITS,
                capacity: Optional[Tuple[int, ...]] = None) -> LaunchPlan:
    """The split of one call, from what the host knows: the groups of the
    grid, a group's key tiles (the trunk in full -- its valid span is read
    on the device -- and the tail columns ``0..write_col`` of each slot a
    block holds), and how many clusters of each size the card holds at once
    (``capacity[s - 1]`` for clusters of s blocks; ``None`` takes ``sms //
    s``, a card whose clusters pack perfectly).  Each candidate split costs
    its waves times a block's tiles plus ``FIXED_TILES``; the cheapest wins,
    the smaller on a tie."""
    reps = heads // kv
    slots_per_block = block_rows(n_slots, heads, kv) // reps
    row_blocks = -(-n_slots // slots_per_block)
    if n_roles * kv > MAX_GRID_YZ or row_blocks > MAX_GRID_YZ:
        raise ValueError(f"decode_attention: grid y {n_roles * kv} or z {row_blocks} "
                         f"exceeds CUDA's limit of {MAX_GRID_YZ}")
    keys = STAGE_KEYS[head_dim]
    tiles = -(-w0 // keys) + slots_per_block * -(-(write_col + 1) // keys)
    groups = n_roles * kv * row_blocks
    best = None
    for splits in range(1, min(max_splits, tiles) + 1):
        held = capacity[splits - 1] if capacity is not None else sms // splits
        if held < 1:
            continue
        cost = -(-groups // held) * (-(-tiles // splits) + FIXED_TILES)
        if best is None or cost < best[0]:
            best = (cost, splits)
    return LaunchPlan(best[1] if best else 1, slots_per_block, row_blocks)


def _slot_in_turn(q: int, slots: int, tile_slots: int) -> int:
    """The q-th slot in the order that takes the row tiles in turn
    (``slot_in_turn`` in the ``.cu`` file)."""
    tiles = -(-slots // tile_slots)
    last = slots - (tiles - 1) * tile_slots
    if q < last * tiles:
        return (q % tiles) * tile_slots + q // tiles
    q -= last * tiles
    return (q % (tiles - 1)) * tile_slots + last + q // (tiles - 1)


def split_units(plan: LaunchPlan, n_slots: int, reps: int, head_dim: int, w0: int, start: int,
                qpos: int, write_col: int, window: Optional[int], row_block: int = 0
                ) -> List[List[Tuple[Optional[int], int, int]]]:
    """The key tiles each block of one group's cluster walks, as the kernel
    computes them on the device (``span_of`` / ``unit_of`` in the ``.cu``
    file): per split, a list of ``(slot or None for the trunk, lo, hi)``.
    The trunk's valid span ``[lo, W0)`` in tiles first, then the row block's
    slots' tail spans, tile j of every slot (row tiles in turn) before tile
    j + 1; block b takes tiles ``[b*U/splits, (b+1)*U/splits)``."""
    keys = STAGE_KEYS[head_dim]
    p0 = row_block * plan.slots_per_block
    slots = min(n_slots, p0 + plan.slots_per_block) - p0
    lo = max(start, 0)
    if window is not None:
        lo = max(lo, qpos + start - window + 1)
    tiles: List[Tuple[Optional[int], int, int]] = [
        (None, k, min(k + keys, w0)) for k in range(lo, w0, keys)
    ]
    tail_lo = 0 if window is None else max(0, write_col - window + 1)
    tile_slots = max(1, 16 // reps)
    for k in range(tail_lo, write_col + 1, keys):
        tiles += [(p0 + _slot_in_turn(q, slots, tile_slots), k, min(k + keys, write_col + 1))
                  for q in range(slots)]
    n = len(tiles)
    return [tiles[b * n // plan.splits:(b + 1) * n // plan.splits] for b in range(plan.splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_capacity(lib: ctypes.CDLL, device_index: int, head_dim: int,
                      rows: int) -> Tuple[int, ...]:
    """How many clusters of 1..MAX_SPLITS blocks ``lib``'s kernel fits on
    the card at once, for blocks of ``rows`` query rows: asked once per
    (library, card, instantiation)."""
    fn = lib.consensus_decode_attention_max_clusters
    with _SIGNATURE_LOCK:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3
    with torch.cuda.device(device_index):
        held = tuple(fn(head_dim, rows, splits) for splits in range(1, MAX_SPLITS + 1))
    if any(n < 0 for n in held):
        raise RuntimeError(f"decode_attention: cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {-min(held)}")
    return held


class LaunchCounter:
    """Counts kernel launches; ``chip_smoke.py`` zeroes it before driving
    the token-search path and reads it after.  ``shapes`` maps each (q,
    trunk, tail) shape launched to ``[launches, (starts, qpos, write_col)
    of its latest launch]``, so a benchmark can time the kernel at the
    shapes and spans the path gave it.  Thread-safe: an experiment's worker
    threads launch kernels at once.  Each launch also adds one to the obs
    registry's ``kernel_launches_total{kernel}`` counter and to
    ``kernel_launches_by_device_total{kernel,device}``, which a server's
    ``/metrics`` exposes (``reset`` leaves those monotonic counters alone).
    ``by_device`` counts the launches on each card (``"cuda:1"`` -> N)."""

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
            self.shapes: Dict[tuple, list] = {}

    def add(self, shape: tuple, args: tuple, device: torch.device) -> None:
        key = str(device)
        with self._lock:
            self._count_in_registry(key)
            self.count += 1
            self.by_device[key] = self.by_device.get(key, 0) + 1
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
        (tuple(q.shape), tuple(trunk_k.shape), tuple(tail_k.shape)), (starts, qpos, write_col),
        q.device,
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
                    [ctypes.c_void_p] * 8
                    + [ctypes.c_int] * 10
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                )
    return fn


def launch_kernel(lib: ctypes.CDLL, q, trunk_k, trunk_v, tail_k, tail_v, starts, qpos,
                  write_col: int, out, n_slots: int, n_roles: int, scale: float,
                  softcap, window, max_splits: int = MAX_SPLITS) -> None:
    """One launch of ``lib``'s kernel on checked CUDA tensors, writing
    ``out``; raises on a launch error (a cluster size or shared-memory size
    the card refuses included).  The split comes from :func:`launch_plan`;
    the kernel allocates nothing and the wrapper no scratch.  Counts
    nothing: callers other than :func:`decode_attention` (a check of a
    deliberately broken build) must not move the launch counter."""
    _, heads, hd = q.shape
    _, w0, kv, _ = trunk_k.shape
    ts = tail_k.shape[1]
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    capacity = _cluster_capacity(lib, index, hd, block_rows(n_slots, heads, kv))
    plan = launch_plan(n_slots, n_roles, heads, kv, hd, w0, write_col, _sm_count(index),
                       max_splits, capacity)
    # The launch runs in q's device context (see flash_attention.launch_kernel).
    with torch.cuda.device(q.device):
        err = _kernel_call(lib)(
            q.data_ptr(), trunk_k.data_ptr(), trunk_v.data_ptr(), tail_k.data_ptr(),
            tail_v.data_ptr(), starts.data_ptr(), qpos.data_ptr(), out.data_ptr(),
            n_slots, n_roles, heads, kv, hd, w0, ts, write_col, plan.splits,
            plan.slots_per_block, float(scale), float(softcap or 0.0), int(window or 0),
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

"""Tensor parallelism on one controller: the collectives, the per-rank
parameter container and the per-rank KV container.

One thread issues every tp rank's work, layer by layer, as one JAX
controller drives every device of its mesh.  A tp group is one row of a
:class:`~consensus_tpu_torch.parallel.mesh.MeshPlan`; rank 0's card is the
LEAD, where every host read (sampling, argmax, top-k, ``.item()``) happens
on full-vocab tensors, so no logic above the model layer changes.

* Parameters: :class:`TPParams`, one Megatron slice tree per rank on its
  card (``mesh.shard_params``).  A tp=1 model keeps its plain dict.
* Activations between layers are replicated: a list with one tensor per
  rank, bit-identical, since every collective sums in rank order.
* Query heads: rank t owns columns ``[t * C, (t + 1) * C)`` of the
  flattened ``n_heads * head_dim`` (``C = n_heads * head_dim / tp``), and
  holds whole copies of the heads that range touches
  (:func:`q_heads_of_rank`); it computes their attention in full and keeps
  its own C columns (:func:`q_columns_of_rank`) for its even slice of
  ``wo`` rows, so a tp that cuts a query head runs the kernels on whole
  heads.
* KV state (caches, tails, page pools) is :class:`Ranked`: one contiguous
  tensor per rank with the kv heads that rank's query heads read
  (:func:`kv_heads_of_rank`: ``n_kv_heads / tp`` of them where tp divides
  the kv heads, else copies of a shared head, each computed from the
  rank's own copy of its ``wk``/``wv`` columns).  Indexing,
  torch functions, tensor methods and arithmetic map over the ranks, so the
  cache bookkeeping (beam reorders, compaction, concatenation, int8
  quantization) runs unchanged on it; a plain tensor among the arguments is
  a replicated input (indices, masks, zeros) and is copied to each rank.

The collectives are plain PyTorch: rank ``t`` receives ``sum_r
partial_r.to(device_t)`` in rank order.  That is one code path on the CPU,
on one card repeated (``tp=2`` over ``cuda:0`` twice) and on distinct cards
(peer copies), and autograd differentiates it as written.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.quant import QTensor


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_reduce(partials: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum the ranks' partials onto every rank, in rank order: element ``t``
    of the result lies on ``partials[t]``'s device.  Ranks that share a
    device share one sum."""
    sums: Dict[str, torch.Tensor] = {}
    out = []
    for part in partials:
        key = str(part.device)
        if key not in sums:
            total = partials[0].to(part.device)
            for other in partials[1:]:
                total = total + other.to(part.device)
            sums[key] = total
        out.append(sums[key])
    return out


def gather_vocab(slices: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ranks' vocab slices (..., V/tp) concatenated in rank order along
    the last axis on the lead (rank 0's) device -> (..., V)."""
    lead = slices[0].device
    return torch.cat([s.to(lead) for s in slices], dim=-1)


def replicate(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on every rank's device (no copy where it already lies)."""
    return [x.to(device) for device in devices]


# ---------------------------------------------------------------------------
# Per-rank configuration and parameters
# ---------------------------------------------------------------------------


def check_tp(config: ModelConfig, tp: int) -> None:
    """Raise ``ValueError`` naming the first count that ``tp`` does not
    divide: the query columns ``n_heads*head_dim``, the kv columns
    ``n_kv_heads*head_dim``, the FFN width or the vocab, where the JAX
    package's ``shard_params`` refuses the uneven split.  A rank's column
    range may cut a query head (:func:`q_heads_of_rank`), and the kv heads
    need not divide (:func:`kv_heads_of_rank`)."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    counts = (
        ("n_heads*head_dim", config.n_heads * config.head_dim),
        ("n_kv_heads*head_dim", config.n_kv_heads * config.head_dim),
        ("ffn_hidden", config.ffn_hidden),
        ("vocab_size", config.vocab_size),
    )
    for name, value in counts:
        if value % tp:
            raise ValueError(
                f"tp={tp} does not divide {name}={value} of {config.name}: "
                "a tensor-parallel rank holds equal slices"
            )


@functools.lru_cache(maxsize=None)
def _q_layout(config: ModelConfig, tp: int) -> Tuple[int, Tuple[int, ...]]:
    """(query heads per rank, each rank's first query head)."""
    check_tp(config, tp)
    heads, hd = config.n_heads, config.head_dim
    width = heads * hd // tp
    count = max(((t + 1) * width - 1) // hd - t * width // hd + 1 for t in range(tp))
    return count, tuple(min(t * width // hd, heads - count) for t in range(tp))


def q_heads_of_rank(config: ModelConfig, tp: int, rank: int) -> Tuple[int, ...]:
    """The query heads rank ``rank`` computes, contiguous.  The rank owns
    columns ``[rank * C, (rank + 1) * C)`` of the flattened ``n_heads *
    head_dim`` (``C = n_heads * head_dim / tp``: the JAX package's ``wq``
    columns and ``wo`` rows) and holds whole copies of the query heads that
    range touches, so attention runs on whole heads through the kernels.
    Where tp divides the heads these are ``n_heads / tp`` of its own; else
    two ranks may hold one head, and every rank is padded to the count the
    busiest rank touches with the heads after its own (before them at the
    top), so all ranks have one shape.  :func:`q_columns_of_rank` names the
    columns of its output that are its own."""
    count, firsts = _q_layout(config, tp)
    return tuple(range(firsts[rank], firsts[rank] + count))


def q_columns_of_rank(config: ModelConfig, tp: int, rank: int) -> Optional[slice]:
    """Rank ``rank``'s own ``C`` columns of its heads' attention output
    (..., len(q_heads_of_rank) * head_dim), which meet its even slice of
    ``wo`` rows; None where they are all of it (tp divides the heads)."""
    count, firsts = _q_layout(config, tp)
    hd = config.head_dim
    width = config.n_heads * hd // tp
    if width == count * hd:
        return None
    offset = rank * width - firsts[rank] * hd
    return slice(offset, offset + width)


@functools.lru_cache(maxsize=None)
def _kv_layout(config: ModelConfig, tp: int) -> Tuple[Tuple[int, ...], ...]:
    """Each rank's kv heads (:func:`kv_heads_of_rank`)."""
    group = config.n_heads // config.n_kv_heads
    ranks = [q_heads_of_rank(config, tp, t) for t in range(tp)]

    def grouped(heads: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
        first, last = heads[0] // group, heads[-1] // group
        if first == last or (heads[0] % group == 0 and len(heads) == (last - first + 1) * group):
            return tuple(range(first, last + 1))
        return None

    layouts = [grouped(heads) for heads in ranks]
    if all(layouts) and len({len(kv) for kv in layouts}) == 1:
        return tuple(layouts)
    return tuple(tuple(q // group for q in heads) for heads in ranks)


def kv_heads_of_rank(config: ModelConfig, tp: int, rank: int) -> Tuple[int, ...]:
    """The kv heads rank ``rank`` holds, in its local order; the same count
    on every rank.  Its query heads are :func:`q_heads_of_rank`'s, and a
    query head ``q`` reads kv head ``q // (n_heads / n_kv_heads)``.

    * Every rank's query heads lie in one group, or cover whole groups from
      a group boundary: those kv heads once each (``n_kv_heads / tp`` of
      them where tp divides the kv heads, else one shared head), and the
      rank runs grouped attention.
    * Otherwise some rank's query heads straddle groups: one kv copy per
      query head on every rank, and the ranks run plain multi-head
      attention."""
    return _kv_layout(config, tp)[rank]


@functools.lru_cache(maxsize=None)
def local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """The config one rank computes with: the query heads of
    :func:`q_heads_of_rank` and the kv heads of :func:`kv_heads_of_rank`
    (each the same count on every rank), ``ffn_hidden / tp`` FFN columns
    and ``vocab_size / tp`` vocab rows."""
    check_tp(config, tp)
    if tp == 1:
        return config
    return dataclasses.replace(
        config,
        n_heads=len(q_heads_of_rank(config, tp, 0)),
        n_kv_heads=len(kv_heads_of_rank(config, tp, 0)),
        ffn_hidden=config.ffn_hidden // tp,
        vocab_size=config.vocab_size // tp,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class TPParams:
    """A tensor-parallel model: ``ranks[t]`` is rank t's Megatron slice tree
    (``mesh.shard_params``) on ``devices[t]``.  Rank 0's device is the
    lead."""

    ranks: Tuple[Dict[str, Any], ...]
    devices: Tuple[torch.device, ...]
    #: Each rank's kv-head count (``local_config(...).n_kv_heads``); None
    #: stands for ``n_kv_heads / tp``.
    kv_heads: Optional[int] = None

    @property
    def tp(self) -> int:
        return len(self.ranks)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def tp_params(params: Dict[str, Any], config: ModelConfig,
              devices: Sequence[torch.device]) -> TPParams:
    """Shard a full parameter dict over ``devices`` (one tp group): the
    counts are checked first, then ``mesh.shard_params`` slices each leaf
    onto its rank's card.  int8 weights shard as stored (quantize first)."""
    from consensus_tpu_torch.parallel.mesh import MeshPlan, shard_params

    devices = tuple(torch.device(d) for d in devices)
    trees = shard_params(params, MeshPlan(devices=(devices,)), config)[0]
    return tp_group(trees, devices, config)


def tp_group(trees: Sequence[Dict[str, Any]], devices: Sequence[torch.device],
             config: ModelConfig) -> TPParams:
    """A :class:`TPParams` of one tp row's slice trees (from ``shard_params``
    or a sharded ``restore_params``)."""
    tp = len(trees)
    return TPParams(ranks=tuple(trees), devices=tuple(devices),
                    kv_heads=local_config(config, tp).n_kv_heads)


def is_tp(params: Any) -> bool:
    return isinstance(params, TPParams)


# ---------------------------------------------------------------------------
# Per-rank tensors
# ---------------------------------------------------------------------------


def _rank_part(obj: Any, t: int, device: torch.device, memo: Optional[dict] = None) -> Any:
    """Rank ``t``'s part of ``obj``: a :class:`Ranked`'s own tensor, a plain
    tensor's copy on ``device``, containers mapped (tuples, named tuples,
    lists, dataclasses); anything else as is."""
    if isinstance(obj, Ranked):
        return obj.parts[t]
    if isinstance(obj, torch.Tensor):
        if memo is None:
            return obj.to(device)
        hit = memo.get(id(obj))
        if hit is None:
            # The original stays referenced, so its id is not reused.
            hit = memo[id(obj)] = (obj, obj.to(device))
        return hit[1]
    if isinstance(obj, tuple):
        parts = [_rank_part(o, t, device, memo) for o in obj]
        return type(obj)(*parts) if hasattr(obj, "_fields") else tuple(parts)
    if isinstance(obj, list):
        return [_rank_part(o, t, device, memo) for o in obj]
    if isinstance(obj, QTensor):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{
            f.name: _rank_part(getattr(obj, f.name), t, device, memo)
            for f in dataclasses.fields(obj)
        })
    return obj


def _find_ranked(obj: Any) -> Optional["Ranked"]:
    if isinstance(obj, Ranked):
        return obj
    if isinstance(obj, (tuple, list)):
        for o in obj:
            found = _find_ranked(o)
            if found is not None:
                return found
    if isinstance(obj, dict):
        return _find_ranked(tuple(obj.values()))
    return None


def _wrap(results: List[Any]) -> Any:
    first = results[0]
    if isinstance(first, torch.Tensor):
        return Ranked(results)
    if isinstance(first, (tuple, list)) and first and isinstance(first[0], torch.Tensor):
        fields = [Ranked([r[i] for r in results]) for i in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else type(first)(fields)
    return first


def _map_ranks(func, args: tuple, kwargs: dict) -> Any:
    ranked = _find_ranked((args, kwargs))
    out = []
    for t, part in enumerate(ranked.parts):
        device = part.device
        out.append(func(
            *[_rank_part(a, t, device) for a in args],
            **{k: _rank_part(v, t, device) for k, v in kwargs.items()},
        ))
    return _wrap(out)


def _binary(op):
    def method(self, other):
        return _map_ranks(op, (self, other), {})
    return method


def _reflected(op):
    def method(self, other):
        return _map_ranks(lambda a, b: op(b, a), (self, other), {})
    return method


class Ranked:
    """One tensor per tp rank, each on its rank's device: the head-sharded
    KV state.  Torch functions, indexing (also assignment), tensor methods
    and arithmetic map over the ranks, and a plain tensor argument is
    copied to each rank as a replicated input.  ``shape``, ``dtype`` and
    ``device`` are rank 0's (the local head count)."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _map_ranks(func, args, kwargs or {})

    @property
    def shape(self) -> torch.Size:
        return self.parts[0].shape

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    def __getitem__(self, index):
        return _map_ranks(operator.getitem, (self, index), {})

    def __setitem__(self, index, value) -> None:
        for t, part in enumerate(self.parts):
            part[_rank_part(index, t, part.device)] = _rank_part(value, t, part.device)

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)

        def method(*args, **kwargs):
            return _map_ranks(
                lambda part, *a, **k: getattr(part, name)(*a, **k), (self,) + args, kwargs
            )

        return method

    __add__ = _binary(operator.add)
    __radd__ = _reflected(operator.add)
    __sub__ = _binary(operator.sub)
    __rsub__ = _reflected(operator.sub)
    __mul__ = _binary(operator.mul)
    __rmul__ = _reflected(operator.mul)
    __truediv__ = _binary(operator.truediv)
    __rtruediv__ = _reflected(operator.truediv)

    def __repr__(self) -> str:
        return f"Ranked({[tuple(p.shape) for p in self.parts]}, {self.dtype}, " \
               f"{[str(p.device) for p in self.parts]})"


def kv_zeros(params: Any, shape: Sequence[int], dtype: torch.dtype, device) -> Any:
    """Zeros for KV state of the full-model ``shape`` whose axis -2 is the
    kv-head axis (values (..., KV, hd), int8 scales (..., KV, 1)): a plain
    tensor for a tp=1 model, else a :class:`Ranked` of each rank's kv heads
    (``params.kv_heads``), each contiguous on its rank's card."""
    if not is_tp(params):
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    local = list(shape)
    if params.kv_heads is not None:
        local[-2] = params.kv_heads
    elif local[-2] % params.tp:
        raise ValueError(
            f"{local[-2]} kv heads do not split {params.tp} ways: build the TPParams "
            "with tp_group(), which records each rank's kv-head count"
        )
    else:
        local[-2] //= params.tp
    return Ranked([torch.zeros(local, dtype=dtype, device=d) for d in params.devices])


def to_devices(x: Any, devices: Sequence[torch.device]) -> Any:
    """``x`` moved onto a tp group's devices: a :class:`Ranked` rank by
    rank (rank t's part to ``devices[t]``), a plain tensor to the lead."""
    if isinstance(x, Ranked):
        return Ranked([p.to(d) for p, d in zip(x.parts, devices)])
    return x.to(devices[0])


def lead_part(x: Any) -> Any:
    """Rank 0's tensor of a per-rank list or :class:`Ranked`; a plain
    tensor as is."""
    if isinstance(x, Ranked):
        return x.parts[0]
    if isinstance(x, list):
        return x[0]
    return x


# ---------------------------------------------------------------------------
# Rank views of one forward
# ---------------------------------------------------------------------------


class RankView:
    """Rank ``index``'s side of one forward call: its parameter tree, its
    local config and device, its own ``columns`` of its heads' attention
    output (None: all of them), and ``view(obj)``, its part of ``obj`` (its
    own tensor of a :class:`Ranked`, its copy of a replicated lead tensor,
    memoized for the call).  A tp=1 model has one view whose ``view(obj)``
    is ``obj``."""

    __slots__ = ("index", "tree", "config", "device", "columns", "_memo")

    def __init__(self, index: int, tree, config: ModelConfig, device: Optional[torch.device],
                 columns: Optional[slice] = None):
        self.index = index
        self.tree = tree
        self.config = config
        self.device = device
        self.columns = columns
        self._memo: Optional[dict] = {} if device is not None else None

    def __call__(self, obj: Any) -> Any:
        if self._memo is None:
            return obj
        return _rank_part(obj, self.index, self.device, self._memo)


def rank_views(params: Any, config: ModelConfig) -> List[RankView]:
    """One :class:`RankView` per rank of ``params`` (one for a tp=1 dict)."""
    if not is_tp(params):
        return [RankView(0, params, config, None)]
    local = local_config(config, params.tp)
    return [RankView(t, tree, local, device, q_columns_of_rank(config, params.tp, t))
            for t, (tree, device) in enumerate(zip(params.ranks, params.devices))]

"""Device mesh and sharding layout for the port's model runtime (PyTorch
port of ``consensus_tpu/parallel/mesh.py``).

Layout, as in the JAX package:

* Mesh axes ``("data", "model")``.  The experiment workload -- (seeds x
  scenarios x candidates x agents) forward passes -- is embarrassingly
  data-parallel, so ``data`` is the large axis; ``model`` carries tensor
  parallelism.
* Tensor-parallel params follow the Megatron layout: attention q/k/v
  projections and the FFN up/gate split their *output* features over
  ``model``; the o-projection and FFN down split their *input* features;
  the embedding shards its vocab rows.

One process drives every device (as one JAX controller drives
``jax.devices()``): a :class:`MeshPlan` is a ``(dp, tp)`` grid of indexed
``torch.device``s, and :func:`shard_params` gives one parameter tree per
grid position.  Over ``data`` the trees are replicas (a device that repeats
in the grid shares one copy); over ``model`` they are the Megatron slices,
which the tensor-parallel forward runs (``parallel/tensor.py``'s
``TPParams``: one slice tree per rank of a dp shard's row).

The port keeps a per-layer list, ``params["layers"]``, where the JAX package
stacks layers on a leading tensor axis.  The rules keep the JAX regexes and
specs; on a per-layer leaf the spec's leading (layer) entry is dropped.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from consensus_tpu_torch.models.config import ModelConfig
from consensus_tpu_torch.models.quant import QTensor

DATA_AXIS = "data"
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one mesh-axis name (or None) per tensor axis, as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes: Optional[str]) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A ``(dp, tp)`` grid of indexed devices: ``devices[d][t]``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each dp shard's first tp position."""
        return tuple(row[0] for row in self.devices)

    @property
    def distinct_devices(self) -> int:
        return len({str(d) for row in self.devices for d in row})


def _indexed(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {dev}")
    return dev


def default_devices() -> List[torch.device]:
    """The visible cards; raises when there is none (a mesh meant for the
    card never carries on on the CPU: pass ``cpu`` entries explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu', ...] for a CPU mesh"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    tp: int = 1,
    dp: Optional[int] = None,
) -> MeshPlan:
    """Build a ``(data, model)`` mesh over the given (default: the visible
    cards') devices, as ``mesh.py:49``.  ``tp`` is the tensor-parallel
    degree; the remaining devices become data parallel.  An explicit ``dp``
    smaller than ``n // tp`` uses the first ``dp * tp`` devices.  An explicit
    list may hold any count of ``cpu`` entries and may repeat a card."""
    devices = [_indexed(d) for d in (devices if devices is not None else default_devices())]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if tp < 1 or n % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    dp = dp if dp is not None else n // tp
    if dp < 1:
        raise ValueError(f"dp={dp} must be >= 1")
    if dp * tp > n:
        raise ValueError(f"dp*tp = {dp * tp} > device count {n}")
    grid = tuple(tuple(devices[d * tp : (d + 1) * tp]) for d in range(dp))
    return MeshPlan(devices=grid)


#: Regex partition rules: the first rule whose pattern ``re.search``-matches
#: a ``/``-joined param path wins (``mesh.py:80``).  Layer leaves' specs
#: carry the JAX package's leading layer axis, dropped on the port's
#: per-layer tensors.  Every param path of every supported model family must
#: match: :func:`match_partition_rules` raises on an unmatched path.
PARTITION_RULES: Tuple[Tuple[str, P], ...] = (
    # Norm vectors replicate (tiny; every shard needs them whole).
    (r"^layers/(attn_norm|ffn_norm|post_attn_norm|post_ffn_norm)$", P(None, None)),
    # (L, D, H*hd): split heads (output features) over model.
    (r"^layers/(wq|wk|wv)$", P(None, None, MODEL_AXIS)),
    # (L, H*hd, D): split input features -- the contraction needs a sum.
    (r"^layers/wo$", P(None, MODEL_AXIS, None)),
    # (L, D, F): split hidden features.
    (r"^layers/(w_gate|w_up)$", P(None, None, MODEL_AXIS)),
    # (L, F, D): split input features.
    (r"^layers/w_down$", P(None, MODEL_AXIS, None)),
    # (V, D): shard vocab rows; logits come out sharded over vocab.
    (r"^(embed|lm_head)$", P(MODEL_AXIS, None)),
    (r"^final_norm$", P(None)),
)


def _iter_param_paths(params: Dict[str, Any]):
    """Yield (``/``-joined path, layer index or None, leaf) for the port's
    parameter dict.  A QTensor counts as ONE leaf."""
    for name, value in params.items():
        if name == "layers":
            for index, layer in enumerate(value):
                for key, leaf in layer.items():
                    yield f"layers/{key}", index, leaf
        else:
            yield name, None, value


def match_partition_rules(
    params: Dict[str, Any],
    rules: Sequence[Tuple[str, P]] = PARTITION_RULES,
) -> Dict[str, Any]:
    """Partition specs for ``params`` from regex rules (``mesh.py:110``):
    the same structure (``"layers"`` a list of per-layer dicts) with a
    :class:`P` per leaf, layer specs without the layer axis.  Scalars and
    single-element leaves never partition (``P()``).  Raises ``ValueError``
    naming EVERY unmatched path."""
    specs: Dict[str, Any] = {}
    unmatched: List[str] = []
    for path, index, leaf in _iter_param_paths(params):
        shape = tuple(leaf.shape)
        if len(shape) == 0 or _numel(shape) == 1:
            spec = P()
        else:
            for pattern, rule_spec in rules:
                if re.search(pattern, path) is not None:
                    spec = P(*rule_spec[1:]) if index is not None else rule_spec
                    break
            else:
                unmatched.append(path)
                continue
        if index is None:
            specs[path] = spec
        else:
            layers = specs.setdefault("layers", [{} for _ in params["layers"]])
            layers[index][path.split("/", 1)[1]] = spec
    if unmatched:
        raise ValueError(
            "no partition rule matches param path(s): "
            + ", ".join(sorted(set(unmatched)))
            + " -- add a rule to consensus_tpu_torch.parallel.mesh.PARTITION_RULES"
        )
    return specs


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for dim in shape:
        n *= int(dim)
    return n


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where each piece of one tensor lives on a mesh: a spec over its axes.
    ``index(shape, d, t)`` is the piece of the tensor that grid position
    ``(d, t)`` holds (a dim named ``model`` splits evenly over tp; ``data``
    over dp; None replicates).  With ``heads`` the ``model`` dim is instead
    a row of ``head_dim``-wide heads and tp rank t holds heads
    ``heads[t]`` (``tensor.q_heads_of_rank`` / ``tensor.kv_heads_of_rank``:
    a head may repeat across ranks and within one); the piece is then a
    slice where those heads are contiguous and a list of columns where they
    are not."""

    plan: MeshPlan
    spec: P
    heads: Optional[Tuple[Tuple[int, ...], ...]] = None
    head_dim: int = 0

    def index(self, shape: Sequence[int], d: int, t: int) -> Tuple[Union[slice, List[int]], ...]:
        out: List[Union[slice, List[int]]] = []
        for dim, axis in enumerate(tuple(self.spec) + (None,) * (len(shape) - len(self.spec))):
            size = int(shape[dim])
            if axis is None:
                out.append(slice(None))
                continue
            if axis == MODEL_AXIS and self.heads is not None:
                out.append(_head_columns(self.heads[t], self.head_dim))
                continue
            parts, at = (self.plan.tp, t) if axis == MODEL_AXIS else (self.plan.dp, d)
            if size % parts:
                raise ValueError(
                    f"axis {dim} of extent {size} does not split {parts} ways over {axis!r}"
                )
            step = size // parts
            out.append(slice(at * step, (at + 1) * step))
        return tuple(out)


def _head_columns(heads: Sequence[int], head_dim: int) -> Union[slice, List[int]]:
    """The columns of ``heads`` (each ``head_dim`` wide), in order: a slice
    where the heads are consecutive, else the column list."""
    heads = list(heads)
    if heads == list(range(heads[0], heads[0] + len(heads))):
        return slice(heads[0] * head_dim, (heads[-1] + 1) * head_dim)
    return [h * head_dim + j for h in heads for j in range(head_dim)]


def _leaf_sharding(leaf: Any, spec: P, plan: MeshPlan, heads=None, head_dim: int = 0) -> Any:
    """Sharding of one leaf (``mesh.py:151-172``).  A QTensor's ``q`` shards
    as the full-precision weight; its ``scale`` keeps the weight's rank
    with the contraction axis at extent 1, so it takes the weight's spec
    with None on every size-1 axis (wo/w_down split their input features,
    whose per-output-channel scales replicate)."""
    if isinstance(leaf, QTensor):
        return QTensor(
            q=NamedSharding(plan, spec, heads, head_dim),
            scale=NamedSharding(plan, _scale_spec(leaf, spec), heads, head_dim),
            compute_dtype=leaf.compute_dtype,
        )
    return NamedSharding(plan, spec, heads, head_dim)


def _scale_spec(leaf: QTensor, spec: P) -> P:
    """The spec of an int8 weight's scale: the weight's, with None on every
    size-1 axis."""
    axes = tuple(spec) + (None,) * (leaf.scale.ndim - len(spec))
    return P(*[None if dim == 1 else axis for axis, dim in zip(axes, leaf.scale.shape)])


#: The layer leaves whose ``model`` columns are kv heads.
KV_PROJECTIONS = ("wk", "wv")


def _projection_heads(config: Optional[ModelConfig], tp: int) -> Dict[str, Any]:
    """Per projection, the heads each tp rank's columns hold, where tp does
    not split its heads evenly: ``wq``'s query heads where tp does not
    divide ``n_heads`` (``tensor.q_heads_of_rank``), ``wk``/``wv``'s kv
    heads where it does not divide ``n_kv_heads``
    (``tensor.kv_heads_of_rank``).  A projection left out splits evenly."""
    if config is None or tp == 1:
        return {}
    from consensus_tpu_torch.parallel.tensor import kv_heads_of_rank, q_heads_of_rank

    heads: Dict[str, Any] = {}
    if config.n_heads % tp:
        heads["wq"] = tuple(q_heads_of_rank(config, tp, t) for t in range(tp))
    if config.n_kv_heads % tp:
        kv = tuple(kv_heads_of_rank(config, tp, t) for t in range(tp))
        heads.update({key: kv for key in KV_PROJECTIONS})
    return heads


def param_shardings(params: Dict[str, Any], plan: MeshPlan,
                    config: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """A :class:`NamedSharding` (or a QTensor of two) per leaf of ``params``,
    resolved through :data:`PARTITION_RULES` (``mesh.py:175-190``).  Where
    tp does not divide the model's query or kv heads, ``config`` is
    required: each rank's ``wq`` columns (and their int8 scales) are then
    copies of the query heads its column range touches
    (``tensor.q_heads_of_rank``), and its ``wk``/``wv`` columns copies of
    the kv heads those read (``tensor.kv_heads_of_rank``), where GSPMD
    splits the columns evenly and gathers across the cut heads."""
    if config is not None:
        from consensus_tpu_torch.parallel.tensor import check_tp

        check_tp(config, plan.tp)
    specs = match_partition_rules(params)
    heads = _projection_heads(config, plan.tp)
    hd = config.head_dim if config is not None else 0
    out: Dict[str, Any] = {}
    for name, value in params.items():
        if name == "layers":
            out[name] = [
                {key: _leaf_sharding(leaf, specs["layers"][i][key], plan,
                                     *((heads[key], hd) if key in heads else ()))
                 for key, leaf in layer.items()}
                for i, layer in enumerate(value)
            ]
        else:
            out[name] = _leaf_sharding(value, specs[name], plan)
    return out


def parse_mesh_spec(
    spec: Union[str, Dict[str, int], MeshPlan, None],
) -> Optional[Dict[str, int]]:
    """Normalise a mesh request to ``{"dp": N, "tp": M}`` (``mesh.py:193``).

    Accepts the CLI string form (``"dp=4,tp=2"``, either key optional), a
    dict with ``dp``/``tp`` keys, an existing :class:`MeshPlan` (its own
    sizes: callers that take a plan keep its devices), or ``None`` (no
    mesh).  Unknown keys and non-positive sizes raise."""
    if spec is None:
        return None
    if isinstance(spec, MeshPlan):
        return {"dp": spec.dp, "tp": spec.tp}
    if isinstance(spec, str):
        parsed: Dict[str, int] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, value = part.partition("=")
            if not sep:
                raise ValueError(f"bad mesh spec {spec!r}: expected 'dp=N,tp=M', got {part!r}")
            parsed[key.strip()] = int(value)
        spec = parsed
    unknown = set(spec) - {"dp", "tp"}
    if unknown:
        raise ValueError(f"bad mesh spec: unknown axis {sorted(unknown)} (want dp/tp)")
    out = {"dp": int(spec.get("dp", 1)), "tp": int(spec.get("tp", 1))}
    if out["dp"] < 1 or out["tp"] < 1:
        raise ValueError(f"bad mesh spec: sizes must be >= 1, got {out}")
    return out


def _place(tensor: torch.Tensor, sharding: NamedSharding, d: int, t: int, device) -> torch.Tensor:
    """Grid position (d, t)'s piece of ``tensor`` on ``device``: the tensor
    itself where it already lies whole there, else a contiguous copy (a
    slice never keeps the whole tensor alive)."""
    index = sharding.index(tensor.shape, d, t)
    if all(isinstance(part, slice) and part == slice(None) for part in index):
        return tensor.to(device)
    columns = [(dim, part) for dim, part in enumerate(index) if isinstance(part, list)]
    if columns:
        # Heads repeated within a rank: a gather, which copies (and which
        # autograd differentiates); a head projection splits no other axis.
        (dim, part), = columns
        picked = torch.index_select(tensor, dim, torch.tensor(part, device=tensor.device))
        return picked.to(device).contiguous()
    return tensor[index].to(device, copy=True).contiguous()


def shard_params(params: Dict[str, Any], plan: MeshPlan,
                 config: Optional[ModelConfig] = None) -> List[List[Dict[str, Any]]]:
    """One parameter tree per grid position, ``trees[d][t]`` on
    ``plan.devices[d][t]`` (``mesh.py:230``).  dp shards are replicas: a
    device that repeats in the grid gets the same tree, and a leaf already
    on its device is not copied.  tp shards hold the Megatron slices; where
    tp does not divide the query or kv heads, ``config`` places each rank's
    copies of its heads' ``wq`` / ``wk`` / ``wv`` columns
    (:func:`param_shardings`)."""
    shardings = param_shardings(params, plan, config)
    trees: List[List[Dict[str, Any]]] = []
    made: Dict[Tuple[str, int], Dict[str, Any]] = {}

    def place(leaf, sharding, d, t, device):
        if isinstance(leaf, QTensor):
            return QTensor(
                q=_place(leaf.q, sharding.q, d, t, device),
                scale=_place(leaf.scale, sharding.scale, d, t, device),
                compute_dtype=leaf.compute_dtype,
            )
        return _place(leaf, sharding, d, t, device)

    for d, row in enumerate(plan.devices):
        trees.append([])
        for t, device in enumerate(row):
            key = (str(device), t)
            if key not in made:
                tree: Dict[str, Any] = {}
                for name, value in params.items():
                    if name == "layers":
                        tree[name] = [
                            {k: place(leaf, shardings[name][i][k], d, t, device)
                             for k, leaf in layer.items()}
                            for i, layer in enumerate(value)
                        ]
                    else:
                        tree[name] = place(value, shardings[name], d, t, device)
                made[key] = tree
            trees[-1].append(made[key])
    return trees


def unshard_params(trees: Sequence[Dict[str, Any]], config: ModelConfig,
                   device: Union[str, torch.device, None] = None) -> Dict[str, Any]:
    """The whole parameter tree of one tp row's slice trees (``trees[t]``,
    rank t's, as :func:`shard_params` or a sharded ``restore_params`` gives
    them), on ``device`` (default: rank 0's): a ``model``-split leaf is its
    ranks' pieces concatenated, and a projection whose heads repeat across
    ranks takes one copy of each head."""
    specs = match_partition_rules(trees[0])
    heads_of = _projection_heads(config, len(trees))
    hd = config.head_dim

    def whole(pieces: List[torch.Tensor], spec: P, heads) -> torch.Tensor:
        target = device if device is not None else pieces[0].device
        if MODEL_AXIS not in tuple(spec):
            return pieces[0].to(target)
        dim = tuple(spec).index(MODEL_AXIS)
        if heads is None:
            return torch.cat([x.to(target) for x in pieces], dim=dim)
        first = {}
        for t, local in enumerate(heads):
            for i, head in enumerate(local):
                first.setdefault(head, (t, i))
        return torch.cat([pieces[t].narrow(dim, i * hd, hd).to(target)
                          for _, (t, i) in sorted(first.items())], dim=dim)

    def leaf(pieces: List[Any], spec: P, heads) -> Any:
        if isinstance(pieces[0], QTensor):
            return QTensor(q=whole([x.q for x in pieces], spec, heads),
                           scale=whole([x.scale for x in pieces], _scale_spec(pieces[0], spec),
                                       heads),
                           compute_dtype=pieces[0].compute_dtype)
        return whole(pieces, spec, heads)

    out: Dict[str, Any] = {}
    for name, value in trees[0].items():
        if name == "layers":
            out[name] = [
                {key: leaf([tree["layers"][i][key] for tree in trees], specs["layers"][i][key],
                           heads_of.get(key))
                 for key in layer}
                for i, layer in enumerate(value)
            ]
        else:
            out[name] = leaf([tree[name] for tree in trees], specs[name], None)
    return out


def batch_sharding(plan: MeshPlan) -> NamedSharding:
    """Sharding of (B, S) token / mask arrays: rows over ``data``, as
    ``P("data", None)`` (``mesh.py:235``)."""
    return NamedSharding(plan, P(DATA_AXIS, None))


def shard_batch(plan: MeshPlan, *arrays: torch.Tensor):
    """Split batch-leading tensors into contiguous row blocks, one per dp
    shard, each on its shard's device (``mesh.py:240-244``): a list of dp
    blocks per array."""
    sharding = batch_sharding(plan)
    placed = tuple(
        [_place(a, sharding, d, 0, device) for d, device in enumerate(plan.data_devices)]
        for a in arrays
    )
    return placed[0] if len(placed) == 1 else placed

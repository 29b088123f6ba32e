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
which are layout only here: the port's forward runs unsharded weights, so
a backend or a train step refuses ``tp > 1`` (ROADMAP.md, queue A15).

The port keeps a per-layer list, ``params["layers"]``, where the JAX package
stacks layers on a leading tensor axis.  The rules keep the JAX regexes and
specs; on a per-layer leaf the spec's leading (layer) entry is dropped.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

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
    ``index(shape, d, t)`` is the slice of the tensor that grid position
    ``(d, t)`` holds (a dim named ``model`` splits evenly over tp; ``data``
    over dp; None replicates)."""

    plan: MeshPlan
    spec: P

    def index(self, shape: Sequence[int], d: int, t: int) -> Tuple[slice, ...]:
        out = []
        for dim, axis in enumerate(tuple(self.spec) + (None,) * (len(shape) - len(self.spec))):
            size = int(shape[dim])
            if axis is None:
                out.append(slice(None))
                continue
            parts, at = (self.plan.tp, t) if axis == MODEL_AXIS else (self.plan.dp, d)
            if size % parts:
                raise ValueError(
                    f"axis {dim} of extent {size} does not split {parts} ways over {axis!r}"
                )
            step = size // parts
            out.append(slice(at * step, (at + 1) * step))
        return tuple(out)


def _leaf_sharding(leaf: Any, spec: P, plan: MeshPlan) -> Any:
    """Sharding of one leaf (``mesh.py:151-172``).  A QTensor's ``q`` shards
    as the full-precision weight; its ``scale`` keeps the weight's rank
    with the contraction axis at extent 1, so it takes the weight's spec
    with None on every size-1 axis (wo/w_down split their input features,
    whose per-output-channel scales replicate)."""
    if isinstance(leaf, QTensor):
        axes = tuple(spec) + (None,) * (leaf.scale.ndim - len(spec))
        scale_spec = P(*[None if dim == 1 else axis for axis, dim in zip(axes, leaf.scale.shape)])
        return QTensor(
            q=NamedSharding(plan, spec),
            scale=NamedSharding(plan, scale_spec),
            compute_dtype=leaf.compute_dtype,
        )
    return NamedSharding(plan, spec)


def param_shardings(params: Dict[str, Any], plan: MeshPlan) -> Dict[str, Any]:
    """A :class:`NamedSharding` (or a QTensor of two) per leaf of ``params``,
    resolved through :data:`PARTITION_RULES` (``mesh.py:175-190``)."""
    specs = match_partition_rules(params)
    out: Dict[str, Any] = {}
    for name, value in params.items():
        if name == "layers":
            out[name] = [
                {key: _leaf_sharding(leaf, specs["layers"][i][key], plan) for key, leaf in layer.items()}
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
    return tensor[sharding.index(tensor.shape, d, t)].to(device)


def shard_params(params: Dict[str, Any], plan: MeshPlan) -> List[List[Dict[str, Any]]]:
    """One parameter tree per grid position, ``trees[d][t]`` on
    ``plan.devices[d][t]`` (``mesh.py:230``).  dp shards are replicas: a
    device that repeats in the grid gets the same tree, and a leaf already
    on its device is not copied.  tp shards hold the Megatron slices."""
    shardings = param_shardings(params, plan)
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

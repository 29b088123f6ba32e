"""Model-execution backends.

``get_backend`` knows the one model backend this port has, the resident
:class:`~consensus_tpu_torch.backends.torch_backend.TorchBackend`, under two
names: ``torch``, and ``tpu``, the name the JAX package gives its resident
on-device backend (``TPUBackend``), so the repo's own configs (every one says
``backend: tpu``) run on the port unedited with the same options.  It takes a
name or a ``{"name": ..., **options}`` dict and passes Backend instances
through unchanged.  The JAX package's other backends raise
``NotImplementedError`` naming their queue item: ``fake`` (the host-only
test backend) and the HTTP backends ``api`` and ``openai`` (the API judge).
"""

from __future__ import annotations

from typing import Any

from consensus_tpu_torch.backends.base import Backend

#: Names of the resident on-device backend.
_RESIDENT = ("torch", "tpu")

#: Backends of the JAX package that wait for a later slice.
_NOT_PORTED = {
    "api": "evaluation (the API judge backend, backends/api.py)",
    "openai": "evaluation (the API judge backend, backends/api.py)",
    "fake": "A6 (the fake backend, backends/fake.py)",
}


def get_backend(name: Any = "torch", **options) -> Backend:
    if isinstance(name, dict):
        options = {**name, **options}
        name = options.pop("name", "torch")
    if not isinstance(name, str):
        return name
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {name!r} is not ported yet (ROADMAP.md, queue A: {_NOT_PORTED[name]})"
        )
    if name not in _RESIDENT:
        raise ValueError(
            f"unknown backend {name!r}: the PyTorch port has only the resident "
            f"backend, named {' or '.join(map(repr, _RESIDENT))}"
        )
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    return TorchBackend(**options)


__all__ = ["Backend", "get_backend"]

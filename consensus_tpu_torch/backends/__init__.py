"""Model-execution backends.

``get_backend`` knows the resident
:class:`~consensus_tpu_torch.backends.torch_backend.TorchBackend` under two
names: ``torch``, and ``tpu``, the name the JAX package gives its resident
on-device backend (``TPUBackend``), so the repo's own configs (every one says
``backend: tpu``) run on the port unedited with the same options.  ``fake``
is the deterministic, hardware-free
:class:`~consensus_tpu_torch.backends.fake.FakeBackend`.  It takes a name or
a ``{"name": ..., **options}`` dict and passes Backend instances through
unchanged.  The default stays ``torch``: the port's entry points run on the
card unless told otherwise (the JAX package defaults to ``fake``).  The HTTP
backends ``api`` and ``openai`` (the API judge) raise
``NotImplementedError`` naming their queue item.
"""

from __future__ import annotations

from typing import Any

from consensus_tpu_torch.backends.base import Backend

#: Names of the resident on-device backend: the backend that takes model
#: options, a device and ``pin_generation_budget``.
RESIDENT = ("torch", "tpu")

#: Backends of the JAX package that wait for a later slice.
_NOT_PORTED = {
    "api": "evaluation (the API judge backend, backends/api.py)",
    "openai": "evaluation (the API judge backend, backends/api.py)",
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
    if name == "fake":
        from consensus_tpu_torch.backends.fake import FakeBackend

        return FakeBackend(**options)
    if name not in RESIDENT:
        raise ValueError(
            f"unknown backend {name!r}: the PyTorch port has the resident backend, "
            f"named {' or '.join(map(repr, RESIDENT))}, and 'fake'"
        )
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    return TorchBackend(**options)


__all__ = ["RESIDENT", "Backend", "get_backend"]

"""Model-execution backends.

``get_backend`` knows the one model backend this port has, ``torch``
(:class:`~consensus_tpu_torch.backends.torch_backend.TorchBackend`), from a
name or a ``{"name": ..., **options}`` dict; it passes Backend instances
through unchanged.  The JAX package's HTTP backends (``api``, ``openai``:
the API judge) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

from consensus_tpu_torch.backends.base import Backend

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
    if name != "torch":
        raise ValueError(
            f"unknown backend {name!r}: the PyTorch port has only the 'torch' backend"
        )
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    return TorchBackend(**options)


__all__ = ["Backend", "get_backend"]

"""Model-execution backends.

``get_backend`` knows the one backend this port has, ``torch``
(:class:`~consensus_tpu_torch.backends.torch_backend.TorchBackend`); it
passes Backend instances through unchanged.
"""

from __future__ import annotations

from typing import Any

from consensus_tpu_torch.backends.base import Backend


def get_backend(name: Any = "torch", **options) -> Backend:
    if not isinstance(name, str):
        return name
    if name != "torch":
        raise ValueError(
            f"unknown backend {name!r}: the PyTorch port has only the 'torch' backend"
        )
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    return TorchBackend(**options)


__all__ = ["Backend", "get_backend"]

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
backends ``api`` (:class:`~consensus_tpu_torch.backends.api.APIBackend`) and
``openai`` (:class:`~consensus_tpu_torch.backends.api.OpenAIBackend`, the
API judge) build lazily: without their client package or a key every call
returns the reference's error sentinels.  Every call builds a new instance
(the port caches none), so ``fresh=True``, which fleet serving passes to
keep replicas from aliasing one backend, is accepted and changes nothing,
and ``clear_backend_cache`` has nothing to clear.

``wrap_backend`` layers the fault-tolerance stack over a resolved backend:
``supervisor(faults(backend))``.
"""

from __future__ import annotations

from typing import Any

from consensus_tpu_torch.backends.base import (  # noqa: F401
    Backend,
    BackendError,
    BackendIntegrityError,
    BackendLostError,
    PartialBatchError,
    RequestCancelled,
    TransientBackendError,
    generate_one,
    score_one,
)

#: Names of the resident on-device backend: the backend that takes model
#: options, a device and ``pin_generation_budget``.
RESIDENT = ("torch", "tpu")


def get_backend(name: Any = "torch", *, fresh: bool = False, **options) -> Backend:
    if isinstance(name, dict):
        options = {**name, **options}
        name = options.pop("name", "torch")
    if not isinstance(name, str):
        return name
    if name == "api":
        from consensus_tpu_torch.backends.api import APIBackend

        return APIBackend(**options)
    if name == "openai":
        from consensus_tpu_torch.backends.api import OpenAIBackend

        return OpenAIBackend(**options)
    if name == "fake":
        from consensus_tpu_torch.backends.fake import FakeBackend

        return FakeBackend(**options)
    if name not in RESIDENT:
        raise ValueError(
            f"unknown backend {name!r}: the PyTorch port has the resident backend, "
            f"named {' or '.join(map(repr, RESIDENT))}, 'fake', 'api' and 'openai'"
        )
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    return TorchBackend(**options)


def clear_backend_cache() -> None:
    """The JAX package's ``clear_backend_cache``: a no-op here, since
    ``get_backend`` builds a new backend on every call and caches none."""


def wrap_backend(
    backend: Backend,
    fault_plan=None,
    supervise=None,
    registry=None,
) -> Backend:
    """Layer the fault-tolerance wrappers onto a resolved backend.

    Order matters: faults are injected BELOW supervision so the supervisor
    has to handle them — ``supervisor(faults(engine))`` is the chaos-test
    stack.

    ``fault_plan``: a :class:`~consensus_tpu_torch.backends.faults.FaultPlan`,
    dict, or JSON string; ``supervise``: ``True`` for defaults or a dict of
    :class:`~consensus_tpu_torch.backends.supervisor.SupervisedBackend` kwargs.
    A fault plan without explicit ``supervise=False`` implies supervision —
    injecting faults nothing handles just breaks the run.
    """
    if fault_plan is not None:
        from consensus_tpu_torch.backends.faults import FaultInjectingBackend

        backend = FaultInjectingBackend(backend, fault_plan, registry=registry)
        if supervise is None:
            supervise = True
    if supervise:
        from consensus_tpu_torch.backends.supervisor import SupervisedBackend

        options = dict(supervise) if isinstance(supervise, dict) else {}
        backend = SupervisedBackend(backend, registry=registry, **options)
    return backend


__all__ = [
    "RESIDENT", "Backend", "clear_backend_cache", "generate_one", "get_backend", "score_one",
    "wrap_backend",
]

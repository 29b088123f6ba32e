"""The port's backend supervision (``backends/supervisor.py``: retry,
integrity guards, bisection, circuit breaker) against the JAX package's.

The reference's own cases run on the port; the parity cases drive the same
fault plans and breaker clock through both packages and require the same
outcomes: the same results (exactly: the two fake backends are bit-equal),
the same typed errors and row sets, the same breaker transitions and the
same obs series.  A retried transient fault gives the fault-free results."""

import math

import numpy as np
import pytest

from consensus_tpu.backends import FakeBackend as JaxFakeBackend
from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.backends.base import (
    BackendIntegrityError,
    BackendLostError,
    PartialBatchError,
    TransientBackendError,
)
from consensus_tpu_torch.backends.faults import FaultInjectingBackend
from consensus_tpu_torch.backends.supervisor import CircuitBreaker, SupervisedBackend
from consensus_tpu_torch.obs.metrics import Registry


def supervised(plan=None, **kwargs):
    registry = Registry()
    inner = FakeBackend()
    if plan is not None:
        inner = FaultInjectingBackend(inner, plan, registry=registry)
    kwargs.setdefault("sleep", lambda _s: None)
    return SupervisedBackend(inner, registry=registry, **kwargs), registry


class TestRetry:
    def test_transient_fault_retried_bit_identical(self):
        backend, registry = supervised(plan={"faults": [
            {"kind": "transient_error", "op": "generate", "call_index": 0}]})
        reqs = [GenerationRequest(user_prompt="p", seed=s, max_tokens=16)
                for s in range(2)]
        out = backend.generate(reqs)
        ref = FakeBackend().generate(reqs)
        assert [r.text for r in out] == [r.text for r in ref]
        assert 'supervisor_retries_total{op="generate"} 1' in \
            registry.to_prometheus()

    def test_retry_budget_exhaustion_raises_typed_error(self):
        backend, _ = supervised(
            plan={"faults": [
                {"kind": "transient_error", "op": "generate", "rate": 1.0}]},
            max_retries=2,
        )
        with pytest.raises(TransientBackendError, match="3 attempt"):
            backend.generate([GenerationRequest(user_prompt="p")])

    def test_backoff_is_exponential(self):
        delays = []
        registry = Registry()
        inner = FaultInjectingBackend(
            FakeBackend(),
            {"faults": [{"kind": "transient_error", "op": "generate",
                         "rate": 1.0}]},
            registry=registry,
        )
        backend = SupervisedBackend(
            inner, max_retries=3, backoff_s=0.01, registry=registry,
            sleep=delays.append,
        )
        with pytest.raises(TransientBackendError):
            backend.generate([GenerationRequest(user_prompt="p")])
        assert delays == [0.01, 0.02, 0.04]

    def test_empty_request_list_passthrough(self):
        backend, _ = supervised()
        assert backend.generate([]) == []


class TestIntegrityGuards:
    def test_all_rows_poisoned_raises_integrity(self):
        backend, _ = supervised(plan={"faults": [
            {"kind": "nan_logprobs", "op": "score", "call_index": 0}]})
        with pytest.raises(BackendIntegrityError, match="every row"):
            backend.score([ScoreRequest(context="c", continuation="x")])

    def test_one_poisoned_row_raises_partial_with_siblings(self):
        backend, _ = supervised(plan={"faults": [
            {"kind": "nan_logprobs", "op": "score", "call_index": 0,
             "row_index": 1}]})
        reqs = [ScoreRequest(context="c", continuation=f"row {i}")
                for i in range(3)]
        with pytest.raises(PartialBatchError) as excinfo:
            backend.score(reqs)
        err = excinfo.value
        assert set(err.row_errors) == {1}
        assert isinstance(err.row_errors[1], BackendIntegrityError)
        clean = FakeBackend().score(reqs)
        assert err.results[0].logprobs == clean[0].logprobs
        assert err.results[2].logprobs == clean[2].logprobs

    def test_poison_never_retried(self):
        backend, registry = supervised(plan={"faults": [
            {"kind": "inf_logprobs", "op": "score", "call_index": 0}]})
        with pytest.raises(BackendIntegrityError):
            backend.score([ScoreRequest(context="c", continuation="x")])
        # Family is registered but no retry series was ever incremented.
        assert "supervisor_retries_total{" not in registry.to_prometheus()

    def test_embed_guard(self):
        backend, _ = supervised(plan={"faults": [
            {"kind": "nan_logprobs", "op": "embed", "call_index": 0,
             "row_index": 0}]})
        with pytest.raises(PartialBatchError) as excinfo:
            backend.embed(["a", "b"])
        assert set(excinfo.value.row_errors) == {0}

    def test_guard_can_be_disabled(self):
        backend, _ = supervised(
            plan={"faults": [
                {"kind": "nan_logprobs", "op": "score", "call_index": 0}]},
            guard_nonfinite=False,
        )
        result = backend.score(
            [ScoreRequest(context="c", continuation="x")])[0]
        assert math.isnan(result.logprobs[0])  # caller opted out


class _RowPoisonBackend:
    """Raises deterministically (non-transient) for one specific request."""

    name = "row-poison"

    def __init__(self, bad_continuation):
        self.inner = FakeBackend()
        self.bad = bad_continuation

    def score(self, requests):
        if any(r.continuation == self.bad for r in requests):
            raise ValueError(f"poison row {self.bad!r}")
        return self.inner.score(requests)


class TestBisection:
    def test_bisection_isolates_poison_row(self):
        registry = Registry()
        backend = SupervisedBackend(
            _RowPoisonBackend("row 2"), registry=registry,
            sleep=lambda _s: None,
        )
        reqs = [ScoreRequest(context="c", continuation=f"row {i}")
                for i in range(4)]
        with pytest.raises(PartialBatchError) as excinfo:
            backend.score(reqs)
        err = excinfo.value
        assert set(err.row_errors) == {2}
        assert isinstance(err.row_errors[2], BackendIntegrityError)
        clean = FakeBackend().score(reqs)
        for i in (0, 1, 3):
            assert err.results[i].logprobs == clean[i].logprobs
        assert 'supervisor_bisections_total{op="score"} 1' in \
            registry.to_prometheus()

    def test_single_row_deterministic_failure_is_integrity_error(self):
        backend = SupervisedBackend(
            _RowPoisonBackend("only"), registry=Registry(),
            sleep=lambda _s: None,
        )
        with pytest.raises(BackendIntegrityError, match="deterministically"):
            backend.score([ScoreRequest(context="c", continuation="only")])


class TestCircuitBreaker:
    def make(self, **kwargs):
        self.now = 0.0
        kwargs.setdefault("failure_threshold", 2)
        kwargs.setdefault("cooldown_s", 10.0)
        return CircuitBreaker(
            clock=lambda: self.now, registry=Registry(), **kwargs
        )

    def test_opens_after_threshold_and_decays_to_half_open(self):
        breaker = self.make()
        breaker.record_failure()
        assert breaker.state == "closed"
        breaker.record_failure()
        assert breaker.state == "open"
        assert not breaker.allow_call()
        self.now += 10.0
        assert breaker.state == "half_open"
        assert breaker.allow_call()

    def test_half_open_admits_exactly_one_probe(self):
        breaker = self.make()
        breaker.record_failure(); breaker.record_failure()
        self.now += 10.0
        assert breaker.admission_allowed()
        assert not breaker.admission_allowed()
        assert not breaker.admission_allowed()

    def test_stale_probe_slot_recovers(self):
        breaker = self.make()
        breaker.record_failure(); breaker.record_failure()
        self.now += 10.0
        assert breaker.admission_allowed()
        # The probe request died silently; after another cooldown a new
        # probe is admitted rather than wedging the breaker forever.
        self.now += 10.0
        assert breaker.admission_allowed()

    def test_probe_success_closes(self):
        breaker = self.make()
        breaker.record_failure(); breaker.record_failure()
        self.now += 10.0
        assert breaker.admission_allowed()
        breaker.record_success()
        assert breaker.state == "closed"
        assert breaker.admission_allowed()

    def test_probe_failure_reopens_with_fresh_cooldown(self):
        breaker = self.make()
        breaker.record_failure(); breaker.record_failure()
        self.now += 10.0
        assert breaker.admission_allowed()
        breaker.record_failure()
        assert breaker.state == "open"
        self.now += 5.0
        assert breaker.state == "open"  # fresh cooldown, not the old one
        assert breaker.retry_after_s() >= 1.0

    def test_supervisor_fails_fast_when_open(self):
        registry = Registry()
        breaker = CircuitBreaker(
            failure_threshold=1, cooldown_s=100.0, registry=registry,
        )
        backend = SupervisedBackend(
            FakeBackend(), breaker=breaker, registry=registry,
            sleep=lambda _s: None,
        )
        breaker.record_failure()
        with pytest.raises(BackendLostError, match="circuit breaker open"):
            backend.generate([GenerationRequest(user_prompt="p")])

    def test_device_lost_counts_toward_breaker(self):
        backend, _ = supervised(
            plan={"faults": [
                {"kind": "device_lost", "op": "generate", "call_index": 0}]},
            failure_threshold=1, cooldown_s=100.0,
        )
        with pytest.raises(BackendLostError):
            backend.generate([GenerationRequest(user_prompt="p")])
        assert backend.circuit_breaker.state == "open"


class TestPassthrough:
    def test_properties_delegate(self):
        backend, _ = supervised()
        inner = FakeBackend()
        assert backend.token_counts.keys() == inner.token_counts.keys()
        assert backend.deterministic_greedy == bool(
            getattr(inner, "deterministic_greedy", False))

    def test_embed_returns_ndarray(self):
        backend, _ = supervised()
        vectors = backend.embed(["a", "b"])
        assert isinstance(vectors, np.ndarray) and vectors.shape[0] == 2

    def test_no_fused_session_escape_hatch(self):
        backend, _ = supervised()
        assert not hasattr(backend, "open_fused_token_search")


# ---------------------------------------------------------------------------
# Parity with the JAX package: the same plans and clock through both stacks
# ---------------------------------------------------------------------------

from consensus_tpu.backends import base as jax_base  # noqa: E402
from consensus_tpu.backends import faults as jax_faults  # noqa: E402
from consensus_tpu.backends import supervisor as jax_supervisor  # noqa: E402
from consensus_tpu.obs.metrics import Registry as JaxRegistry  # noqa: E402
import consensus_tpu_torch.backends.base as port_base  # noqa: E402
import consensus_tpu_torch.backends.faults as port_faults  # noqa: E402
import consensus_tpu_torch.backends.supervisor as port_supervisor  # noqa: E402

PACKAGES = {
    "jax": (jax_base, jax_faults, jax_supervisor, JaxRegistry, JaxFakeBackend),
    "torch": (port_base, port_faults, port_supervisor, Registry, FakeBackend),
}

SUPERVISED_PLANS = {
    "transient_then_ok": {"faults": [
        {"kind": "transient_error", "op": "generate", "call_index": 0},
        {"kind": "timeout_error", "op": "score", "call_index": 0},
    ]},
    "retry_exhausted": {"faults": [
        {"kind": "transient_error", "op": "generate", "call_index": i} for i in range(3)
    ]},
    "poison_row": {"faults": [
        {"kind": "nan_logprobs", "op": "score", "call_index": 0, "row_index": 1},
        {"kind": "inf_logprobs", "op": "next_token", "call_index": 0},
    ]},
    "device_lost": {"faults": [{"kind": "device_lost", "op": "*", "call_index": 1}]},
    "rate_mix": {"seed": 5, "faults": [
        {"kind": "transient_error", "op": "*", "rate": 0.3},
        {"kind": "nan_logprobs", "op": "score", "rate": 0.3, "row_index": 0},
    ]},
}


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _supervised_run(pkg, plan):
    base, faults, supervisor, registry_cls, fake = PACKAGES[pkg]
    registry, clock = registry_cls(), _Clock()
    inner = faults.FaultInjectingBackend(fake(), plan, registry=registry)
    backend = supervisor.SupervisedBackend(
        inner, registry=registry, max_retries=2, failure_threshold=3, cooldown_s=5.0,
        clock=clock, sleep=lambda s: setattr(clock, "now", clock.now + s),
    )
    outcomes = []
    for i in range(12):
        op = ("generate", "score", "next_token")[i % 3]
        try:
            if op == "generate":
                out = [r.text for r in backend.generate(
                    [base.GenerationRequest(user_prompt=f"p{i % 2}", seed=i % 2, max_tokens=8)])]
            elif op == "score":
                out = [r.logprobs for r in backend.score(
                    [base.ScoreRequest(context=f"c{j}", continuation=" a b") for j in range(3)])]
            else:
                out = [[c.token for c in row] for row in backend.next_token_logprobs(
                    [base.NextTokenRequest(user_prompt="n", k=2, seed=1)] * 2)]
            outcomes.append((op, "ok", repr(out)))
        except base.PartialBatchError as exc:
            outcomes.append((op, "partial", sorted(exc.row_errors),
                             sorted(type(e).__name__ for e in exc.row_errors.values()),
                             repr([r for i, r in enumerate(exc.results) if i not in exc.row_errors])))
        except Exception as exc:  # noqa: BLE001 - the error type is the outcome
            outcomes.append((op, type(exc).__name__))
        clock.now += 1.0
        outcomes.append(("breaker", backend.circuit_breaker.snapshot()["state"]))
    families = registry.snapshot()["families"]
    series = {
        name: sorted((tuple(s["labels"].values()), s["value"]) for s in family["series"])
        for name, family in families.items() if name.startswith("supervisor_")
    }
    return outcomes, series, backend.backend_lost


@pytest.mark.parametrize("plan_name", sorted(SUPERVISED_PLANS))
def test_supervisor_outcomes_match_jax(plan_name):
    plan = SUPERVISED_PLANS[plan_name]
    assert _supervised_run("torch", plan) == _supervised_run("jax", plan)


def test_retried_transient_equals_fault_free():
    faulted, _, _ = _supervised_run("torch", SUPERVISED_PLANS["transient_then_ok"])
    clean, _, _ = _supervised_run("torch", {"faults": []})
    assert faulted == clean


def test_breaker_transitions_match_jax():
    def transitions(pkg):
        supervisor, registry_cls = PACKAGES[pkg][2], PACKAGES[pkg][3]
        clock = _Clock()
        breaker = supervisor.CircuitBreaker(
            failure_threshold=2, cooldown_s=3.0, clock=clock, registry=registry_cls())
        states = []
        for step in ("fail", "fail", "tick", "admit", "admit", "tick", "tick", "tick",
                     "admit", "fail", "tick", "tick", "tick", "admit", "ok", "admit"):
            if step == "fail":
                breaker.record_failure()
            elif step == "ok":
                breaker.record_success()
            elif step == "tick":
                clock.now += 1.0
            else:
                states.append(breaker.admission_allowed())
            states.append(breaker.snapshot())
        return states

    assert transitions("torch") == transitions("jax")

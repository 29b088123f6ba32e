"""The port's deterministic fault injection (``backends/faults.py``) against
the JAX package's.

The reference's own cases run on the port's wrapper over the port's fake
backend; the parity cases run one plan through both packages' wrappers
over each package's fake backend and require the same firing (op, call
index, kind), the same outputs (the two fake backends are bit-equal) and
the same ``faults_injected_total`` series.  Exact comparisons throughout:
firing is a blake2b hash, and the fake backends are deterministic."""

import json
import math

import numpy as np
import pytest

from consensus_tpu.backends import FakeBackend as JaxFakeBackend
from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.backends.base import BackendLostError, NextTokenRequest
from consensus_tpu_torch.backends.faults import (
    FaultInjectingBackend,
    FaultPlan,
    FaultSpec,
)
from consensus_tpu_torch.obs.metrics import Registry


def make(plan, **kwargs):
    return FaultInjectingBackend(
        FakeBackend(), plan, registry=Registry(), **kwargs
    )


class TestFaultSpec:
    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultSpec(kind="nope")

    def test_unknown_op_rejected(self):
        with pytest.raises(ValueError, match="unknown op"):
            FaultSpec(kind="latency", op="frobnicate")

    def test_rate_bounds(self):
        with pytest.raises(ValueError, match="rate"):
            FaultSpec(kind="transient_error", rate=1.5)

    def test_rate_firing_is_deterministic(self):
        spec = FaultSpec(kind="transient_error", rate=0.3)
        fired = [spec.fires(7, 0, "generate", i) for i in range(64)]
        assert fired == [spec.fires(7, 0, "generate", i) for i in range(64)]
        assert any(fired) and not all(fired)
        # Different seed -> different firing pattern.
        assert fired != [spec.fires(8, 0, "generate", i) for i in range(64)]


class TestFaultPlan:
    def test_from_spec_accepts_dict_json_and_none(self):
        plan = FaultPlan.from_spec(
            {"seed": 3, "faults": [{"kind": "latency", "latency_s": 0.1}]}
        )
        assert plan.seed == 3 and plan.faults[0].kind == "latency"
        as_json = FaultPlan.from_spec(json.dumps(
            {"faults": [{"kind": "truncate", "op": "generate"}]}))
        assert as_json.faults[0].op == "generate"
        assert FaultPlan.from_spec(None) is None
        assert FaultPlan.from_spec(plan) is plan

    def test_from_spec_rejects_non_dict(self):
        with pytest.raises(ValueError, match="fault plan"):
            FaultPlan.from_spec("[1, 2]")


class TestInjection:
    def test_transient_error_at_pinned_call_index(self):
        backend = make({"faults": [
            {"kind": "transient_error", "op": "generate", "call_index": 1}]})
        req = [GenerationRequest(user_prompt="p", seed=0, max_tokens=8)]
        backend.generate(req)  # call 0: clean
        with pytest.raises(RuntimeError, match="injected transient"):
            backend.generate(req)  # call 1: faulted
        backend.generate(req)  # call 2: clean again

    def test_timeout_error_kind(self):
        backend = make({"faults": [
            {"kind": "timeout_error", "op": "score", "call_index": 0}]})
        with pytest.raises(TimeoutError):
            backend.score([ScoreRequest(context="c", continuation="x")])

    def test_truncate_halves_text_and_sets_finish_reason(self):
        clean = FakeBackend()
        backend = make({"faults": [
            {"kind": "truncate", "op": "generate", "call_index": 0}]})
        req = [GenerationRequest(user_prompt="p", seed=0, max_tokens=32)]
        ref = clean.generate(req)[0]
        res = backend.generate(req)[0]
        assert res.finish_reason == "length"
        assert res.text == ref.text[: max(1, len(ref.text) // 2)]

    def test_nan_poison_targets_one_score_row(self):
        backend = make({"faults": [
            {"kind": "nan_logprobs", "op": "score", "call_index": 0,
             "row_index": 1}]})
        reqs = [ScoreRequest(context="c", continuation=f"row {i}")
                for i in range(3)]
        results = backend.score(reqs)
        clean = FakeBackend().score(reqs)
        assert math.isnan(results[1].logprobs[0])
        assert results[0].logprobs == clean[0].logprobs
        assert results[2].logprobs == clean[2].logprobs

    def test_inf_poison_next_token(self):
        backend = make({"faults": [
            {"kind": "inf_logprobs", "op": "next_token", "call_index": 0}]})
        cands = backend.next_token_logprobs(
            [NextTokenRequest(user_prompt="p", k=3)])[0]
        assert math.isinf(cands[0].logprob)

    def test_embed_poison(self):
        backend = make({"faults": [
            {"kind": "nan_logprobs", "op": "embed", "call_index": 0,
             "row_index": 0}]})
        vectors = backend.embed(["a", "b"])
        assert np.isnan(vectors[0, 0]) and np.isfinite(vectors[1]).all()

    def test_device_lost_is_sticky(self):
        backend = make({"faults": [
            {"kind": "device_lost", "op": "generate", "call_index": 1}]})
        req = [GenerationRequest(user_prompt="p", seed=0, max_tokens=8)]
        backend.generate(req)
        with pytest.raises(BackendLostError):
            backend.generate(req)
        # Every subsequent call on every op fails: the device is gone.
        with pytest.raises(BackendLostError):
            backend.score([ScoreRequest(context="c", continuation="x")])
        with pytest.raises(BackendLostError):
            backend.embed(["a"])

    def test_latency_uses_injected_sleep(self):
        slept = []
        backend = FaultInjectingBackend(
            FakeBackend(),
            {"faults": [{"kind": "latency", "op": "generate",
                         "call_index": 0, "latency_s": 1.5}]},
            registry=Registry(),
            sleep=slept.append,
        )
        backend.generate([GenerationRequest(user_prompt="p", max_tokens=4)])
        assert slept == [1.5]

    def test_injection_counter(self):
        registry = Registry()
        backend = FaultInjectingBackend(
            FakeBackend(),
            {"faults": [{"kind": "transient_error", "op": "generate",
                         "call_index": 0}]},
            registry=registry,
        )
        with pytest.raises(RuntimeError):
            backend.generate([GenerationRequest(user_prompt="p")])
        prom = registry.to_prometheus()
        assert 'faults_injected_total{kind="transient_error",op="generate"} 1'\
            in prom

    def test_no_fused_session_escape_hatch(self):
        # Fused sessions would bypass the injection seam; the wrapper must
        # not advertise the capability.
        backend = make({"faults": []})
        assert not hasattr(backend, "open_fused_token_search")

    def test_clean_plan_is_bit_transparent(self):
        backend = make({"faults": []})
        reqs = [GenerationRequest(user_prompt="p", seed=s, max_tokens=16)
                for s in range(3)]
        assert [r.text for r in backend.generate(reqs)] == [
            r.text for r in FakeBackend().generate(reqs)]


# ---------------------------------------------------------------------------
# Parity with the JAX package: one plan, both wrappers
# ---------------------------------------------------------------------------

from consensus_tpu.backends import base as jax_base  # noqa: E402
from consensus_tpu.backends import faults as jax_faults  # noqa: E402
from consensus_tpu.obs.metrics import Registry as JaxRegistry  # noqa: E402

PARITY_PLAN = {
    "seed": 11,
    "faults": [
        {"kind": "transient_error", "op": "generate", "rate": 0.3},
        {"kind": "timeout_error", "op": "score", "call_index": 2},
        {"kind": "nan_logprobs", "op": "score", "rate": 0.25, "row_index": 1},
        {"kind": "inf_logprobs", "op": "next_token", "rate": 0.4},
        {"kind": "truncate", "op": "generate", "rate": 0.2, "row_index": 0},
        {"kind": "nan_logprobs", "op": "embed", "call_index": 1},
        # Transport-plane kinds parse and never fire on backend ops.
        {"kind": "drop", "op": "ship", "rate": 0.5},
        {"kind": "partition", "op": "*", "after_s": 100.0, "duration_s": 1.0},
    ],
}


def _drive(pkg):
    """Thirty calls cycling the four ops; returns one outcome per call
    (op, index, error type or result digest) and the injection series."""
    if pkg == "jax":
        base, faults, registry = jax_base, jax_faults, JaxRegistry()
        inner = JaxFakeBackend()
    else:
        import consensus_tpu_torch.backends.base as base
        import consensus_tpu_torch.backends.faults as faults

        registry, inner = Registry(), FakeBackend()
    backend = faults.FaultInjectingBackend(inner, PARITY_PLAN, registry=registry)
    outcomes = []
    for i in range(30):
        op = ("generate", "score", "next_token", "embed")[i % 4]
        try:
            if op == "generate":
                out = [(r.text, r.finish_reason) for r in backend.generate(
                    [base.GenerationRequest(user_prompt=f"p{i}", seed=i, max_tokens=8),
                     base.GenerationRequest(user_prompt="q", seed=1, max_tokens=8)])]
            elif op == "score":
                out = [r.logprobs for r in backend.score(
                    [base.ScoreRequest(context=f"c{i}", continuation=" a b"),
                     base.ScoreRequest(context="d", continuation=" e")])]
            elif op == "next_token":
                out = [[(c.token, c.logprob) for c in row] for row in backend.next_token_logprobs(
                    [base.NextTokenRequest(user_prompt=f"n{i}", k=3, seed=i)])]
            else:
                out = np.asarray(backend.embed([f"e{i}", "f"])).round(12).tolist()
            outcomes.append((op, i, "ok", repr(out)))
        except Exception as exc:  # noqa: BLE001 - the error type is the outcome
            outcomes.append((op, i, type(exc).__name__, str(exc)))
    families = registry.snapshot()["families"]
    series = {
        tuple(s["labels"].values()): s["value"]
        for s in families.get("faults_injected_total", {}).get("series", [])
    }
    return outcomes, series


def test_fault_plan_fires_identically_in_both_packages():
    jax_outcomes, jax_series = _drive("jax")
    port_outcomes, port_series = _drive("torch")
    assert port_outcomes == jax_outcomes
    assert port_series == jax_series
    # The plan really fired: several kinds on several ops.
    assert {kind for kind, _ in port_series} >= {
        "transient_error", "timeout_error", "nan_logprobs", "inf_logprobs"}


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
@pytest.mark.parametrize("op", ["generate", "score", "next_token", "embed"])
def test_rate_firing_matches_jax_hash(seed, op):
    spec = {"kind": "transient_error", "op": op, "rate": 0.37}
    port = FaultPlan.from_spec({"seed": seed, "faults": [spec]})
    ref = jax_faults.FaultPlan.from_spec({"seed": seed, "faults": [spec]})
    fired_port = [i for i in range(200) if port.firing(op, i)]
    fired_ref = [i for i in range(200) if ref.firing(op, i)]
    assert fired_port == fired_ref and fired_port


def test_device_lost_and_partition_windows_match_jax():
    plan = {"seed": 3, "faults": [
        {"kind": "device_lost", "op": "score", "call_index": 1},
        {"kind": "partition", "op": "*", "peer": "r1", "after_s": 0.5, "duration_s": 2.0},
    ]}
    assert FaultPlan.from_spec(plan).partition_windows() == \
        jax_faults.FaultPlan.from_spec(plan).partition_windows() == [("r1", 0.5, 2.5)]
    assert FaultPlan.replica_lost(call_index=3) == FaultPlan(
        seed=0, faults=(FaultSpec(kind="device_lost", call_index=3),))

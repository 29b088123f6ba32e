"""The port's brownout controller (``serve/brownout.py``) and the anytime
seam it drives (the reference's ``tests/test_brownout.py`` on the port,
without the load generator's acceptance run, which waits for the fleet's
port), plus parity: the same pressure sequence gives the same tiers and
snapshots in both packages, and a degraded response is tagged as the JAX
server tags it."""

import json
import urllib.request

import pytest

from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.methods import get_method_generator
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.serve import RequestScheduler, create_server, parse_request
from consensus_tpu_torch.serve.brownout import BrownoutController
from tests.test_torch_serve import OPINIONS  # shared scenario text
from tests.test_torch_serve import TOPIC, SlowCountingBackend, _post


def _request(seed=7, **overrides):
    payload = {
        "issue": TOPIC,
        "agent_opinions": OPINIONS,
        "method": "best_of_n",
        "params": {"n": 4, "max_tokens": 24},
        "seed": seed,
        "evaluate": False,
    }
    payload.update(overrides)
    return parse_request(payload)


# ---------------------------------------------------------------------------
# controller units (fake clock: hysteresis is about time, so own the time)
# ---------------------------------------------------------------------------


class FakeNow:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _controller(now=None, **kwargs):
    kwargs.setdefault("registry", Registry())
    if now is not None:
        kwargs["now"] = now
    return BrownoutController(**kwargs)


class TestControllerTiers:
    def test_starts_at_tier_zero(self):
        controller = _controller()
        assert controller.tier == 0
        assert controller.scale == 1.0

    def test_escalation_is_immediate_and_multi_tier(self):
        controller = _controller(now=FakeNow())
        # Queue 120% full: straight to the top tier in ONE event.
        assert controller.update(12, 10, 0, 4) == 3
        assert controller.scale == 0.25

    def test_deescalation_needs_dwell_and_exit_threshold(self):
        now = FakeNow()
        controller = _controller(now=now, min_dwell_s=2.0)
        controller.update(7, 10, 0, 4)  # 0.70 -> tier 1
        assert controller.tier == 1
        # Below exit (0.40) but inside the dwell: stays.
        assert controller.update(1, 10, 0, 4) == 1
        now.t += 2.5
        assert controller.update(1, 10, 0, 4) == 0

    def test_hysteresis_band_holds_the_tier(self):
        now = FakeNow()
        controller = _controller(now=now, min_dwell_s=2.0)
        controller.update(7, 10, 0, 4)  # tier 1
        now.t += 10.0
        # 0.50 sits between exit (0.40) and enter (0.65): no flapping in
        # either direction, ever.
        for _ in range(5):
            assert controller.update(5, 10, 0, 4) == 1

    def test_deescalation_is_single_step(self):
        now = FakeNow()
        controller = _controller(now=now, min_dwell_s=1.0)
        controller.update(12, 10, 0, 4)  # tier 3
        now.t += 5.0
        assert controller.update(0, 10, 0, 4) == 2  # one step only
        # Each drop re-arms the dwell.
        assert controller.update(0, 10, 0, 4) == 2
        now.t += 5.0
        assert controller.update(0, 10, 0, 4) == 1

    def test_saturated_workers_alone_stay_tier_zero(self):
        controller = _controller()
        # All workers busy, empty queue: 0.6 * 1.0 < 0.65 — busy is not
        # overloaded.
        assert controller.update(0, 64, 4, 4) == 0

    def test_breaker_states_pressurize(self):
        controller = _controller(now=FakeNow())
        assert controller.update(0, 10, 0, 4, breaker_state="half_open") == 2
        assert controller.update(0, 10, 0, 4, breaker_state="open") == 3

    def test_latency_slo_term(self):
        controller = _controller(now=FakeNow(), target_p95_s=1.0)
        controller.record_latency(2.0)  # first sample seeds the estimate
        # p95/target = 2.0 >= 1.1: top tier with an empty queue.
        assert controller.update(0, 64, 0, 4) == 3

    def test_tail_biased_ewma(self):
        controller = _controller(ewma_alpha=0.3, quantile=0.95)
        controller.record_latency(1.0)
        for _ in range(20):
            controller.record_latency(0.1)  # below-estimate samples
        estimate = controller.snapshot()["p95_ewma_s"]
        # alpha_down = 0.3 * 0.05/0.95 — the estimate decays ~19x slower
        # than plain EWMA, staying near the tail.
        assert estimate > 0.6

    def test_threshold_validation(self):
        with pytest.raises(ValueError, match="strictly below"):
            _controller(enter_thresholds=(0.5, 0.8, 1.0),
                        exit_thresholds=(0.5, 0.6, 0.8))

    def test_snapshot_and_dispatch_counts(self):
        controller = _controller(now=FakeNow())
        controller.note_dispatch()
        controller.update(12, 10, 0, 4)
        controller.note_dispatch()
        snapshot = controller.snapshot()
        assert snapshot["tier"] == 3
        assert snapshot["budget_scale"] == 0.25
        assert snapshot["tier_scales"] == [1.0, 0.7, 0.45, 0.25]
        assert snapshot["tier_request_counts"] == {
            "0": 1, "1": 0, "2": 0, "3": 1}


# ---------------------------------------------------------------------------
# scheduler plumbing: per-ticket BudgetClocks
# ---------------------------------------------------------------------------


class TestSchedulerClockPlumbing:
    def _run_one(self, handler, *, brownout=None, pre_pressure=None,
                 **kwargs):
        kwargs.setdefault("max_queue_depth", 8)
        kwargs.setdefault("max_inflight", 1)
        kwargs.setdefault("default_timeout_s", 30.0)
        scheduler = RequestScheduler(
            handler, FakeBackend(), registry=Registry(), brownout=brownout,
            **kwargs,
        )
        if pre_pressure is not None:
            brownout.update(*pre_pressure)
        scheduler.start()
        try:
            ticket = scheduler.submit(_request())
            assert ticket.wait(timeout=10.0)
            return ticket
        finally:
            scheduler.shutdown(drain=True, timeout=10.0)

    def test_clock_aware_handler_gets_deadline_clock(self):
        seen = {}

        def handler(request, backend, budget_clock=None):
            seen["clock"] = budget_clock
            return {"statement": "s"}

        ticket = self._run_one(handler)
        assert ticket.outcome == "ok"
        clock = seen["clock"]
        assert clock is not None
        remaining = clock.remaining()
        # Ticket deadline (30s) minus the anytime margin.
        assert remaining is not None and 25.0 < remaining <= 29.8

    def test_brownout_scale_stamped_on_clock(self):
        seen = {}

        def handler(request, backend, budget_clock=None):
            seen["clock"] = budget_clock
            return {"statement": "s"}

        controller = _controller(min_dwell_s=60.0)  # hold the tier
        ticket = self._run_one(
            handler, brownout=controller, pre_pressure=(9, 10, 0, 1))
        assert ticket.outcome == "ok"
        clock = seen["clock"]
        assert clock.tier == 2
        assert clock.scale == 0.45
        counts = controller.snapshot()["tier_request_counts"]
        assert counts["2"] == 1

    def test_unbounded_unscaled_handler_gets_none(self):
        seen = {"called": False}

        def handler(request, backend, budget_clock=None):
            seen["called"] = True
            seen["clock"] = budget_clock
            return {"statement": "s"}

        ticket = self._run_one(handler, default_timeout_s=None)
        assert ticket.outcome == "ok"
        assert seen["called"] and seen["clock"] is None

    def test_legacy_handler_untouched(self):
        def handler(request, backend):
            return {"statement": "legacy"}

        controller = _controller(min_dwell_s=60.0)
        ticket = self._run_one(
            handler, brownout=controller, pre_pressure=(12, 10, 0, 1))
        assert ticket.outcome == "ok"
        assert ticket.result()["statement"] == "legacy"

    def test_degraded_value_outcome_and_counter(self):
        registry = Registry()

        def handler(request, backend, budget_clock=None):
            return {"statement": "partial", "degraded": True,
                    "degraded_reason": "deadline"}

        scheduler = RequestScheduler(
            handler, FakeBackend(), registry=registry,
            max_queue_depth=8, max_inflight=1, default_timeout_s=30.0,
        )
        scheduler.start()
        try:
            ticket = scheduler.submit(_request())
            assert ticket.wait(timeout=10.0)
            assert ticket.outcome == "degraded"
            assert ticket.result()["degraded"] is True
        finally:
            scheduler.shutdown(drain=True, timeout=10.0)
        family = registry.snapshot()["families"]["serve_degraded_total"]
        assert sum(s["value"] for s in family["series"]) == 1


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------


class TestHTTPDegradedPath:
    def test_deadline_with_completed_wave_returns_degraded_200(self):
        """beam_search at ~0.3 s/step against a 1.2 s deadline: several
        steps complete, then the clock expires — the client gets 200 with
        the best-so-far statement, not a 504."""
        instance = create_server(
            backend=SlowCountingBackend(delay_s=0.15), port=0,
            max_inflight=1, registry=Registry(),
        ).start()
        try:
            status, body = _post(instance.base_url, {
                "issue": TOPIC, "agent_opinions": OPINIONS,
                "method": "beam_search",
                "params": {"beam_width": 2, "max_tokens": 20},
                "seed": 3, "evaluate": False, "timeout_s": 1.2,
            }, timeout=30.0)
            assert status == 200
            assert body["degraded"] is True
            assert body["degraded_reason"] in ("deadline", "cancelled")
            assert body["statement"]
            spent = body["budget_spent"]
            assert spent["steps_done"] < spent["steps_planned"]
        finally:
            instance.stop()

    def test_healthz_exposes_brownout_snapshot(self):
        instance = create_server(
            backend="fake", port=0, brownout=True, target_p95_ms=500.0,
            registry=Registry(),
        ).start()
        try:
            with urllib.request.urlopen(
                instance.base_url + "/healthz", timeout=5.0
            ) as response:
                health = json.loads(response.read().decode())
            brownout = health["brownout"]
            assert brownout["tier"] == 0
            assert brownout["budget_scale"] == 1.0
            assert brownout["tier_scales"] == [1.0, 0.7, 0.45, 0.25]
            assert brownout["target_p95_s"] == 0.5
            assert "tier_request_counts" in brownout
        finally:
            instance.stop()

    def test_healthz_has_no_brownout_key_when_disabled(self):
        instance = create_server(
            backend="fake", port=0, registry=Registry()).start()
        try:
            with urllib.request.urlopen(
                instance.base_url + "/healthz", timeout=5.0
            ) as response:
                health = json.loads(response.read().decode())
            assert "brownout" not in health
        finally:
            instance.stop()


# ---------------------------------------------------------------------------
# acceptance proof: overload with brownout ON; identity with it OFF
# ---------------------------------------------------------------------------




# ---------------------------------------------------------------------------
# Parity with the JAX package's controller
# ---------------------------------------------------------------------------

from consensus_tpu.obs.metrics import Registry as JaxRegistry  # noqa: E402
from consensus_tpu.serve.brownout import BrownoutController as JaxBrownoutController  # noqa: E402


def test_controller_tiers_match_jax():
    def drive(cls, registry):
        now = FakeNow()
        controller = cls(now=now, registry=registry, target_p95_s=0.5)
        trace = []
        for i in range(40):
            now.t += 0.7
            controller.record_latency(0.1 * (i % 9))
            controller.update(queue_depth=(i * 7) % 13, inflight=i % 5, max_queue_depth=12,
                              max_inflight=4, breaker_state=("closed", "half_open", "open")[i % 3 if i > 30 else 0])
            trace.append((controller.tier, controller.scale, controller.snapshot()))
        return trace

    assert drive(BrownoutController, Registry()) == drive(JaxBrownoutController, JaxRegistry())

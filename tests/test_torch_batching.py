"""The port's BatchingBackend (its flush-snapshot path), with the cases of
``tests/test_batching.py`` run over the port's fake backend: one merged
batch, merged equal to solo, mixed kinds, embed slicing, errors, metrics
and flush reasons, single-file flushes, aborted flushes, per-kind
wakeups; score dedup and the device turns of fused sessions; then the port's concurrent ``Experiment`` over
``TorchBackend(device="cpu")`` in float32 against the JAX package's
concurrent ``Experiment`` over ``TPUBackend`` on the same weights, and
against the port's own sequential run.
"""

import threading

import numpy as np
import pytest
import torch

from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
from consensus_tpu_torch.backends.batching import BatchingBackend
from consensus_tpu_torch.backends.fake import FakeBackend


class CountingBackend:
    """FakeBackend wrapper counting device-batch invocations."""

    name = "counting"

    def __init__(self):
        self.inner = FakeBackend()
        self.batches = {"generate": 0, "score": 0, "next_token": 0,
                        "embed": 0, "score_matrix": 0}

    def generate(self, requests):
        self.batches["generate"] += 1
        return self.inner.generate(requests)

    def score(self, requests):
        self.batches["score"] += 1
        return self.inner.score(requests)

    def next_token_logprobs(self, requests):
        self.batches["next_token"] += 1
        return self.inner.next_token_logprobs(requests)

    def embed(self, texts):
        self.batches["embed"] += 1
        return self.inner.embed(texts)

    def score_matrix(self, requests):
        self.batches["score_matrix"] += 1
        from consensus_tpu_torch.backends.score_matrix import fallback_score_matrix_many

        return fallback_score_matrix_many(self.inner, requests)


class TestBatchingBackend:
    def test_concurrent_sessions_share_one_batch(self):
        counting = CountingBackend()
        batching = BatchingBackend(counting, engine=False, flush_ms=50.0)
        results = {}
        barrier = threading.Barrier(3)

        def worker(tag):
            with batching.session():
                barrier.wait()
                results[tag] = batching.generate(
                    [GenerationRequest(user_prompt=f"p{tag}", max_tokens=4, seed=tag)]
                )[0]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert counting.batches["generate"] == 1  # 3 sessions, ONE device batch
        assert len(results) == 3

    def test_batched_results_match_solo(self):
        counting = CountingBackend()
        batching = BatchingBackend(counting, engine=False, flush_ms=20.0)
        requests = [
            GenerationRequest(user_prompt=f"prompt {i}", max_tokens=6, seed=i)
            for i in range(3)
        ]
        solo = FakeBackend().generate(requests)
        results = [None] * 3
        barrier = threading.Barrier(3)

        def worker(i):
            with batching.session():
                barrier.wait()
                results[i] = batching.generate([requests[i]])[0]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for got, expected in zip(results, solo):
            assert got.text == expected.text

    def test_mixed_kinds_flush_independently(self):
        counting = CountingBackend()
        batching = BatchingBackend(counting, engine=False, flush_ms=20.0)
        out = {}
        barrier = threading.Barrier(2)

        def gen_worker():
            with batching.session():
                barrier.wait()
                out["gen"] = batching.generate(
                    [GenerationRequest(user_prompt="a", max_tokens=4, seed=1)]
                )

        def score_worker():
            with batching.session():
                barrier.wait()
                out["score"] = batching.score(
                    [ScoreRequest(context="ctx", continuation=" more")]
                )

        threads = [
            threading.Thread(target=gen_worker),
            threading.Thread(target=score_worker),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert out["gen"][0].text is not None
        assert out["score"][0].ok

    def test_embed_slicing(self):
        counting = CountingBackend()
        batching = BatchingBackend(counting, engine=False, flush_ms=20.0)
        out = {}
        barrier = threading.Barrier(2)

        def worker(tag, texts):
            with batching.session():
                barrier.wait()
                out[tag] = batching.embed(texts)

        threads = [
            threading.Thread(target=worker, args=("a", ["one", "two"])),
            threading.Thread(target=worker, args=("b", ["three"])),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert out["a"].shape[0] == 2
        assert out["b"].shape[0] == 1
        assert counting.batches["embed"] == 1
        solo = FakeBackend().embed(["one", "two"])
        np.testing.assert_allclose(out["a"], solo, atol=1e-6)

    def test_error_propagates_to_all_waiters(self):
        class Exploding(CountingBackend):
            def generate(self, requests):
                raise RuntimeError("device on fire")

        batching = BatchingBackend(Exploding(), engine=False, flush_ms=20.0)
        errors = []
        barrier = threading.Barrier(2)

        def worker():
            with batching.session():
                barrier.wait()
                try:
                    batching.generate(
                        [GenerationRequest(user_prompt="x", max_tokens=2)]
                    )
                except RuntimeError as exc:
                    errors.append(str(exc))

        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errors == ["device on fire", "device on fire"]


class TestBatchingMetrics:
    def test_queue_wait_and_batch_fill_recorded_under_concurrency(self):
        """Concurrent sessions leave an observability trail: queue-wait
        samples per merged request, batch-fill = sessions per flush, a
        flush-reason counter, and merged-request totals — recorded into
        the injected registry, not the process-global one."""
        from consensus_tpu_torch.obs import Registry

        registry = Registry()
        counting = CountingBackend()
        batching = BatchingBackend(
            counting, engine=False, flush_ms=50.0, expected_sessions=3, registry=registry)
        barrier = threading.Barrier(3)

        def worker(tag):
            with batching.session():
                barrier.wait()
                batching.generate(
                    [GenerationRequest(user_prompt=f"p{tag}", max_tokens=4, seed=tag)]
                )

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert counting.batches["generate"] == 1

        families = registry.snapshot()["families"]

        def series(name, **labels):
            for entry in families[name]["series"]:
                if all(entry["labels"].get(k) == v for k, v in labels.items()):
                    return entry
            raise AssertionError(f"no {name} series with {labels}: {families[name]}")

        wait = series("batching_queue_wait_seconds", kind="generate")
        assert wait["count"] == 3  # one sample per merged session call
        assert wait["sum"] >= 0.0 and wait["max"] < 30.0

        fill = series("batching_batch_fill_sessions", kind="generate")
        assert fill["count"] == 1  # one flush
        assert fill["min"] == fill["max"] == 3.0  # all 3 sessions merged

        merged = series("batching_merged_requests_total", kind="generate")
        assert merged["value"] == 3.0

        reasons = {
            s["labels"]["reason"]: s["value"]
            for s in families["batching_flushes_total"]["series"]
            if s["labels"]["kind"] == "generate"
        }
        assert sum(reasons.values()) == 1.0
        assert set(reasons) <= {"all_blocked", "timeout"}

    def test_timeout_flush_reason_recorded(self):
        """A lone session (below expected_sessions) can only flush via the
        quiescence timeout — the reason label must say so."""
        from consensus_tpu_torch.obs import Registry

        registry = Registry()
        batching = BatchingBackend(
            CountingBackend(), engine=False, flush_ms=5.0, expected_sessions=4,
            registry=registry)
        with batching.session():
            batching.score([ScoreRequest(context="ctx", continuation=" more")])
        families = registry.snapshot()["families"]
        reasons = {
            (s["labels"]["kind"], s["labels"]["reason"]): s["value"]
            for s in families["batching_flushes_total"]["series"]
        }
        assert reasons == {("score", "timeout"): 1.0}


class TestExperimentConcurrency:
    CONFIG = {
        "experiment_name": "batch_test",
        "seed": 7,
        "num_seeds": 3,
        "scenario": {
            "issue": "Should X happen?",
            "agent_opinions": {"A": "Yes.", "B": "No."},
        },
        "methods_to_run": ["best_of_n"],
        "best_of_n": {"n": 2, "max_tokens": 6},
    }

    def _run(self, tmp_path, concurrent):
        from consensus_tpu_torch.experiment import Experiment

        config = dict(self.CONFIG)
        config["concurrent_execution"] = concurrent
        config["output_dir"] = str(tmp_path / ("conc" if concurrent else "seq"))
        backend = CountingBackend()
        experiment = Experiment(config, backend=backend)
        frame = experiment.run()
        return frame, backend, experiment

    def test_results_identical_and_batches_fewer(self, tmp_path):
        seq_frame, seq_backend, _ = self._run(tmp_path, concurrent=False)
        conc_frame, conc_backend, experiment = self._run(tmp_path, concurrent=True)

        # Bit-identical statements per (seed): concurrency never changes results.
        seq = seq_frame.sort_values("seed")["statement"].tolist()
        conc = conc_frame.sort_values("seed")["statement"].tolist()
        assert seq == conc
        assert (conc_frame["error_message"] == "").all()

        # The measurable speedup proxy: fewer device batches than sequential.
        seq_total = sum(seq_backend.batches.values())
        conc_total = sum(conc_backend.batches.values())
        assert conc_total < seq_total
        assert experiment.last_batch_counts == conc_backend.batches


@pytest.mark.parametrize("flush_ms", [None, 37.5])
def test_batch_flush_ms_reaches_the_batching_backend(tmp_path, monkeypatch, flush_ms):
    """The config's ``batch_flush_ms`` sets the co-batching window, as in
    the JAX package's ``Experiment`` (10 ms when unset)."""
    from consensus_tpu.backends import batching as jax_batching
    from consensus_tpu.backends.fake import FakeBackend as JaxFakeBackend
    from consensus_tpu.experiment import Experiment as JaxExperiment
    from consensus_tpu_torch.backends import batching
    from consensus_tpu_torch.experiment import Experiment

    seen = {}

    def recording(module, label):
        original = module.BatchingBackend.__init__

        def init(self, *args, **kwargs):
            original(self, *args, **kwargs)
            seen[label] = self.flush_s

        monkeypatch.setattr(module.BatchingBackend, "__init__", init)

    recording(batching, "port")
    recording(jax_batching, "jax")
    config = dict(TestExperimentConcurrency.CONFIG)
    if flush_ms is not None:
        config["batch_flush_ms"] = flush_ms
    Experiment(dict(config, output_dir=str(tmp_path / "port")), backend=FakeBackend()).run()
    JaxExperiment(dict(config, output_dir=str(tmp_path / "jax")), backend=JaxFakeBackend()).run()
    assert seen["port"] == seen["jax"] == (flush_ms if flush_ms is not None else 10.0) / 1000.0


class TestFlushSingleFile:
    def test_no_concurrent_inner_calls_and_arrivals_merge(self):
        """The flush runs with the lock RELEASED so arrivals can enqueue
        during a device call — but inner-backend dispatches must stay
        single-file, and requests arriving mid-flush must merge into the
        NEXT batch rather than fragmenting into solo dispatches.

        Follower arrival is gated on an event set inside the inner
        ``generate`` (and the first dispatch holds until all followers have
        enqueued), so arrival-mid-flush is guaranteed rather than raced
        against a fixed sleep."""
        import time

        class SlowInner:
            name = "slow"

            def __init__(self):
                self.inner = FakeBackend()
                self.calls = []          # row counts per dispatch
                self._in_call = False
                self.overlapped = False
                self.batching = None      # wired up after wrapper construction
                self.first_dispatch = threading.Event()

            def generate(self, requests):
                if self._in_call:
                    self.overlapped = True
                self._in_call = True
                try:
                    if not self.first_dispatch.is_set():
                        self.first_dispatch.set()
                        # Hold the first "device call" open until every
                        # follower has enqueued — guaranteed mid-flush
                        # arrival, bounded so a broken follower can't hang.
                        deadline = time.monotonic() + 10.0
                        while time.monotonic() < deadline:
                            with self.batching._lock:
                                if len(self.batching._queues["generate"]) >= 5:
                                    break
                            time.sleep(0.005)
                    time.sleep(0.01)      # device-call stand-in
                    return self.inner.generate(requests)
                finally:
                    self.calls.append(len(requests))
                    self._in_call = False

            def score(self, requests):
                return self.inner.score(requests)

            def next_token_logprobs(self, requests):
                return self.inner.next_token_logprobs(requests)

            def embed(self, texts):
                return self.inner.embed(texts)

        inner = SlowInner()
        batching = BatchingBackend(inner, engine=False, flush_ms=5.0, expected_sessions=6)
        inner.batching = batching
        done = []

        def leader():
            with batching.session():
                done.append(
                    batching.generate(
                        [GenerationRequest(user_prompt="lead", max_tokens=4, seed=0)]
                    )
                )

        def follower(i):
            with batching.session():
                # Enqueue only once the leader's dispatch has started; the
                # inner call then waits for all 5 of us before returning.
                assert inner.first_dispatch.wait(timeout=10.0)
                done.append(
                    batching.generate(
                        [GenerationRequest(user_prompt=f"f{i}", max_tokens=4, seed=i)]
                    )
                )

        threads = [threading.Thread(target=leader)] + [
            threading.Thread(target=follower, args=(i,)) for i in range(5)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not inner.overlapped, "two flushes ran concurrently"
        assert len(done) == 6
        # The 5 followers all arrived during the leader's device call (the
        # inner generate held until their entries were queued) and must ride
        # ONE follow-up batch — 3 dispatches would mean the timeout path
        # re-fragmented a mid-flush arrival.
        assert len(inner.calls) <= 2
        assert sum(inner.calls) == 6


class TestAbortedFlushFailsWaiters:
    def test_base_exception_mid_flush_errors_stranded_entries(self):
        """A non-Exception abort between per-kind dispatches (e.g.
        KeyboardInterrupt) must not strand waiters whose kind never ran:
        their snapshot entries are off the queues, so _flush's finally has
        to error them or the waiter threads block forever."""

        class AbortingInner:
            name = "aborting"

            def __init__(self):
                self.inner = FakeBackend()

            def generate(self, requests):
                # Abort mid-flush with a BaseException: "score" entries in
                # the same snapshot never get dispatched.
                raise KeyboardInterrupt

            def score(self, requests):
                return self.inner.score(requests)

            def next_token_logprobs(self, requests):
                return self.inner.next_token_logprobs(requests)

            def embed(self, texts):
                return self.inner.embed(texts)

        # Huge window: the scorer must NOT timeout-flush its entry solo —
        # only the all-blocked path (triggered by the generate below) may
        # flush, so both kinds land in one snapshot.
        batching = BatchingBackend(
            AbortingInner(), engine=False, flush_ms=30_000.0, expected_sessions=2)
        score_outcome = {}

        def scorer():
            with batching.session():
                try:
                    batching.score(
                        [ScoreRequest(context="ctx", continuation=" more")]
                    )
                    score_outcome["result"] = "ok"
                except RuntimeError as exc:
                    score_outcome["result"] = str(exc)

        scorer_thread = threading.Thread(target=scorer)
        with batching.session():
            scorer_thread.start()
            # Wait for the scorer's entry to be queued so the all-blocked
            # flush snapshots BOTH kinds, then trigger it via generate.
            import time

            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                with batching._lock:
                    if batching._queues["score"]:
                        break
                time.sleep(0.005)
            with pytest.raises(KeyboardInterrupt):
                batching.generate(
                    [GenerationRequest(user_prompt="g", max_tokens=4, seed=0)]
                )
        scorer_thread.join(timeout=10.0)
        assert not scorer_thread.is_alive(), "score waiter was stranded"
        assert "aborted" in score_outcome.get("result", "")


class TestPerKindWakeups:
    def test_no_spurious_wakeups_across_kinds(self):
        """An all-blocked flush dispatches every kind's batch in sequence;
        a waiter parked for the score batch must sleep through the generate
        batch's completion (wakeups are routed per kind, not broadcast).
        Pinned two ways: the spurious-wakeup counter stays 0, and the
        queue-wait histogram shows each kind's entry dispatched exactly
        once."""
        import time

        from consensus_tpu_torch.obs import Registry

        class SlowGenerate(CountingBackend):
            # Slow enough that the score waiter is reliably parked in its
            # untimed mid-flush wait while generate completes.
            def generate(self, requests):
                time.sleep(0.05)
                return super().generate(requests)

        registry = Registry()
        inner = SlowGenerate()
        batching = BatchingBackend(
            inner, engine=False, flush_ms=500.0, expected_sessions=2, registry=registry)
        out = {}

        def gen_worker():
            with batching.session():
                out["gen"] = batching.generate(
                    [GenerationRequest(user_prompt="a", max_tokens=4, seed=1)]
                )

        def score_worker():
            with batching.session():
                out["score"] = batching.score(
                    [ScoreRequest(context="ctx", continuation=" more")]
                )

        threads = [
            threading.Thread(target=gen_worker),
            threading.Thread(target=score_worker),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert out["gen"][0].text is not None
        assert out["score"][0].ok
        # Both kinds rode ONE all-blocked flush (flush_ms is far above the
        # test's runtime, so a timeout flush would fail the join above).
        assert inner.batches["generate"] == 1
        assert inner.batches["score"] == 1

        families = registry.snapshot()["families"]

        def series(name):
            return {
                tuple(s["labels"].values()): s
                for s in families[name]["series"]
            }

        spurious = series("batching_spurious_wakeups_total")
        assert sum(s["value"] for s in spurious.values()) == 0, spurious
        waits = series("batching_queue_wait_seconds")
        assert waits[("generate",)]["count"] == 1
        assert waits[("score",)]["count"] == 1


class TestPortSpecifics:
    def test_engine_raises_naming_its_queue_item(self):
        """``mesh`` passes through into the engine options, as in the JAX
        batching layer: a dp=2 engine partitions its pools and serves; so
        does a tensor-parallel backend, whose engine records tp=2."""
        batching = BatchingBackend(CountingBackend(), engine=True, mesh={"dp": 2, "tp": 1})
        try:
            assert batching.engine.mesh_dp == 2 and len(batching.engine.pools) == 2
            out = batching.generate([GenerationRequest(user_prompt="x", max_tokens=3)])
            assert len(out) == 1
        finally:
            batching.close()
        from consensus_tpu_torch.backends.torch_backend import TorchBackend

        batching = BatchingBackend(
            TorchBackend(model="tiny-llama3", device="cpu", mesh="dp=1,tp=2"), engine=True
        )
        try:
            assert batching.engine.mesh_tp == 2 and batching.engine.mesh_dp == 1
            out = batching.generate([GenerationRequest(user_prompt="x", max_tokens=3, seed=1)])
            assert len(out) == 1 and len(out[0].token_ids) <= 3
        finally:
            batching.close()

    def test_duplicate_score_rows_computed_once(self):
        """Identical score rows of two sessions merged into one flush are
        dispatched once and fanned back out to both."""
        from consensus_tpu_torch.obs import Registry

        registry = Registry()
        inner = CountingBackend()
        seen = []
        score = inner.score

        def recording(requests):
            seen.append(list(requests))
            return score(requests)

        inner.score = recording
        batching = BatchingBackend(inner, engine=False, flush_ms=500.0, expected_sessions=2,
                                   registry=registry)
        shared = ScoreRequest(context="c", continuation=" ok")
        requests = {"a": [shared, ScoreRequest(context="c", continuation=" fine")],
                    "b": [shared, ScoreRequest(context="c", continuation=" else")]}
        out = {}
        barrier = threading.Barrier(2)

        def worker(tag):
            with batching.session():
                barrier.wait()
                out[tag] = batching.score(requests[tag])

        threads = [threading.Thread(target=worker, args=(t,)) for t in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert inner.batches["score"] == 1 and len(seen[0]) == 3
        for tag, rows in requests.items():
            solo = FakeBackend().score(rows)
            assert [r.logprobs for r in out[tag]] == [r.logprobs for r in solo]
        families = registry.snapshot()["families"]
        assert families["engine_score_dedup_total"]["series"][0]["value"] == 1


class _Overlap:
    """Records whether two device-driving calls ever ran at once."""

    def __init__(self):
        self._lock = threading.Lock()
        self.inside = 0
        self.overlapped = False
        self.calls = 0

    def __call__(self, fn, *args):
        import time

        with self._lock:
            self.inside += 1
            self.calls += 1
            self.overlapped |= self.inside > 1
        try:
            time.sleep(0.002)  # a device call's stand-in: invites a switch
            return fn(*args)
        finally:
            with self._lock:
                self.inside -= 1


class SessionInner(CountingBackend):
    """A fake inner backend with fused sessions whose steps pass through one
    overlap recorder.  ``budget`` (optional) is a semaphore that opening a
    session and every generate call hold, as a device-memory budget would:
    a session holds it until it closes."""

    def __init__(self, budget=None):
        super().__init__()
        self.overlap = _Overlap()
        self.opened_while = []
        self.budget = budget

    def generate(self, requests):
        if self.budget is None:
            return super().generate(requests)
        with self.budget:
            return super().generate(requests)

    def open_fused_token_search(self, spec):
        from consensus_tpu_torch.backends.session import FusedSessionUnavailable

        if spec == "declined":
            raise FusedSessionUnavailable("over budget")
        self.opened_while.append(self.batching._device.held())
        if self.budget is not None:
            self.budget.acquire()
        inner = self

        class Session:
            steps = 0

            def advance_and_propose(self, parents, chosen):
                def step():
                    self.steps += 1
                    return [[]]
                return inner.overlap(step)

            def close(self):
                if inner.budget is not None:
                    inner.budget.release()

        return Session()


class TestFusedSessionTurns:
    def test_sessions_never_drive_the_device_at_once(self):
        inner = SessionInner()
        batching = BatchingBackend(inner, engine=False, flush_ms=5.0, expected_sessions=5)
        inner.batching = batching
        sessions = []

        def stepper():
            with batching.session():
                session = batching.open_fused_token_search("spec")
                sessions.append(session)
                for _ in range(20):
                    session.advance_and_propose([0], [None])

        def generator(i):
            with batching.session():
                for j in range(5):
                    batching.generate([GenerationRequest(
                        user_prompt=f"g{i}", max_tokens=4, seed=10 * i + j)])

        threads = [threading.Thread(target=stepper) for _ in range(3)] + [
            threading.Thread(target=generator, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not inner.overlap.overlapped
        assert [s.steps for s in sessions] == [20, 20, 20]
        assert inner.overlap.calls == 60 and inner.batches["generate"] >= 1
        # Opening a session may wait on the budget: never on a turn.
        assert inner.opened_while == [False, False, False]
        assert batching._device._owner is None

    def test_budget_waits_hold_no_turn(self):
        """A session open and a flush that wait on a budget another open
        session holds: that session still steps and closes, so all finish."""
        inner = SessionInner(budget=threading.Semaphore(1))
        batching = BatchingBackend(inner, engine=False, flush_ms=5.0, expected_sessions=3)
        inner.batching = batching
        first_open = threading.Event()
        steps = []

        def stepper(tag, wait):
            with batching.session():
                if wait:
                    assert first_open.wait(timeout=10)
                session = batching.open_fused_token_search("spec")
                first_open.set()
                for _ in range(5):
                    session.advance_and_propose([0], [None])
                    steps.append(tag)
                session.close()

        def generator():
            with batching.session():
                assert first_open.wait(timeout=10)
                batching.generate([GenerationRequest(user_prompt="g", max_tokens=4, seed=3)])

        # Daemon threads: a deadlock fails the test instead of hanging it.
        threads = [threading.Thread(target=stepper, args=("a", False), daemon=True),
                   threading.Thread(target=stepper, args=("b", True), daemon=True),
                   threading.Thread(target=generator, daemon=True)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(steps) == ["a"] * 5 + ["b"] * 5
        assert inner.batches["generate"] == 1

    def test_waiting_sessions_alternate_and_queued_calls_free_the_device(self):
        """A session's thread keeps the device between its calls only while
        nobody waits: two stepping sessions alternate call for call.  A
        session's thread that queues a protocol call between its steps
        hands the device to the flush (no deadlock)."""
        inner = SessionInner()
        batching = BatchingBackend(inner, engine=False, flush_ms=5.0, expected_sessions=2)
        inner.batching = batching
        order = []
        started = threading.Barrier(2)

        def stepper(tag):
            with batching.session():
                started.wait()
                session = batching.open_fused_token_search("spec")
                for step in range(8):
                    session.advance_and_propose([0], [None])
                    order.append(tag)
                    if step == 3:
                        batching.generate([GenerationRequest(
                            user_prompt=tag, max_tokens=4, seed=len(tag))])

        threads = [threading.Thread(target=stepper, args=(t,)) for t in ("a", "bb")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not inner.overlap.overlapped
        assert sorted(order) == ["a"] * 8 + ["bb"] * 8
        # Once both sessions step, no one steps twice in a row until the
        # other's queued generate or its last step lets it run alone.
        runs = sum(1 for i in range(1, len(order)) if order[i] == order[i - 1])
        assert runs <= 6, order
        assert batching._device._owner is None

    def test_session_attributes_read_through(self):
        inner = SessionInner()
        batching = BatchingBackend(inner, engine=False)
        inner.batching = batching
        session = batching.open_fused_token_search("spec")
        assert session.steps == 0
        session.advance_and_propose([0], [None])
        assert session.steps == 1 and session.session.steps == 1

    def test_declined_or_missing_sessions_raise_and_free_the_device(self):
        from consensus_tpu_torch.backends.session import (
            FusedSessionUnavailable,
            PrefixTokenSearchSession,
            SearchSpec,
            open_token_search,
        )

        inner = SessionInner()
        batching = BatchingBackend(inner, engine=False)
        inner.batching = batching
        with pytest.raises(FusedSessionUnavailable):
            batching.open_fused_token_search("declined")
        assert batching._device._owner is None
        spec = SearchSpec(ref_system=None, ref_user="u", agent_prompts=((None, "a"),),
                          n_slots=1, k=2)
        fallback = open_token_search(BatchingBackend(CountingBackend(), engine=False), spec)
        assert isinstance(fallback, PrefixTokenSearchSession)


# ---------------------------------------------------------------------------
# The port's concurrent Experiment on tiny-llama3 against the JAX package's
# ---------------------------------------------------------------------------

TINY = dict(model="tiny-llama3", dtype="float32", max_context=256)
OPINIONS = {
    "Agent 1": "Cities should build more bike lanes.",
    "Agent 2": "Roads are for cars; bikes slow traffic.",
    "Agent 3": "Only where streets are wide enough.",
}
TINY_CONFIG = {
    "experiment_name": "cobatch",
    "seed": 7,
    "num_seeds": 2,
    "scenario": {"issue": "Should the city add bike lanes?", "agent_opinions": OPINIONS},
    "methods_to_run": ["best_of_n", "habermas_machine", "beam_search"],
    "best_of_n": {"n": [2, 3], "max_tokens": 8},
    "habermas_machine": {"num_candidates": 2, "num_rounds": 1, "max_tokens": 8,
                         "pin_budget": True},
    "beam_search": {"beam_width": 2, "max_tokens": 4},
    "max_concurrent_methods": 8,
    "deterministic_artifacts": True,
}


@pytest.fixture(scope="module")
def tiny_backends():
    import jax

    from consensus_tpu.backends.tpu import TPUBackend
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.models.convert import params_from_jax

    torch.set_num_threads(1)
    ref = TPUBackend(**TINY)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", **TINY)


def test_concurrent_tiny_llama_matches_jax_and_sequential(tiny_backends, tmp_path):
    from consensus_tpu.experiment import Experiment as JaxExperiment
    from consensus_tpu_torch.experiment import Experiment

    ref, port = tiny_backends
    jax_run = JaxExperiment(dict(TINY_CONFIG, output_dir=str(tmp_path / "jax")), backend=ref)
    jax_run.run()
    concurrent = Experiment(dict(TINY_CONFIG, output_dir=str(tmp_path / "conc")), backend=port)
    frame = concurrent.run()
    sequential = Experiment(
        dict(TINY_CONFIG, output_dir=str(tmp_path / "seq"), concurrent_execution=False),
        backend=port,
    )
    sequential.run()
    # The port ran co-batched: fewer device batches than runs' calls.
    assert sum(concurrent.last_batch_counts.values()) > 0
    assert not hasattr(sequential, "last_batch_counts")
    assert list(frame["method"]) == (
        ["best_of_n"] * 2 + ["habermas_machine", "beam_search"]
    ) * 2
    assert (frame["error_message"] == "").all()
    got = (concurrent.run_dir / "results.csv").read_text()
    assert got == (jax_run.run_dir / "results.csv").read_text()
    assert got == (sequential.run_dir / "results.csv").read_text()

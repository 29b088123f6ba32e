"""The port's continuous-batching decode engine (``backends/engine.py``)
against the JAX package's.

The reference's own cases (``tests/test_engine.py``) run on the port over
the port's fake backend: engine = flush = solo for all seven methods, the
prefix cache, reservation-bounded admission, ``kv_oom``, interleaved
chunked prefill, cancellation and eviction, the obs families, K-step
stream windows and the ledger's dispatch/block split.  The parity cases
run every method through the port's engine and the JAX package's engine
(each over its own fake backend: bit-equal) and require the same statement;
on tiny-llama3 (float32, JAX weights through ``params_from_jax``) the
port's engine, its flush path and a solo ``TorchBackend`` give the same
statement for all seven methods, and the engine's K-step stream gives the
JAX stream's tokens.  Exact comparisons: the CPU in float32 is
batch-invariant (``deterministic_greedy``), and sampled draws use per-row
threefry keys, bit for bit ``jax.random``.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from consensus_tpu_torch.backends.base import (
    BackendIntegrityError,
    GenerationRequest,
    RequestCancelled,
    ScoreRequest,
)
from consensus_tpu_torch.backends.batching import BatchingBackend
from consensus_tpu_torch.backends.engine import DecodeEngine
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.methods import get_method_generator
from consensus_tpu_torch.obs.backends import bucket_recompiles
from consensus_tpu_torch.obs.metrics import Registry, diff_snapshots

torch.set_num_threads(1)

TOPIC = "Should the city invest in more bike lanes?"
OPINIONS = {
    "Agent 1": "Bike lanes make streets safer and should be expanded.",
    "Agent 2": "Road space is scarce; cars and buses need priority.",
    "Agent 3": "Invest only where cycling demand is proven.",
}

#: Small-but-real params for every method in GENERATOR_MAP (same settings
#: the per-method suites use, so any drift shows up in one place).
METHOD_PARAMS = {
    "zero_shot": {"seed": 42, "max_tokens": 30},
    "predefined": {"predefined_statement": "Exactly this statement."},
    "best_of_n": {"num_best_of_n": 4, "seed": 7, "max_tokens": 24},
    "beam_search": {"beam_width": 2, "max_tokens": 6, "seed": 5},
    "finite_lookahead": {
        "branching_factor": 2, "max_depth": 2, "max_tokens": 5, "seed": 9,
    },
    "mcts": {
        "num_simulations": 4, "expansion_sample_width": 3, "max_tokens": 4,
        "rollout_depth": 3, "seed": 2,
    },
    "habermas_machine": {
        "num_candidates": 3, "num_rounds": 1, "seed": 42, "max_tokens": 64,
    },
}


def _counter_total(registry, name, **labels):
    family = registry.snapshot()["families"].get(name)
    total = 0.0
    for series in (family or {}).get("series", ()):
        if all(series["labels"].get(k) == v for k, v in labels.items()):
            total += series["value"]
    return total


def _wait_until(predicate, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.002)
    return False


class TestByteIdentity:
    @pytest.mark.parametrize("method", sorted(METHOD_PARAMS))
    def test_engine_matches_legacy_and_solo(self, method):
        params = METHOD_PARAMS[method]
        solo = get_method_generator(
            method, FakeBackend(), dict(params)
        ).generate_statement(TOPIC, OPINIONS)

        legacy = BatchingBackend(FakeBackend(), flush_ms=1.0, engine=False)
        via_legacy = get_method_generator(
            method, legacy, dict(params)
        ).generate_statement(TOPIC, OPINIONS)

        engined = BatchingBackend(
            FakeBackend(), engine=True,
            engine_options={"slots": 4, "num_pages": 512},
        )
        try:
            via_engine = get_method_generator(
                method, engined, dict(params)
            ).generate_statement(TOPIC, OPINIONS)
        finally:
            engined.close()

        assert via_engine == solo, f"{method}: engine result diverged"
        assert via_legacy == solo, f"{method}: legacy result diverged"


class TestEnginePrefixByteIdentity:
    """With the prefix cache ON the engine must return byte-identical
    results for every method — the cache only changes which prefill work
    runs, never what any request computes."""

    @pytest.mark.parametrize("method", sorted(METHOD_PARAMS))
    def test_cache_on_equals_cache_off(self, method):
        params = METHOD_PARAMS[method]

        def run(**engine_options):
            backend = BatchingBackend(
                FakeBackend(), engine=True,
                engine_options={"slots": 4, "num_pages": 512,
                                **engine_options},
            )
            try:
                statement = get_method_generator(
                    method, backend, dict(params)
                ).generate_statement(TOPIC, OPINIONS)
                stats = backend.engine.stats()
            finally:
                backend.close()
            return statement, stats

        off, stats_off = run()
        on, stats_on = run(prefix_cache=True)
        assert on == off, f"{method}: prefix cache changed the statement"
        assert stats_off["prefix_cache"] == {"enabled": False}
        assert stats_on["prefix_cache"]["enabled"]

    def test_repeated_requests_hit_and_leave_no_leak(self):
        backend = BatchingBackend(
            FakeBackend(), engine=True,
            engine_options={"slots": 4, "page_size": 4, "num_pages": 64,
                            "prefix_cache": True},
        )
        req = GenerationRequest(
            user_prompt="alpha beta gamma delta epsilon zeta eta theta",
            max_tokens=8, seed=3,
        )
        solo = FakeBackend().generate([req, req])
        try:
            first = backend.generate([req])
            second = backend.generate([req])
            stats = backend.engine.stats()["prefix_cache"]
            engine = backend.engine
            # Cached pages stay pinned by the cache; nothing else leaks.
            assert engine.pool.in_use == stats["pages"]
        finally:
            backend.close()
        assert first[0].text == solo[0].text
        assert second[0].text == solo[1].text
        assert stats["hits"] >= 1
        assert stats["tokens_saved"] > 0
        assert stats["inserted_pages"] >= 1

    def test_prefix_metrics_families_emitted(self):
        reg = Registry()
        engine = DecodeEngine(
            FakeBackend(), slots=2, page_size=4, num_pages=64,
            prefix_cache=True, registry=reg,
        )
        req = GenerationRequest(
            user_prompt="one two three four five six seven eight",
            max_tokens=4, seed=1,
        )
        try:
            engine.submit("generate", [req])
            engine.submit("generate", [req])
        finally:
            engine.close()
        assert _counter_total(reg, "prefix_cache_hits_total") >= 1
        assert _counter_total(reg, "prefix_cache_misses_total") >= 1
        assert _counter_total(reg, "prefix_tokens_saved_total") > 0
        assert _counter_total(reg, "prefix_cache_inserted_pages_total") >= 1


# ---------------------------------------------------------------------------
# Scheduling semantics (deterministic stepping via auto_start=False)
# ---------------------------------------------------------------------------


def _submit_async(engine, requests, probe=None):
    """Run ``engine.submit`` in a thread; returns (thread, outbox dict)."""
    out = {}

    def worker():
        try:
            out["result"] = engine.submit("generate", requests, probe=probe)
        except BaseException as exc:  # noqa: BLE001 - test captures verbatim
            out["error"] = exc

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    return thread, out


class TestEngineScheduling:
    def test_full_slot_table_occupancy(self):
        """8 co-batched statements keep the whole slot table busy —
        occupancy mean >= 0.8."""
        reg = Registry()
        engine = DecodeEngine(
            FakeBackend(), slots=8, num_pages=512, auto_start=False,
            registry=reg,
        )
        threads = []
        for i in range(8):
            t, _ = _submit_async(
                engine,
                [GenerationRequest(
                    user_prompt=f"prompt {i} with a few extra words",
                    max_tokens=8, seed=i,
                )],
            )
            threads.append(t)
        assert _wait_until(lambda: engine.stats()["queue_depth"] == 8)
        engine.run_iteration()
        for t in threads:
            t.join(timeout=5.0)
        stats = engine.stats()
        assert stats["slot_occupancy_mean"] >= 0.8
        assert stats["slots_occupied"] == 0  # everything retired
        assert engine.pool.in_use == 0

    def test_admission_is_reservation_bounded(self):
        """Admission reserves prompt+max_tokens pages, so a resident row can
        always finish; the backlog holds FIFO until pages free up."""
        engine = DecodeEngine(
            FakeBackend(), slots=4, page_size=4, num_pages=8,
            auto_start=False, min_fill=1,
        )
        # Each request needs ceil((5 + 12)/4) = 5 pages; two can't coexist
        # in an 8-page pool.
        reqs = [
            GenerationRequest(
                user_prompt="one two three four five", max_tokens=12, seed=i,
            )
            for i in range(2)
        ]
        threads = [_submit_async(engine, [r])[0] for r in reqs]
        assert _wait_until(lambda: engine.stats()["queue_depth"] == 2)
        engine.run_iteration()
        stats = engine.stats()
        assert stats["kv_pages_reserved"] <= 8
        # Second row waited its turn; a later iteration retires it too.
        for _ in range(4):
            engine.run_iteration()
        for t in threads:
            t.join(timeout=5.0)
        assert engine.stats()["kv_pages_reserved"] == 0
        assert engine.pool.in_use == 0

    def test_oversized_request_rejected_as_kv_oom(self):
        from consensus_tpu_torch.serve.scheduler import SchedulerRejected

        backend = BatchingBackend(
            FakeBackend(), engine=True,
            engine_options={"slots": 2, "page_size": 4, "num_pages": 2},
        )
        try:
            with pytest.raises(SchedulerRejected) as excinfo:
                backend.generate(
                    [GenerationRequest(
                        user_prompt="this prompt is fine",
                        max_tokens=256, seed=0,
                    )]
                )
        finally:
            backend.close()
        assert excinfo.value.reason == "kv_oom"

    def test_interleaved_prefill_does_not_perturb_decode(self):
        """A second request arriving mid-prefill (chunk=1 drip) must not
        change the first request's tokens — token-for-token vs solo."""
        reqs = [
            GenerationRequest(
                user_prompt="alpha beta gamma delta epsilon zeta",
                max_tokens=8, seed=11,
            ),
            GenerationRequest(
                user_prompt="one two three four five six seven eight nine",
                max_tokens=8, seed=12,
            ),
        ]
        solo = FakeBackend().generate(reqs)

        engine = DecodeEngine(
            FakeBackend(), slots=2, page_size=4, num_pages=64,
            prefill_chunk=1, min_fill=1, auto_start=False,
        )
        t1, out1 = _submit_async(engine, [reqs[0]])
        assert _wait_until(lambda: engine.stats()["queue_depth"] == 1)
        engine.run_iteration()  # admit + first 1-token prefill chunk
        assert engine.stats()["slots_occupied"] == 1
        t2, out2 = _submit_async(engine, [reqs[1]])
        assert _wait_until(lambda: engine.stats()["queue_depth"] == 1)
        for _ in range(40):
            if out1 and out2:
                break
            engine.run_iteration()
        t1.join(timeout=5.0)
        t2.join(timeout=5.0)
        assert out1["result"][0].text == solo[0].text
        assert out2["result"][0].text == solo[1].text
        assert engine.pool.in_use == 0

    def test_cancellation_evicts_and_frees_pages(self):
        reg = Registry()
        engine = DecodeEngine(
            FakeBackend(), slots=2, page_size=4, num_pages=64,
            prefill_chunk=2, auto_start=False, registry=reg,
        )
        flag = {"cancelled": False}
        thread, out = _submit_async(
            engine,
            [GenerationRequest(
                user_prompt="one two three four five six seven eight",
                max_tokens=4, seed=3,
            )],
            probe=lambda: flag["cancelled"],
        )
        assert _wait_until(lambda: engine.stats()["queue_depth"] == 1)
        engine.run_iteration()  # admit + partial prefill (2 of 8 tokens)
        assert engine.stats()["slots_occupied"] == 1
        assert engine.pool.in_use > 0
        flag["cancelled"] = True
        engine.run_iteration()
        thread.join(timeout=5.0)
        assert isinstance(out.get("error"), RequestCancelled)
        assert engine.pool.in_use == 0
        assert engine.stats()["slots_occupied"] == 0
        assert _counter_total(reg, "engine_evicted_total") >= 1

    def test_submit_after_close_raises(self):
        engine = DecodeEngine(FakeBackend(), auto_start=False)
        engine.close()
        with pytest.raises(RuntimeError, match="closed"):
            engine.submit(
                "generate",
                [GenerationRequest(user_prompt="late", max_tokens=4, seed=0)],
            )


# ---------------------------------------------------------------------------
# Obs pins: no timeout flushes, no spurious wakeups, recompile-flat
# ---------------------------------------------------------------------------


class TestEngineObservability:
    def _run_ragged_load(self, registry, inner=None):
        inner = inner if inner is not None else FakeBackend(registry=registry)
        backend = BatchingBackend(
            inner, engine=True, registry=registry,
            engine_options={"slots": 4, "num_pages": 512},
        )
        results = {}

        def worker(i):
            with backend.session():
                results[i] = backend.generate(
                    [GenerationRequest(
                        user_prompt="word " * (3 + 7 * i),  # ragged lengths
                        max_tokens=8, seed=i,
                    )]
                )[0]

        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(6)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        backend.close()
        assert len(results) == 6
        return backend

    def test_no_timeout_flushes_and_no_spurious_wakeups(self):
        reg = Registry()
        self._run_ragged_load(reg)
        assert _counter_total(
            reg, "batching_flushes_total", reason="timeout") == 0
        assert _counter_total(reg, "batching_flushes_total") == 0
        assert _counter_total(reg, "batching_spurious_wakeups_total") == 0

    def test_engine_metric_families_recorded(self):
        reg = Registry()
        self._run_ragged_load(reg)
        snap = reg.snapshot()["families"]
        assert "engine_slot_occupancy" in snap
        assert _counter_total(reg, "engine_admitted_total") >= 6
        assert _counter_total(reg, "engine_prefill_chunks_total") >= 6
        tokens_iter = snap["engine_tokens_per_iteration"]["series"]
        assert tokens_iter and tokens_iter[0]["count"] >= 1
        pages = snap["kv_pages_in_use"]["series"]
        assert pages and pages[0]["max"] >= 1

    def test_bucket_recompiles_flat_across_ragged_load(self):
        """Slot lengths are data, not shapes: after warmup, ragged prompt
        lengths must add zero new compiled program shapes."""
        reg = Registry()
        inner = FakeBackend(registry=reg)
        self._run_ragged_load(reg, inner)  # warmup: first shape sightings
        cut = reg.snapshot()
        self._run_ragged_load(reg, inner)  # same bucketed shapes, new lengths
        delta = diff_snapshots(cut, reg.snapshot())
        assert bucket_recompiles(delta) == 0

    def test_engine_stats_surface(self):
        backend = BatchingBackend(
            FakeBackend(), engine=True,
            engine_options={"slots": 4, "num_pages": 128},
        )
        try:
            backend.generate(
                [GenerationRequest(user_prompt="hello", max_tokens=4, seed=0)]
            )
            stats = backend.engine.stats()
        finally:
            backend.close()
        assert stats["slots"] == 4
        assert stats["kv_pages"] == 128
        assert stats["iterations"] >= 1
        assert stats["kv_pages_high_water"] >= 1
        assert backend.batch_counts["generate"] >= 1  # aliased dispatch count


class TestMultiTokenByteIdentity:
    """``decode_steps`` must never change results — for any K, for every
    method: the K-step scan replays the sequential per-row key-split
    schedule and the engine's stream scheduling retires the same rows."""

    @pytest.mark.parametrize("method", sorted(METHOD_PARAMS))
    def test_engine_k_family_matches_legacy_all_methods(self, method):
        params = METHOD_PARAMS[method]
        solo = get_method_generator(
            method, FakeBackend(), dict(params)
        ).generate_statement(TOPIC, OPINIONS)

        for k in (1, 4, 8):
            engined = BatchingBackend(
                FakeBackend(), engine=True,
                engine_options={"slots": 4, "num_pages": 512,
                                "decode_steps": k},
            )
            try:
                via_engine = get_method_generator(
                    method, engined, dict(params)
                ).generate_statement(TOPIC, OPINIONS)
                stats = engined.engine.stats()
            finally:
                engined.close()
            assert via_engine == solo, f"{method}: K={k} diverged"
            assert stats["decode_steps"] == k


def _drain_stream(stream):
    """Drive a generate stream to completion; returns (results, windows)."""
    results, windows = {}, 0
    while not stream.finished:
        stream.dispatch()
        _, finished = stream.collect()
        results.update(finished)
        windows += 1
        assert windows < 200, "stream failed to drain"
    stream.close()
    return results, windows


class TestLedgerDispatchBlockSplit:
    """The ledger splits's device axis into dispatch (host enqueue)
    and block (waiting on results); the sum must still cover wall time."""

    def test_split_sums_and_coverage(self):
        engine = DecodeEngine(
            FakeBackend(), slots=8, num_pages=512, auto_start=False,
            decode_steps=4,
        )
        outboxes, threads = [], []
        try:
            for i in range(4):
                out = {}

                def worker(i=i, out=out):
                    out["result"] = engine.submit("generate", [
                        GenerationRequest(
                            user_prompt=f"prompt {i} with extra words",
                            max_tokens=8, seed=i,
                        )])

                thread = threading.Thread(target=worker, daemon=True)
                thread.start()
                threads.append(thread)
                outboxes.append(out)
            assert _wait_until(
                lambda: engine.stats()["queue_depth"] == 4)
            for _ in range(12):
                engine.run_iteration()
                if all("result" in out for out in outboxes):
                    break
            for thread in threads:
                thread.join(timeout=10.0)
            assert all("result" in out for out in outboxes)
            report = engine.stats()["mfu_attribution"]
            assert report["coverage"] >= 0.95  # the acceptance bar
            assert report["dispatch_s"] >= 0.0
            assert report["block_s"] > 0.0
            assert report["device_s"] == pytest.approx(
                report["dispatch_s"] + report["block_s"], abs=1e-5)
            # Fractions round to 4 decimals independently, so the split can
            # differ from device_fraction by one ulp each.
            assert report["dispatch_fraction"] + report["block_fraction"] \
                == pytest.approx(report["device_fraction"], abs=2e-4)
            # The CPU caveat ships in the report itself, not just the docs.
            assert "note" in report and "CPU" in report["note"]
            assert engine.stats()["decode_steps"] == 4
        finally:
            engine.close()

    def test_legacy_device_kwarg_books_as_block(self):
        from consensus_tpu_torch.obs.trace import IterationLedger

        ledger = IterationLedger()
        ledger.record(
            start_s=0.0, end_s=1.0, idle_s=0.1, device_s=0.5,
            host={"sweep": 0.2}, tokens=4, cohort=1,
        )
        report = ledger.mfu_attribution()
        assert report["block_s"] == pytest.approx(0.5)
        assert report["dispatch_s"] == 0.0
        assert report["device_s"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# Parity with the JAX package's engine
# ---------------------------------------------------------------------------

from consensus_tpu.backends.batching import BatchingBackend as JaxBatchingBackend  # noqa: E402
from consensus_tpu.backends.engine import DecodeEngine as JaxDecodeEngine  # noqa: E402
from consensus_tpu.backends.fake import FakeBackend as JaxFakeBackend  # noqa: E402
from consensus_tpu.methods import get_method_generator as jax_method_generator  # noqa: E402


@pytest.mark.parametrize("method", sorted(METHOD_PARAMS))
def test_engine_statement_matches_jax_engine(method):
    params = METHOD_PARAMS[method]
    options = {"slots": 4, "num_pages": 512, "decode_steps": 4}
    port = BatchingBackend(FakeBackend(), engine=True, engine_options=options)
    ref = JaxBatchingBackend(JaxFakeBackend(), engine=True, engine_options=options)
    try:
        got = get_method_generator(method, port, dict(params)).generate_statement(TOPIC, OPINIONS)
        want = jax_method_generator(method, ref, dict(params)).generate_statement(TOPIC, OPINIONS)
        port_stats, ref_stats = port.engine.stats(), ref.engine.stats()
    finally:
        port.close()
        ref.close()
    assert got == want
    for key in ("decode_windows", "decoded_tokens", "kv_pages", "slots"):
        assert port_stats[key] == ref_stats[key], key


def test_engine_raises_for_speculative_and_mesh():
    """Speculative windows build now (``speculative`` alone implies K=4, as
    in the JAX engine, and the fake stream drafts for real); ``mesh`` builds
    too, its slots and pools over dp shards as in the JAX engine, and a
    tensor-parallel backend (queue A15) raises."""
    engine = DecodeEngine(FakeBackend(), speculative=True, auto_start=False)
    ref = JaxDecodeEngine(JaxFakeBackend(), speculative=True, auto_start=False)
    try:
        assert engine.speculative and engine.decode_steps == ref.decode_steps == 4
        assert engine.stats()["speculative"] == ref.stats()["speculative"]
    finally:
        engine.close()
        ref.close()
    engine = DecodeEngine(FakeBackend(), mesh={"dp": 2, "tp": 1}, auto_start=False)
    ref = JaxDecodeEngine(JaxFakeBackend(), mesh={"dp": 2, "tp": 1}, auto_start=False)
    try:
        assert engine.mesh_dp == ref.mesh_dp == 2 and len(engine.pools) == len(ref.pools) == 2
        assert engine.stats()["mesh"] == ref.stats()["mesh"]
    finally:
        engine.close()
        ref.close()
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    with pytest.raises(NotImplementedError, match="A15"):
        DecodeEngine(TorchBackend(model="tiny-llama3", device="cpu", mesh="dp=1,tp=2"),
                     auto_start=False)
    stream = FakeBackend().generate_stream([GenerationRequest(user_prompt="x", max_tokens=24)],
                                           decode_steps=4, speculative=True)
    while not stream.finished:
        stream.dispatch()
        stream.collect()
    assert stream.speculative and stream.spec_proposed > 0


# ---------------------------------------------------------------------------
# tiny-llama3 TorchBackend: engine = flush = solo, and engine streams
# ---------------------------------------------------------------------------

TINY = dict(model="tiny-llama3", dtype="float32", max_context=256, base_seed=3)


@pytest.fixture(scope="module")
def tiny_backends():
    from consensus_tpu.backends.tpu import TPUBackend
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.models.convert import params_from_jax

    ref = TPUBackend(**TINY)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(params=params, device="cpu", **TINY)


@pytest.mark.parametrize("method", sorted(METHOD_PARAMS))
def test_tiny_llama3_engine_equals_flush_and_solo(tiny_backends, method):
    port = tiny_backends[1]
    params = METHOD_PARAMS[method]
    solo = get_method_generator(method, port, dict(params)).generate_statement(TOPIC, OPINIONS)
    flush = BatchingBackend(port, flush_ms=1.0, engine=False)
    via_flush = get_method_generator(method, flush, dict(params)).generate_statement(TOPIC, OPINIONS)
    engined = BatchingBackend(port, engine=True, engine_options={"slots": 4, "num_pages": 512})
    try:
        via_engine = get_method_generator(method, engined, dict(params)).generate_statement(
            TOPIC, OPINIONS)
    finally:
        engined.close()
    assert via_engine == solo, f"{method}: engine diverged"
    assert via_flush == solo, f"{method}: flush diverged"


def test_tiny_llama3_engine_stream_matches_jax_stream(tiny_backends):
    from consensus_tpu.backends.base import GenerationRequest as JaxRequest

    ref, port = tiny_backends
    cohort = [("Say something about apples.", 11, 12, 0.8), ("Hi", 22, 5, 0.0),
              ("A longer prompt spanning several pages of the pool.", 33, 20, 0.9)]
    jax_stream = ref.generate_stream(
        [JaxRequest(user_prompt=p, seed=s, max_tokens=m, temperature=t) for p, s, m, t in cohort],
        decode_steps=4)
    want, _ = _drain_stream(jax_stream)
    engined = BatchingBackend(
        port, engine=True, engine_options={"slots": 4, "num_pages": 512, "decode_steps": 4})
    try:
        got = engined.generate(
            [GenerationRequest(user_prompt=p, seed=s, max_tokens=m, temperature=t)
             for p, s, m, t in cohort])
        stats = engined.engine.stats()
    finally:
        engined.close()
    assert [(r.text, r.token_ids, r.finish_reason) for r in got] == [
        (want[i].text, want[i].token_ids, want[i].finish_reason) for i in range(len(cohort))]
    assert stats["decode_windows"] >= 2 and stats["tokens_per_dispatch_mean"] > 1.0


# ---------------------------------------------------------------------------
# Fused sessions under the engine keep their device turns
# ---------------------------------------------------------------------------


def test_tracked_fused_session_takes_turns_and_releases_engine_slots():
    import types

    from tests.test_torch_batching import SessionInner

    inner = SessionInner()
    batching = BatchingBackend(inner, engine=True, engine_options={"slots": 2, "num_pages": 64})
    inner.batching = batching
    try:
        session = batching.open_fused_token_search(types.SimpleNamespace(n_slots=3))
        stats = batching.engine.stats()
        assert stats["fused_search_sessions"] == 1 and stats["fused_search_slots"] == 3
        session.advance_and_propose([0], [None])
        assert batching._device.held()
        session.close()
        assert batching.engine.stats()["fused_search_sessions"] == 0
        assert batching._device._owner is None
    finally:
        batching.close()


# ---------------------------------------------------------------------------
# Flush-snapshot cancellation and per-row error distribution
# ---------------------------------------------------------------------------


def test_cancelled_entry_dropped_sibling_slice_identical():
    registry = Registry()
    batching = BatchingBackend(FakeBackend(), flush_ms=50.0, expected_sessions=2,
                               registry=registry, engine=False)
    live_request = GenerationRequest(user_prompt="live", max_tokens=4, seed=7)
    barrier = threading.Barrier(2)
    out = {}

    def live_worker():
        with batching.session():
            barrier.wait()
            out["live"] = batching.generate([live_request])[0]

    def cancelled_worker():
        with batching.session(cancelled=lambda: True):
            barrier.wait()
            try:
                batching.generate([GenerationRequest(user_prompt="gone", max_tokens=4, seed=8)])
            except RequestCancelled as exc:
                out["cancelled"] = exc

    threads = [threading.Thread(target=live_worker), threading.Thread(target=cancelled_worker)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert isinstance(out["cancelled"], RequestCancelled)
    assert out["live"].text == FakeBackend().generate([live_request])[0].text
    assert _counter_total(registry, "batching_cancelled_requests_total") == 1


def test_probe_consulted_once_per_entry_at_snapshot():
    inner = FakeBackend()
    batching = BatchingBackend(inner, flush_ms=5.0, engine=False)
    consults = {"n": 0}

    def probe():
        consults["n"] += 1
        return consults["n"] > 1

    with batching.session(cancelled=probe):
        first = batching.generate([GenerationRequest(user_prompt="a", max_tokens=4, seed=1)])
        assert first[0].text
        with pytest.raises(RequestCancelled):
            batching.generate([GenerationRequest(user_prompt="b", max_tokens=4, seed=2)])
    assert batching.batch_counts["generate"] == 1


def test_broken_probe_treated_as_not_cancelled():
    def bad_probe():
        raise RuntimeError("probe exploded")

    batching = BatchingBackend(FakeBackend(), flush_ms=5.0, engine=False)
    with batching.session(cancelled=bad_probe):
        results = batching.generate([GenerationRequest(user_prompt="x", max_tokens=4, seed=3)])
    assert results[0].text


@pytest.mark.parametrize("engine", [False, True])
def test_nan_row_fails_one_session_siblings_identical(engine):
    """One NaN row in a merged score batch fails only the session that owns
    it (typed ``BackendIntegrityError``), through the flush path and the
    engine alike; the engine is stepped by hand so all three rows are in
    its first dispatch."""
    from consensus_tpu_torch.backends import wrap_backend

    plan = {"faults": [{"kind": "nan_logprobs", "op": "score", "call_index": 0, "row_index": 1}]}
    registry = Registry()
    stack = wrap_backend(FakeBackend(), fault_plan=plan, registry=registry)
    # A long flush window: only the all-blocked trigger flushes, once all
    # three sessions have queued.
    batching = BatchingBackend(
        stack, flush_ms=30_000.0, expected_sessions=3, registry=registry, engine=engine,
        engine_options={"slots": 4, "num_pages": 512, "auto_start": False} if engine else None,
    )
    reqs = [ScoreRequest(context="ctx", continuation=f"row {i}") for i in range(3)]
    clean = FakeBackend().score(reqs)
    results = {}
    barrier = threading.Barrier(3)

    def worker(i):
        with batching.session():
            barrier.wait(timeout=30)
            try:
                results[i] = batching.score([reqs[i]])[0]
            except Exception as exc:  # noqa: BLE001 - asserted below
                results[i] = exc

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        if engine:
            assert _wait_until(lambda: batching.engine.stats()["queue_depth"] == 3)
            batching.engine.run_iteration()
        for t in threads:
            t.join(timeout=30)
    finally:
        batching.close()
    assert batching.batch_counts["score"] == 1
    failed = [i for i in range(3) if isinstance(results[i], Exception)]
    assert len(failed) == 1
    assert isinstance(results[failed[0]], BackendIntegrityError)
    for i in range(3):
        if i not in failed:
            assert results[i].logprobs == clean[i].logprobs
    if not engine:
        assert 'batching_row_errors_total{kind="score"} 1' in registry.to_prometheus()

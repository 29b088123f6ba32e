"""The data-parallel serving mesh of the port, against the JAX package on
its 8 virtual CPU devices: the ports of ``TestEngineMeshMode``
(``tests/test_mesh_serving.py:227-305``) and ``TestMeshServingEndToEnd``
(``:308-384``), ``TorchBackend(dp=N)`` on every protocol call and a search
session against dp=1, ``create_server(mesh=)`` and ``--mesh`` answering on
the CPU, the sharded ``restore_params`` against JAX ``shard_params``, and
``cli/bench_mesh.py --device cpu``.  The port's dp shards are CPU shards."""

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from consensus_tpu.backends.batching import BatchingBackend as JaxBatchingBackend
from consensus_tpu.backends.engine import DecodeEngine as JaxDecodeEngine
from consensus_tpu.backends.fake import FakeBackend as JaxFakeBackend
from consensus_tpu.backends.tpu import TPUBackend
from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu_torch.backends.base import (
    GenerationRequest,
    NextTokenRequest,
    ScoreRequest,
)
from consensus_tpu_torch.backends.batching import BatchingBackend
from consensus_tpu_torch.backends.engine import DecodeEngine
from consensus_tpu_torch.backends.fake import FakeBackend
from consensus_tpu_torch.backends.score_matrix import AgentContext, ScoreMatrixRequest
from consensus_tpu_torch.backends.session import SearchSpec
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.experiment import Experiment
from consensus_tpu_torch.models.convert import params_from_jax
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.parallel import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model="tiny-gemma2", max_context=128)


def _submit_async(engine, requests):
    out = {}

    def worker():
        out["result"] = engine.submit("generate", requests)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    return thread, out


def _wait_until(predicate, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.002)
    return False


class TestEngineMeshMode:
    @pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
    def test_dp_partitions_pools_and_balances_admission(self, port):
        """4 rows needing 5 pages each are all resident at once under dp=4
        with 8-page per-shard pools; admission spreads them one per shard;
        the texts equal the fake backend's solo ones.  tp=2 is recorded
        over a backend with no mesh, as in the JAX engine."""
        engine_cls, fake_cls, reg = ((DecodeEngine, FakeBackend, Registry()) if port
                                     else (JaxDecodeEngine, JaxFakeBackend, JaxRegistry()))
        engine = engine_cls(fake_cls(), slots=8, page_size=4, num_pages=8, auto_start=False,
                            mesh={"dp": 4, "tp": 2}, registry=reg)
        assert engine.mesh_dp == 4 and engine.mesh_tp == 2
        assert len({id(p) for p in engine.pools}) == 4 and engine.pool is engine.pools[0]
        reqs = [GenerationRequest(user_prompt="one two three four five", max_tokens=12, seed=i)
                for i in range(4)]
        solo = fake_cls().generate(reqs)
        threads = [_submit_async(engine, [r]) for r in reqs]
        assert _wait_until(lambda: engine.stats()["queue_depth"] == 4)
        with engine._lock:
            engine._admit()
        assert sorted(s.shard for s in engine._slots if s is not None) == [0, 1, 2, 3]
        stats = engine.stats()
        assert stats["mesh"]["dp"] == 4 and stats["mesh"]["tp"] == 2
        assert [s["slots_occupied"] for s in stats["mesh"]["per_shard"]] == [1, 1, 1, 1]
        assert all(s["kv_pages_reserved"] == 5 for s in stats["mesh"]["per_shard"])
        for _ in range(4):
            engine.run_iteration()
        for thread, _ in threads:
            thread.join(timeout=5.0)
        assert [out["result"][0].text for _, out in threads] == [r.text for r in solo]
        assert all(pool.in_use == 0 for pool in engine.pools)
        assert engine.stats()["kv_pages_reserved"] == 0
        engine.close()

    def test_mesh_gauges_emitted(self):
        reg = Registry()
        engine = DecodeEngine(FakeBackend(), slots=4, num_pages=16, auto_start=False,
                              mesh="dp=2,tp=1", registry=reg)
        families = reg.snapshot()["families"]
        assert families["engine_mesh_dp"]["series"][0]["value"] == 2
        assert families["engine_mesh_tp"]["series"][0]["value"] == 1
        engine.close()

    def test_dp1_mesh_is_the_legacy_engine(self):
        engine = DecodeEngine(FakeBackend(), slots=2, num_pages=16, auto_start=False,
                              mesh={"dp": 1, "tp": 1})
        assert engine.pools == [engine.pool] and engine.mesh_dp == 1
        engine.close()

    def test_engine_inherits_the_backend_plan(self, backends):
        _, port = backends
        wide = TorchBackend(**TINY, params=port.params, config=port.config, device="cpu", dp=2)
        engine = DecodeEngine(wide, slots=4, num_pages=16, auto_start=False)
        assert engine.mesh_dp == 2 and engine._shard_rows
        engine.close()


@pytest.fixture(scope="module")
def backends():
    ref = TPUBackend(**TINY)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config)
    return ref, TorchBackend(**TINY, params=params, config=ref.config, device="cpu",
                             dtype="float32")


def _wide(port, dp):
    return TorchBackend(**TINY, params=port.params, config=port.config, device="cpu",
                        dtype="float32", dp=dp)


class TestMeshServingEndToEnd:
    N_REQUESTS = 6
    MAX_TOKENS = 4

    def _requests(self, cls=GenerationRequest):
        return [cls(user_prompt=f"Draft a statement on issue {i}.", max_tokens=self.MAX_TOKENS,
                    temperature=0.8, seed=100 + i, chat=False)
                for i in range(self.N_REQUESTS)]

    def _texts(self, backend, mesh, batching_cls=BatchingBackend, registry=Registry,
               decode_steps=None):
        options = {"slots": 8, "page_size": 16, "num_pages": 4}
        if mesh is not None:
            options["mesh"] = mesh
        if decode_steps is not None:
            options["decode_steps"] = decode_steps
        batching = batching_cls(backend, registry=registry(), engine=True, engine_options=options)
        request_cls = GenerationRequest
        if batching_cls is JaxBatchingBackend:
            from consensus_tpu.backends.base import GenerationRequest as request_cls
        try:
            with ThreadPoolExecutor(max_workers=self.N_REQUESTS) as pool:
                futures = [pool.submit(batching.generate, [r])
                           for r in self._requests(request_cls)]
                return [f.result()[0].text for f in futures]
        finally:
            batching.close()

    @pytest.mark.parametrize("decode_steps", [None, 4])
    def test_texts_match_dp_and_jax(self, backends, decode_steps):
        """dp=4 texts == dp=1 == the plain engine path == JAX's
        ``TPUBackend(dp=4)`` through its engine."""
        ref, port = backends
        plain = self._texts(port, None, decode_steps=decode_steps)
        dp1 = self._texts(port, {"dp": 1, "tp": 1}, decode_steps=decode_steps)
        assert dp1 == plain
        dp4 = self._texts(_wide(port, 4), {"dp": 4, "tp": 1}, decode_steps=decode_steps)
        assert dp4 == dp1
        jax_wide = TPUBackend(**TINY, dp=4, params=ref.params, config=ref.config)
        jax_dp4 = self._texts(jax_wide, {"dp": 4, "tp": 1}, JaxBatchingBackend, JaxRegistry)
        assert dp4 == jax_dp4

    def test_kv_cache_identity_partitions_by_tp_not_dp(self, backends):
        ref, port = backends
        assert port.kv_cache_identity() == ref.kv_cache_identity()
        assert _wide(port, 2).kv_cache_identity() == port.kv_cache_identity()
        assert ("tp", 1) in port.kv_cache_identity()


class TestBackendDataParallel:
    """``TorchBackend(dp=N)`` on each protocol call against dp=1."""

    @pytest.mark.parametrize("dp", [2, 4])
    def test_protocol_calls_equal_dp1(self, backends, dp):
        _, port = backends
        wide = _wide(port, dp)
        assert wide.mesh_plan.dp == dp and len(wide._shards) == dp
        gen = [GenerationRequest(user_prompt=f"Say {i}", max_tokens=6, temperature=0.8, seed=i)
               for i in range(5)]
        same = [GenerationRequest(user_prompt="Same", max_tokens=6, temperature=0.8, seed=i)
                for i in range(8)]
        for requests in (gen, same):
            assert ([r.token_ids for r in wide.generate(requests)]
                    == [r.token_ids for r in port.generate(requests)])
        scores = [ScoreRequest(context=f"context {i}", continuation=f"words {i} here")
                  for i in range(5)]
        for a, b in zip(wide.score(scores), port.score(scores)):
            np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-6)
        texts = ["a b", "c d e", "f"]
        np.testing.assert_allclose(wide.embed(texts), port.embed(texts), atol=1e-6)
        nexts = [NextTokenRequest(user_prompt=f"p{i}", k=4, seed=i) for i in range(3)]
        assert ([[c.token_id for c in r] for r in wide.next_token_logprobs(nexts)]
                == [[c.token_id for c in r] for r in port.next_token_logprobs(nexts)])
        matrix = ScoreMatrixRequest(
            agents=tuple(AgentContext(context=f"opinion {i} " * (i + 5)) for i in range(3)),
            candidates=tuple(f"candidate {j}" for j in range(5)))
        got, want = wide.score_matrix([matrix])[0], port.score_matrix([matrix])[0]
        assert got.path == want.path == "fused"
        np.testing.assert_allclose(got.utilities, want.utilities, atol=1e-6)

    def test_generate_rows_scale_with_dp(self, backends):
        _, port = backends
        wide = _wide(port, 4)
        assert wide._rows_for(1 << 20) == 4 * port._rows_for(1 << 20)

    @pytest.mark.parametrize("n_slots", [4, 3])
    def test_beam_session_ids_equal_dp1(self, backends, n_slots):
        """A 4-slot session splits its slots over the 4 shards (parents
        cross shards); a 3-slot one runs whole on one shard."""
        _, port = backends
        wide = _wide(port, 4)
        spec = SearchSpec(ref_system=None, ref_user="Write a statement",
                          agent_prompts=((None, "agent one"), (None, "agent two")),
                          n_slots=n_slots, k=3, seed=5, max_steps=8)
        rng = np.random.default_rng(0)
        parents = [rng.integers(0, n_slots, n_slots).tolist() for _ in range(5)]
        picks = [rng.integers(0, 3, n_slots).tolist() for _ in range(5)]

        def run(backend):
            session = backend.open_fused_token_search(spec)
            outs = [session.propose()]
            for step in range(5):
                chosen = [outs[-1][p][c] for p, c in zip(parents[step], picks[step])]
                outs.append(session.advance_and_propose(parents[step], chosen))
            kind = type(session).__name__
            session.close()
            return kind, [[[(c.token_id, round(c.ref_logprob, 4)) for c in row] for row in o]
                          for o in outs]

        kind, got = run(wide)
        _, want = run(port)
        assert kind == ("_ShardedSearchSession" if n_slots == 4 else "TorchTokenSearchSession")
        assert got == want
        assert all(s._session_budget.used == 0 for s in wide._shards)

    def test_beam_search_method_through_experiment(self, backends, tmp_path):
        _, port = backends
        config = {"output_dir": str(tmp_path), "seed": 3, "num_seeds": 1,
                  "methods_to_run": ["beam_search"], "concurrent_execution": False,
                  "beam_search": {"beam_width": 4, "max_tokens": 6},
                  "scenario": {"issue": "Parks?", "agent_opinions": {"A": "yes", "B": "no"}}}
        rows = {}
        for name, backend in (("dp1", port), ("dp4", _wide(port, 4))):
            experiment = Experiment(dict(config), backend=backend)
            frame = experiment.run()
            rows[name] = list(frame["statement"])
            metrics = json.loads((experiment.run_dir / "metrics.json").read_text())
            assert metrics["mesh"] == ({"dp": 4, "tp": 1} if name == "dp4" else {"dp": 1, "tp": 1})
        assert rows["dp4"] == rows["dp1"]

    @pytest.mark.parametrize("option, value", [("tp", 2), ("mesh", "dp=1,tp=2"),
                                               ("mesh", {"dp": 2, "tp": 2})])
    def test_tp_raises_naming_a15(self, backends, option, value):
        """The tp spellings build a tensor-parallel backend (queue A15,
        ported) that answers as tp=1 does."""
        _, port = backends
        wide = TorchBackend(**TINY, params=port.params, config=port.config, dtype="float32",
                            device="cpu", **{option: value})
        assert wide._tp == 2 and wide._dp == (2 if isinstance(value, dict) else 1)
        requests = [GenerationRequest(user_prompt=f"x{i}", max_tokens=4, seed=i)
                    for i in range(2)]
        assert ([r.token_ids for r in wide.generate(requests)]
                == [r.token_ids for r in port.generate(requests)])

    def test_a_plan_names_the_devices(self, backends):
        _, port = backends
        plan = make_mesh(["cpu"] * 3, tp=1)
        wide = TorchBackend(**TINY, params=port.params, config=port.config, dtype="float32",
                            mesh=plan)
        assert wide.mesh_plan is plan and wide._dp == 3
        requests = [GenerationRequest(user_prompt=f"x{i}", max_tokens=4, seed=i) for i in range(3)]
        assert ([r.token_ids for r in wide.generate(requests)]
                == [r.token_ids for r in port.generate(requests)])

    def test_mesh_devices_name_the_cards_of_a_dp_spec(self, backends):
        """``mesh_devices`` (the form a JSON option can carry, as the serve
        CLI's ``--backend-options``) places the dp shards of a spec; it
        conflicts with a plan and means nothing at dp=1."""
        _, port = backends
        wide = TorchBackend(**TINY, params=port.params, config=port.config, dtype="float32",
                            mesh="dp=2,tp=1", mesh_devices=["cpu", "cpu", "cpu"])
        assert wide._dp == 2 and [str(d) for d in wide.mesh_plan.data_devices] == ["cpu", "cpu"]
        requests = [GenerationRequest(user_prompt=f"y{i}", max_tokens=4, seed=i) for i in range(2)]
        assert ([r.token_ids for r in wide.generate(requests)]
                == [r.token_ids for r in port.generate(requests)])
        with pytest.raises(ValueError, match="MeshPlan"):
            TorchBackend(**TINY, params=port.params, mesh=make_mesh(["cpu"] * 2),
                         mesh_devices=["cpu", "cpu"])
        with pytest.raises(ValueError, match="dp is 1"):
            TorchBackend(**TINY, params=port.params, device="cpu", mesh_devices=["cpu"])

    def test_shards_on_one_card_split_its_budget(self, backends, monkeypatch):
        """A plan that repeats a card: the shards on it split its budget, so
        their row buckets together fit the card.  CPU shards stand for
        separate devices (``_card_shares`` stubbed here to count them as
        one card, as it counts a repeated ``cuda`` entry)."""
        from consensus_tpu_torch.backends import torch_backend

        cards = [torch.device("cuda", 0), torch.device("cuda", 0), torch.device("cuda", 1),
                 torch.device("cpu"), torch.device("cpu")]
        assert torch_backend._card_shares(cards) == [2, 2, 1, 1, 1]
        _, port = backends
        monkeypatch.setattr(torch_backend, "_card_shares", lambda devices: [len(devices)] * len(devices))
        wide = _wide(port, 2)
        row_bytes = 1 << 30
        per_shard = wide._shards[0]._rows_for(row_bytes)
        assert wide._rows_for(row_bytes) == 2 * per_shard
        assert per_shard < port._rows_for(row_bytes)
        budget = wide._shards[0]._device_budget
        assert 2 * (per_shard * row_bytes + torch_backend._ACTIVATION_RESERVE_BYTES) <= budget


SERVE_PAYLOAD = {"issue": "Should the town build a new park?",
                 "agent_opinions": {"A": "Yes, green space matters.", "B": "Only if cheap."},
                 "method": "best_of_n", "params": {"n": 2, "max_tokens": 6}, "seed": 7}
SERVE_OPTIONS = {"model": "tiny-gemma2", "dtype": "float32", "max_context": 128}


def _post(base, payload):
    import urllib.request

    request = urllib.request.Request(base + "/v1/consensus", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=120) as response:
        return response.status, json.loads(response.read().decode())


def test_create_server_with_mesh_answers_on_the_cpu():
    from consensus_tpu_torch.serve import create_server

    statements, meshes = {}, {}
    for mesh in (None, "dp=2,tp=1"):
        server = create_server(backend="torch", backend_options=dict(SERVE_OPTIONS, device="cpu"),
                               port=0, registry=Registry(), mesh=mesh).start()
        try:
            status, body = _post(server.base_url, SERVE_PAYLOAD)
            import urllib.request

            with urllib.request.urlopen(server.base_url + "/healthz", timeout=30) as response:
                health = json.loads(response.read().decode())
        finally:
            server.stop()
        assert status == 200 and body["statement"]
        statements[mesh] = body["statement"]
        meshes[mesh] = health["engine"]["mesh"]
    assert statements["dp=2,tp=1"] == statements[None]
    assert len(meshes["dp=2,tp=1"]["per_shard"]) == 2 and meshes[None]["dp"] == 1


def test_cli_mesh_flag_serves_on_the_cpu(tmp_path):
    import signal

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensus_tpu_torch.serve", "--backend", "torch",
         "--backend-options", json.dumps(SERVE_OPTIONS), "--device", "cpu", "--port", "0",
         "--log-level", "WARNING", "--mesh", "dp=2,tp=1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT,
    )
    try:
        startup = json.loads(proc.stdout.readline())
        assert startup["mesh"] == "dp=2,tp=1"
        status, body = _post(startup["serving"], SERVE_PAYLOAD)
        assert status == 200 and body["statement"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("dp, tp, int8", [(4, 2, False), (8, 1, True), (2, 2, True)])
def test_sharded_restore_equals_jax_shard_params(tmp_path, dp, tp, int8):
    """restore_params(shardings=...) places each piece straight from the
    file: every grid position's tree equals JAX ``shard_params``'s shard
    there, and a dp replica is read once and shared on a repeated device."""
    from consensus_tpu.models.quant import quantize_params as jax_quantize
    from consensus_tpu.parallel import make_mesh as jax_make_mesh
    from consensus_tpu.parallel import shard_params as jax_shard_params
    from consensus_tpu_torch.parallel import param_shardings, shard_params
    from consensus_tpu_torch.utils.checkpoint import restore_params, save_params

    ref = TPUBackend(model="tiny-llama3", max_context=128)
    jax_params = jax_quantize(ref.params) if int8 else ref.params
    params = params_from_jax(jax.tree.map(np.asarray, jax_params), ref.config)
    save_params(str(tmp_path), params)
    plan = make_mesh(["cpu"] * 8, tp=tp, dp=dp)
    template = {k: v for k, v in params.items()}
    trees = restore_params(str(tmp_path), template=template,
                           shardings=param_shardings(params, plan))
    want = shard_params(params, plan)
    jax_plan = jax_make_mesh(tp=tp, dp=dp)
    sharded = jax_shard_params(jax_params, jax_plan.mesh)
    positions = {dev.id: idx for idx, dev in np.ndenumerate(jax_plan.mesh.devices)}
    leaf = sharded["layers"]["wq"]
    for q_or_plain in ((leaf.q,) if int8 else (leaf,)):
        for shard in q_or_plain.addressable_shards:
            d, t = positions[shard.device.id]
            got = np.stack([(l["wq"].q if int8 else l["wq"]).float().numpy()
                            for l in trees[d][t]["layers"]])
            np.testing.assert_array_equal(got, np.asarray(shard.data).astype(np.float32))
    for d in range(dp):
        for t in range(tp):
            from tests.test_torch_loader import assert_params_equal

            assert_params_equal(trees[d][t], want[d][t])
    first = [trees[d][0]["layers"][0]["wq"] for d in (0, 1)]
    if int8:
        first = [leaf.q for leaf in first]
    assert first[0].data_ptr() == first[1].data_ptr()  # one read, one copy per device


def test_restore_template_refuses_a_mismatch(tmp_path):
    from consensus_tpu_torch.utils.checkpoint import restore_params, save_params

    params = {"embed": torch.zeros(4, 3), "layers": [{"wq": torch.ones(3, 3)}],
              "final_norm": torch.ones(3)}
    save_params(str(tmp_path), params)
    assert torch.equal(restore_params(str(tmp_path), template=params)["layers"][0]["wq"],
                       params["layers"][0]["wq"])
    bad = {"embed": torch.zeros(4, 3), "layers": [{"wq": torch.ones(3, 2)}],
           "final_norm": torch.ones(3, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="final_norm.*layers.0.wq"):
        restore_params(str(tmp_path), template=bad)


def test_bench_mesh_on_cpu_shards(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "consensus_tpu_torch.cli.bench_mesh", "--device", "cpu",
         "--requests", "8", "--tokens", "4", "--trials", "1", "--trace", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])["bench_mesh"]
    assert report["texts_match_dp"] is True
    assert report["dp1_byte_identical_to_engine"] is True
    assert report["mesh_scaling_efficiency"] > 0
    # One traced dispatch a width: host CPU time read, no card to profile.
    for width, rows in (("dp4", 4), ("dp1", 1)):
        trace = report["trace"][width]
        assert trace["rows"] == rows and trace["device_busy_ms"] == {}
        for run in (trace["default_switch"], trace["short_switch"]):
            assert run["wall_s"] > 0 and run["host_cpu_s"] >= 0
        assert (tmp_path / f"{width}_ops.txt").exists()


def test_concurrent_callers_share_the_shard_threads(backends):
    """Callers on many threads at once, more than there are shards and
    cores, with a short switch interval: every call gets dp=1's tokens and
    the shared counters lose no update."""
    _, port = backends
    wide = _wide(port, 4)
    requests = [GenerationRequest(user_prompt=f"Hi {i}", max_tokens=3, seed=i) for i in range(4)]
    want = [r.token_ids for r in port.generate(requests)]
    before = wide.call_counts["generate"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=12) as pool:
            futures = [pool.submit(wide.generate, requests) for _ in range(24)]
            outs = [f.result(timeout=300) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert all([r.token_ids for r in out] == want for out in outs)
    assert wide.call_counts["generate"] - before == 24 * len(requests)

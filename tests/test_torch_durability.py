"""The port's durable serving state (``create_server(state_dir=...)``: the
request WAL, the durable idempotency snapshot, replay on relaunch, and
``consensus_tpu_torch/scripts/durability_smoke.py``) against the JAX
package's.

Tolerance: exact bytes over the fake backends.  A server with a state dir
answers exactly as one without and as the JAX server with one; requests a
JAX WAL admitted but never resolved (a crash) are replayed by a port
server on relaunch and answer as the JAX server answers them, the second
ask from the idempotency snapshot; and the SIGKILL harness, which runs the
port's CLI as a real subprocess, reports ``ok``."""

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request

from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu.serve import create_server as jax_create_server
from consensus_tpu.serve.scheduler import idempotency_key
from consensus_tpu.serve.service import parse_request as jax_parse
from consensus_tpu.serve.wal import RequestWAL as JaxWAL
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.serve import create_server

ISSUE = "Should the city expand night bus service?"
OPINIONS = {"Agent 1": "Yes, shift workers need it.", "Agent 2": "Only if daytime service holds."}
TIMING = ("generation_time_s", "queue_wait_s", "latency_s")


def _payload(seed):
    return {"issue": ISSUE, "agent_opinions": dict(OPINIONS), "method": "best_of_n",
            "params": {"n": 4, "max_tokens": 24}, "seed": seed, "request_id": f"dur-{seed}"}


def _post(base_url, payload):
    request = urllib.request.Request(
        base_url + "/v1/consensus", data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(request, timeout=30) as response:
        body = json.loads(response.read().decode())
    return {k: v for k, v in body.items() if k not in TIMING}


def _healthz(base_url):
    with urllib.request.urlopen(base_url + "/healthz", timeout=10) as response:
        return json.loads(response.read().decode())


def _serve(factory, registry, seeds, state_dir=None):
    server = factory(backend="fake", port=0, registry=registry, max_inflight=2,
                     state_dir=None if state_dir is None else str(state_dir)).start()
    try:
        return [_post(server.base_url, _payload(s)) for s in seeds], _healthz(server.base_url)
    finally:
        server.stop(drain=True, timeout=10.0)


def test_state_dir_answers_as_without_and_as_jax(tmp_path):
    seeds = (1, 2, 3)
    durable, health = _serve(create_server, Registry(), seeds, tmp_path / "port")
    plain, plain_health = _serve(create_server, Registry(), seeds)
    ref, ref_health = _serve(jax_create_server, JaxRegistry(), seeds, tmp_path / "jax")
    assert durable == plain == ref
    assert "durability" not in plain_health
    wal, ref_wal = health["durability"]["wal"], ref_health["durability"]["wal"]
    for key in ("unresolved", "replayed", "sealed", "recovered_sealed"):
        assert wal.get(key) == ref_wal.get(key), key
    assert any((tmp_path / "port").iterdir())


def test_port_server_replays_a_crashed_jax_journal(tmp_path):
    seeds = (11, 12, 13)
    journal = JaxWAL(tmp_path, registry=JaxRegistry())
    for seed in seeds:
        request = jax_parse(_payload(seed))
        journal.record_admitted(request.request_id, idempotency_key(request, request.method),
                                dataclasses.asdict(request))
    journal.close()  # unsealed: the crash
    expected, _ = _serve(jax_create_server, JaxRegistry(), seeds)
    server = create_server(backend="fake", port=0, registry=Registry(), max_inflight=2,
                           state_dir=str(tmp_path)).start()
    try:
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            wal = _healthz(server.base_url)["durability"]["wal"]
            if wal["unresolved"] == 0:
                break
            time.sleep(0.05)
        assert wal["replayed"] == len(seeds) and wal["unresolved"] == 0
        for seed, want in zip(seeds, expected):
            got = _post(server.base_url, _payload(seed))
            assert got.pop("idempotent_replay") is True
            got.pop("served_by", None)
            assert got["statement"] == want["statement"]
    finally:
        server.stop(drain=True, timeout=10.0)


def test_durability_smoke_script_reports_ok():
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    out = subprocess.run([sys.executable, "consensus_tpu_torch/scripts/durability_smoke.py"],
                         capture_output=True, text=True, env=env, timeout=120)
    verdict = json.loads(out.stdout)
    assert out.returncode == 0 and verdict["ok"] is True, out.stdout + out.stderr[-2000:]
    assert verdict["replayed"] > 0
    assert (verdict["lost"], verdict["dup"], verdict["mismatches"]) == (0, 0, 0)

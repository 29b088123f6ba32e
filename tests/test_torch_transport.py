"""The port's transport seam (``serve/transport.py``: LoopbackTransport and
FaultyTransport) against the JAX package's.

The same seeded transport FaultPlan (drop, duplicate, reorder, bit_flip,
latency, transient and timeout errors, partition windows) drives the same
call sequence through both packages' wrappers, each over a loopback hub
with the same echo handlers and one injected clock.  Tolerance: exact.
Every call gives the same outcome (the same typed error class name, or the
same response bytes), every handler sees the same deliveries, and the
``faults_injected_total{kind,op}`` series are equal."""

import numpy as np
import pytest

from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu.serve import transport as jax_transport
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.serve import transport

OPS = ("ship", "fetch", "probe")


class _Clock:
    def __init__(self):
        self.now = 50.0

    def __call__(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def _hub(module, delivered):
    hub = module.LoopbackTransport()
    for peer in ("store", "r0", "r1", "r2"):
        def handler(op, peer=peer):
            def run(msg):
                delivered.append((peer, op, bytes(msg.get("data", b""))))
                return {"ok": True, "peer": peer, "data": bytes(msg.get("data", b"")) + b"!"}
            return run
        hub.register(peer, {op: handler(op) for op in OPS})
    return hub


def _run(module, registry_cls, plan, calls):
    clock, delivered = _Clock(), []
    registry = registry_cls()
    wrapped = module.FaultyTransport(_hub(module, delivered), plan, registry=registry,
                                     sleep=clock.sleep, clock=clock)
    outcomes = []
    for src, dst, op, data, advance in calls:
        clock.now += advance
        try:
            response = wrapped.call(src, dst, op, {"data": data})
            outcomes.append(("ok", response["peer"], response["data"]))
        except module.TransportError as exc:
            outcomes.append((type(exc).__name__, str(exc)))
    windows = [(peer, start - wrapped.t0, end - wrapped.t0)
               for peer, start, end in wrapped.partition_windows()]
    return outcomes, delivered, registry.snapshot(), windows


def _calls(seed, n=240):
    rng = np.random.RandomState(seed)
    peers = ("r0", "r1", "r2")
    calls = []
    for _ in range(n):
        src = peers[rng.randint(3)]
        op = OPS[rng.randint(3)]
        data = rng.bytes(int(rng.randint(0, 24)))
        calls.append((src, "store", op, data, float(rng.uniform(0.0, 0.05))))
    return calls


PLANS = {
    "mixed_rates": {"seed": 7, "faults": [
        {"kind": "drop", "op": "ship", "rate": 0.1},
        {"kind": "duplicate", "op": "ship", "rate": 0.1},
        {"kind": "bit_flip", "op": "*", "rate": 0.08},
        {"kind": "reorder", "op": "fetch", "rate": 0.1},
        {"kind": "latency", "op": "probe", "rate": 0.2, "latency_s": 0.01},
        {"kind": "transient_error", "op": "fetch", "rate": 0.05},
        {"kind": "timeout_error", "op": "probe", "rate": 0.05},
    ]},
    "partition_r1": {"seed": 3, "faults": [
        {"kind": "partition", "op": "*", "peer": "r1", "after_s": 2.0, "duration_s": 2.5},
        {"kind": "drop", "op": "fetch", "call_index": 5},
    ]},
    "full_partition_and_backend_kinds": {"seed": 11, "faults": [
        {"kind": "partition", "op": "*", "after_s": 4.0, "duration_s": 1.0},
        {"kind": "device_lost", "op": "*", "rate": 1.0},
        {"kind": "nan_logprobs", "op": "*", "rate": 1.0},
        {"kind": "bit_flip", "op": "fetch", "after_s": 5.5},
    ]},
}


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("seed", [0, 1])
def test_same_seeded_plan_same_injection_sequence(name, seed):
    calls = _calls(seed)
    port = _run(transport, Registry, PLANS[name], calls)
    ref = _run(jax_transport, JaxRegistry, PLANS[name], calls)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    kinds = {o[0] for o in port[0]}
    if name == "mixed_rates":
        assert {"ok", "TransportDropped", "TransportError", "TransportTimeout"} <= kinds
    else:
        assert "TransportPartitioned" in kinds


def test_loopback_errors_and_registration_equal_jax():
    for module in (transport, jax_transport):
        hub = _hub(module, [])
        assert hub.peers() == ["r0", "r1", "r2", "store"]
        hub.unregister("r2")
        assert hub.peers() == ["r0", "r1", "store"]
        with pytest.raises(module.TransportError, match="unknown peer"):
            hub.call("r0", "r9", "ship", {})
        with pytest.raises(module.TransportError, match="no handler"):
            hub.call("r0", "store", "gossip", {})
    assert issubclass(transport.TransportPartitioned, transport.TransportError)
    assert issubclass(transport.TransportDropped, transport.TransportError)

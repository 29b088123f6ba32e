"""The port's burn-rate SLO engine (``obs/slo.py``) against the JAX
package's.

Both engines run under one injected clock (a callable whose time the
test advances) and take the same event stream, made from a seed with numpy:
terminal requests (ok / latency / degraded) and polled ``kv_headroom`` /
``welfare_drift`` signals.  Tolerance: exact.  After every evaluation the
states, burn rates (floats compared with ``==``), transition logs, blackbox
dump reasons and registry series are equal."""

import numpy as np
import pytest

from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu.obs.slo import SLOEngine as JaxSLOEngine
from consensus_tpu.obs.slo import SLOSpec as JaxSLOSpec
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.obs.slo import DEFAULT_SLO_SPECS, SLOEngine, SLOSpec

SPECS = [
    {"name": "availability", "signal": "availability", "objective": 0.99,
     "fast_window_s": 5.0, "slow_window_s": 30.0},
    {"name": "latency_p95", "signal": "latency", "objective": 0.95, "threshold": 0.5,
     "fast_window_s": 5.0, "slow_window_s": 30.0},
    {"name": "degraded_fraction", "signal": "degraded", "objective": 0.8,
     "fast_window_s": 5.0, "slow_window_s": 30.0, "fast_burn_threshold": 3.0},
    {"name": "kv_headroom", "signal": "kv_headroom", "objective": 0.9, "threshold": 0.1,
     "fast_window_s": 5.0, "slow_window_s": 30.0},
    {"name": "welfare_drift", "signal": "welfare_drift", "objective": 0.95,
     "fast_window_s": 5.0, "slow_window_s": 30.0},
]


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _engines(specs, signals):
    clock = _Clock()
    dumps = ([], [])
    port = SLOEngine(specs=specs, registry=Registry(), clock=clock,
                     dump_blackbox=dumps[0].append, signals=signals)
    ref = JaxSLOEngine(specs=specs, registry=JaxRegistry(), clock=clock,
                       dump_blackbox=dumps[1].append, signals=signals)
    return clock, port, ref, dumps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_event_stream_same_transitions_and_burn_rates(seed):
    rng = np.random.RandomState(seed)
    signal_values = {"kv": 0.5, "drift": False}
    signals = {
        "kv_headroom": lambda: signal_values["kv"],
        "welfare_drift": lambda: {"drifted": signal_values["drift"]},
    }
    clock, port, ref, dumps = _engines(SPECS, signals)
    # Three phases: healthy, an incident (errors, slow and degraded
    # responses, KV pressure, drift), then recovery.
    bad_rate = np.concatenate([np.full(60, 0.0), np.full(60, 0.4), np.full(120, 0.0)])
    states_seen = set()
    for step, p in enumerate(bad_rate):
        clock.now += float(rng.uniform(0.05, 0.4))
        ok = bool(rng.uniform() >= p)
        latency = float(rng.exponential(0.8 if p else 0.1))
        degraded = bool(rng.uniform() < p)
        signal_values["kv"] = 0.05 if p and rng.uniform() < 0.5 else 0.5
        signal_values["drift"] = bool(p and rng.uniform() < 0.3)
        for engine in (port, ref):
            engine.record_request(ok=ok, latency_s=latency, degraded=degraded)
        if step % 4 == 0:
            got, want = port.evaluate(), ref.evaluate()
            assert got == want
            assert port.states() == ref.states()
            states_seen.update(port.states().values())
    assert dumps[0] == dumps[1]
    assert port.snapshot() == ref.snapshot()
    # The incident drove at least one objective out of ``ok``.
    assert states_seen - {"ok"}


def test_default_specs_and_spec_round_trip_equal_jax():
    from consensus_tpu.obs.slo import DEFAULT_SLO_SPECS as JAX_DEFAULTS

    assert [s.to_dict() for s in DEFAULT_SLO_SPECS] == [s.to_dict() for s in JAX_DEFAULTS]
    for spec in SPECS:
        assert SLOSpec.from_dict(spec).to_dict() == JaxSLOSpec.from_dict(spec).to_dict()
    with pytest.raises(ValueError):
        SLOSpec(name="x", signal="nope")


def test_registry_series_equal_after_a_violation():
    registries = (Registry(), JaxRegistry())
    clock = _Clock()
    dumps = ([], [])
    port = SLOEngine(specs=SPECS[:1], registry=registries[0], clock=clock,
                     dump_blackbox=dumps[0].append)
    ref = JaxSLOEngine(specs=SPECS[:1], registry=registries[1], clock=clock,
                       dump_blackbox=dumps[1].append)
    for _ in range(40):
        clock.now += 0.1
        for engine in (port, ref):
            engine.record_request(ok=False)
    # One evaluation moves a state machine one step: ok -> burning -> violated.
    for expected in ("burning", "violated"):
        assert port.evaluate() == ref.evaluate()
        assert port.states() == {"availability": expected}
    assert dumps[0] == dumps[1] == ["slo_violated:availability"]
    assert registries[0].snapshot() == registries[1].snapshot()
    assert registries[0].to_prometheus() == registries[1].to_prometheus()

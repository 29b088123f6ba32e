"""CPU tests of the benchmark's data layout, its arithmetic and its imports."""

from __future__ import annotations

import ast
import json
import re
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_port"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import rooflines  # noqa: E402
from bench_port.harness import spec  # noqa: E402
from bench_port.harness.cell import Window  # noqa: E402
from bench_port.harness.trace import Trace, breakdown, kernel_ms_per_launch, union_seconds  # noqa: E402

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_every_data_file_loads():
    for path in sorted((BENCH / "configs").glob("*.json")) + sorted((BENCH / "traffic").glob("*.json")):
        assert isinstance(json.loads(path.read_text()), dict), path
    for path in sorted((BENCH / "limits").glob("*.json")):
        limits = json.loads(path.read_text())
        assert limits["mismatches"] == 0 and all(v >= 0 for v in limits.values()), path
    names = {m["name"] for m in BENCHMARK["per_layer"]}
    assert names == {p.stem for p in (BENCH / "metrics").glob("*.py")}
    for name in names:
        assert callable(spec.load_reader(name).read), name


def test_every_traffic_mix_finds_its_checks():
    from bench_port.harness import check

    mixes = [p for p in sorted((BENCH / "traffic").glob("*.json")) if p.stem != "scenarios"]
    assert mixes
    for path in mixes:
        traffic = json.loads(path.read_text())
        module = check.load_method(traffic["method"])
        assert callable(module.mismatches) and callable(module.compare), path
        assert traffic["warmup"]["statements_per_client"] >= 1, path


def test_cross_entropy_excess():
    import torch

    from bench_port.harness import check

    xent = check.load_method("best_of_n")._xent_excess
    flat = torch.zeros(3, 5)
    assert xent(flat, [0, 4, 2], 1.0) == (pytest.approx(0.0, abs=1e-6), 3)
    peaked = torch.tensor([[4.0, 0.0, 0.0, 0.0, 0.0]] * 2)
    lp = torch.log_softmax(peaked, dim=-1)
    entropy = float(-(lp.exp() * lp).sum(dim=-1)[0])
    total, n = xent(peaked, [1, 0], 1.0)
    assert n == 2 and total == pytest.approx(float(-lp[0, 1] - lp[0, 0]) - 2 * entropy, rel=1e-5)
    # The control's expectation: its own distribution equal to the reference's reads 0.
    assert xent(peaked, [1, 0], 1.0, peaked)[0] == pytest.approx(0.0, abs=1e-5)
    assert xent(peaked, [1, 0], 1.0, flat[:2])[0] > 1.0


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(w["config"] for w in BENCHMARK["workloads"] if w["name"] == name)
    assert {"statements_per_s", "setup_s"} <= {m.name for m in cell.end_to_end}
    assert cell.per_layer and all(m.reader is not None for m in cell.per_layer)
    assert set(cell.traffic["scenarios"]) <= set(spec.scenarios())
    assert "mismatches" in cell.limits


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    per_layer = {m["name"]: m for m in BENCHMARK["per_layer"]}
    for m in BENCHMARK["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}, m
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace"), m
    for m in BENCHMARK["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}, m
        assert m["moves"] in e2e, m
    for m in list(e2e.values()) + list(per_layer.values()):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in BENCHMARK["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200, w
        cell = spec.load_cell(w["name"])
        reported = {m.name for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert per_layer[m.name]["moves"] in reported, (w["name"], m.name)


def _param_count(model):
    return spec.load_reader("mfu").param_count(model)


@pytest.mark.parametrize("entry", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_reckoning(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    model, published = cfg["model"], cfg["published"]
    for key in cfg["reduced"]:
        assert model[key] != published[key]
    assert model["d_model"] == published["hidden_size"]
    assert model["ffn_hidden"] == published["intermediate_size"]
    assert model["n_layers"] == published["num_hidden_layers"]
    assert model["n_heads"] == published["num_attention_heads"]
    assert model["n_kv_heads"] == published["num_key_value_heads"]
    assert model["head_dim"] * model["n_heads"] == published["hidden_size"]
    assert model["rope_theta"] == published["rope_theta"]
    assert model["rms_eps"] == published["rms_norm_eps"]
    reck = cfg["reckoning"]
    assert _param_count(model) == reck["params_as_run"]
    assert _param_count({**model, "vocab_size": published["vocab_size"]}) == reck["params_published"]
    kv = 2 * model["n_layers"] * model["n_kv_heads"] * model["head_dim"] * 2
    assert kv == reck["kv_bytes_per_token_bf16"]
    for key in ("assumed", "deployment"):
        assert cfg[key]


# -- the metric arithmetic ----------------------------------------------------


class _St:
    def __init__(self, ok=True):
        self.ok = ok


def _window(trace=None, **kw):
    base = dict(
        seconds=10.0, statements=[_St(), _St(), _St(False), _St()], registry={}, call_counts={},
        token_counts={}, spans=[], start=100.0, end=110.0, config={"model": {}}, trace=trace,
    )
    base.update(kw)
    return Window(**base)


def _read(name, window):
    return spec.load_reader(name).read(window)


def test_batch_fill_is_the_histograms_mean():
    registry = {
        ("batching_batch_fill_sessions", (("kind", "generate"),)): {"count": 3, "sum": 30.0},
        ("batching_batch_fill_sessions", (("kind", "score_matrix"),)): {"count": 1, "sum": 2.0},
        ("batching_flushes_total", (("kind", "generate"), ("reason", "all_blocked"))): 4,
    }
    assert _read("batch_fill", _window(registry=registry)) == pytest.approx(8.0)
    assert _read("batch_fill", _window()) is None


def test_backend_calls_per_statement():
    counts = {"generate": 12, "score_matrix": 3, "score": 0, "search_advances": 6}
    assert _read("backend_calls_per_statement", _window(call_counts=counts)) == pytest.approx(7.0)


def test_score_s_share_is_the_union_of_score_spans():
    spans = [("score_matrix", 101.0, 103.0), ("score", 102.0, 104.0), ("generate", 104.0, 109.0),
             ("score_matrix", 109.5, 111.0)]
    assert _read("score_s_share", _window(spans=spans)) == pytest.approx(35.0)
    assert _read("score_s_share", _window()) is None


def test_mfu():
    model = {"d_model": 4, "n_heads": 2, "head_dim": 2, "n_kv_heads": 1, "ffn_hidden": 8,
             "n_layers": 2, "use_post_norms": False, "vocab_size": 10, "tie_lm_head": False}
    # attn 4*4*2 + 4*2*2 = 48, ffn 96, norms 8 -> 152 a layer; 304 + 40 + 4 + 40.
    assert _param_count(model) == 388
    window = _window(config={"model": model}, token_counts={"generated": 1000, "scored": 500})
    expected = 100.0 * 2 * 388 * 1500 / 10.0 / 989.4e12
    assert _read("mfu", window) == pytest.approx(expected)


def test_device_trace_readers():
    kernels = [("decode_attention_kernel<128>", 100.0, 100.5), ("gemm", 100.25, 101.0),
               ("flash_fwd_kernel<128>", 103.0, 104.0), ("decode_attention_kernel<128>", 105.0, 105.5)]
    trace = Trace(kernels=kernels, start=100.0, end=110.0, aligned=True)
    registry = {
        ("kernel_launches_total", (("kernel", "decode_attention"),)): 2,
        ("kernel_launches_total", (("kernel", "flash_attention"),)): 1,
    }
    window = _window(trace=trace, registry=registry)
    assert trace.busy_s() == pytest.approx(2.5)
    assert _read("device_idle_share", window) == pytest.approx(75.0)
    assert _read("k2_ms_per_launch", window) == pytest.approx(500.0)
    assert _read("k2_ms_per_launch", _window(trace=trace)) is None
    assert kernel_ms_per_launch(window, "flash_fwd_kernel", "flash_attention") == pytest.approx(1000.0)
    assert _read("device_idle_share", _window()) is None
    spans = [("generate", 100.0, 102.5), ("score_matrix", 103.5, 105.2)]
    out = breakdown(trace, spans)
    assert out["device_ops"][0] == ["decode_attention_kernel<128>", pytest.approx(1.0)]
    idle = dict(out["idle_gaps"])
    assert idle["in generate"] == pytest.approx(2.0)
    assert idle["in score_matrix"] == pytest.approx(1.0)
    assert idle["between backend calls"] == pytest.approx(4.5)


def test_union_seconds():
    assert union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)


# -- rooflines: chip_smoke.py's bound column, reproduced -----------------------


@pytest.mark.parametrize(
    "work, expected",
    [
        # K1 main path: B=32, S=1024, H=32, KV=8, hd=128, 16000 tokens of spans.
        (lambda: rooflines.flash_work(32, 1024, 32, 8, 128, [500] * 32), 0.1388),
        # K2 gemma2-2b classic decode: P=1, R=8, H=8, KV=4, hd=256, W0=1024, Ts=32.
        (lambda: rooflines.decode_work(1, 8, 4, 256, 1024, [0] * 8, [1024 + 31] * 8, 31), 0.0103),
        # K2 llama3-8b classic decode: P=1, R=8, H=32, KV=8, hd=128, W0=1024, Ts=64.
        (lambda: rooflines.decode_work(1, 32, 8, 128, 1024, [0] * 8, [1024 + 63] * 8, 63), 0.0107),
    ],
    ids=["k1_main", "k2_gemma2_2b_classic", "k2_llama3_8b_classic"],
)
def test_rooflines_reproduce_the_bound_column(work, expected):
    ms, by = rooflines.bound_ms(*work())
    assert by == "bytes"
    assert round(ms, 4) == expected
    assert rooflines.roofline_share(*work(), seconds=ms / 1e3 * 2) == pytest.approx(50.0)


# -- imports ------------------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "consensus_tpu"}


def _imported_top_levels(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        found = set(_imported_top_levels(path)) & FORBIDDEN
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        names = set(_imported_top_levels(path))
        assert "consensus_tpu_torch" not in names and not (names & FORBIDDEN), (path, names)


def test_the_whole_name_is_compared():
    # The port's name begins with the JAX package's: only whole names match.
    from bench_port import run

    assert "consensus_tpu_torch".split(".")[0] not in run.FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules.setdefault("consensus_tpu_torch", sys)
        assert "consensus_tpu" not in run.forbidden_modules()
        sys.modules["consensus_tpu.fake"] = sys
        assert "consensus_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)

"""Tests of the benchmark that need the card: the device trace, and a short
run of each traffic mix at a small size through K1 and K2.  They skip on a
machine without CUDA (the check is made inside each test)."""

from __future__ import annotations

import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.harness.cell import run_cell, verdict  # noqa: E402
from bench_port.harness.trace import Tracer  # noqa: E402

# The kernels take head_dim 128 or 256: a small model at a kernel width.
SMALL = {"d_model": 256, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1, "head_dim": 128, "ffn_hidden": 512}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace and the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_sees_kernels_on_the_host_clock(cuda_device):
    tracer = Tracer()
    tracer.start()
    x = torch.randn(2048, 2048, device=cuda_device)
    t_launch = time.perf_counter()
    for _ in range(10):
        x = x @ x
        x = x / x.norm()
    trace = tracer.stop()
    assert trace.aligned
    assert trace.kernels and 0 < trace.busy_s() <= trace.window_s
    first = min(lo for _, lo, _ in trace.kernels)
    assert abs(first - t_launch) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mistral-7b.bon", "deepseek-7b.beam"])
def test_small_run_on_the_card(cuda_device, name):
    from bench_port.tests.test_bench_port_rehearsal import tiny_cell

    cell = tiny_cell(name)
    cell.config["model"].update(SMALL)
    cell.config["backend"]["dtype"] = "bfloat16"
    out = run_cell(cell, 12345, 1.0, True, cuda_device, time.perf_counter())
    judged = verdict(out["readings"], cell.limits, out["failed"])
    assert judged["correct"], judged
    assert out["metrics"].get("k2_ms_per_launch", 0) > 0
    assert out["breakdown"]["device_ops"]

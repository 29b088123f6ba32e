"""Statements/sec scaling of the mesh serving path (PyTorch port of
``consensus_tpu/cli/bench_mesh.py``).

    python -m consensus_tpu_torch.cli.bench_mesh               # the cards present
    python -m consensus_tpu_torch.cli.bench_mesh --device cpu  # four CPU shards

Runs the continuous-batching engine at dp=1 and at dp=4 and prints ONE JSON
object:

* ``mesh_scaling_efficiency`` -- statements/sec at dp=4 over 4x the dp=1
  rate.  Each shard's page pool holds exactly one resident row, so the
  decode cohort runs dp-wide: the capacity the mesh buys.  On the card
  dp=4 runs over ``cuda:0-3`` (the cards present taken in turn when there
  are fewer than four; ``distinct_devices`` says how many) and dp=1 on
  ``cuda:0``.  One host thread drives the engine, so host-bound decode
  loops cap the gain.
* ``texts_match_dp`` -- dp=1 and dp=4 statements are identical.
* ``dp1_byte_identical_to_engine`` -- the dp=1/tp=1 mesh path returns the
  exact bytes of the plain single-device engine path.

On the card the model is llama3-8b (int8, random weights from the seed);
``--device cpu`` takes tiny-gemma2, as the JAX package's cell does.

``--trace DIR`` adds ``trace`` to the object: one dispatch
at dp=4 (one row a shard) and one at dp=1 (one row), each after a warm-up:
its wall untraced at the interpreter's default switch interval and at
0.1 ms, with the host CPU time the process spent (all threads) and the
busiest threads' share of it; then under ``torch.profiler`` its wall, each
card's busy time (the union of its kernel intervals) and idle share, and
the host calls that wait on the card.  The profiler's operator table goes
to ``DIR/<width>_ops.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import torch

from consensus_tpu_torch.backends.base import GenerationRequest
from consensus_tpu_torch.backends.batching import BatchingBackend
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.parallel.mesh import make_mesh

SLOTS = 8
PAGE_SIZE = 16
DP_WIDE = 4


def _requests(n: int, max_tokens: int):
    return [
        GenerationRequest(
            user_prompt=f"Draft a one-line consensus statement on issue {i}.",
            max_tokens=max_tokens, temperature=0.8, seed=100 + i, chat=False,
        )
        for i in range(n)
    ]


def _batching(backend, mesh, num_pages):
    return BatchingBackend(
        backend, registry=Registry(), engine=True,
        engine_options={
            "slots": SLOTS, "page_size": PAGE_SIZE, "num_pages": num_pages,
            **({"mesh": mesh} if mesh is not None else {}),
        },
    )


def _drive(batching, requests):
    """The requests one per session through the engine -> their texts."""
    with ThreadPoolExecutor(max_workers=len(requests)) as pool:
        futures = [pool.submit(batching.generate, [r]) for r in requests]
        return [f.result()[0].text for f in futures]


def _run_engine(backend, mesh, num_pages, requests, trials):
    """Drive the requests one per session through the engine; returns
    (texts, min wall over the trials, generate dispatches of that trial)."""
    batching = _batching(backend, mesh, num_pages)

    def drive():
        return _drive(batching, requests)

    try:
        drive()  # warm-up: first launches, the kernels' build, allocator growth
        wall, texts, dispatches = None, None, None
        for _ in range(trials):
            before = batching.engine.dispatch_counts["generate"]
            start = time.perf_counter()
            trial_texts = drive()
            trial_wall = time.perf_counter() - start
            if wall is None or trial_wall < wall:
                wall, texts = trial_wall, trial_texts
                dispatches = batching.engine.dispatch_counts["generate"] - before
            if trial_texts != texts:
                raise RuntimeError("engine texts changed between trials")
    finally:
        batching.close()
    return texts, wall, dispatches


#: Host calls that wait on the card (or copy to the host, which waits).
_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
          "cudaMemcpy", "cudaMemcpyAsync")


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def _cpu_seconds() -> Tuple[float, Dict[str, float]]:
    """(this process's CPU seconds, {thread id: its CPU seconds}) from
    ``/proc``: user + system time."""
    tick = os.sysconf("SC_CLK_TCK")

    def read(stat: pathlib.Path) -> float:
        fields = stat.read_text().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / tick

    threads = {}
    for task in pathlib.Path("/proc/self/task").iterdir():
        try:
            threads[task.name] = read(task / "stat")
        except OSError:  # the thread ended
            continue
    return read(pathlib.Path("/proc/self/stat")), threads


def _sync_all() -> None:
    for index in range(torch.cuda.device_count()):
        torch.cuda.synchronize(index)


def _trace(backend, mesh, num_pages, requests, out_dir: pathlib.Path, tag: str) -> Dict:
    """One engine dispatch of ``requests`` (after a warm-up): untraced walls
    at two switch intervals, then the profiled one (module docstring)."""
    batching = _batching(backend, mesh, num_pages)
    default_interval = sys.getswitchinterval()
    walls = {}
    try:
        _drive(batching, requests)
        for interval in (default_interval, 1e-4):
            sys.setswitchinterval(interval)
            _sync_all()
            cpu0, threads0 = _cpu_seconds()
            start = time.perf_counter()
            _drive(batching, requests)
            _sync_all()
            wall = time.perf_counter() - start
            cpu1, threads1 = _cpu_seconds()
            busiest = sorted((threads1[t] - threads0.get(t, 0.0) for t in threads1), reverse=True)
            walls["default_switch" if interval == default_interval else "short_switch"] = {
                "switch_interval_s": interval, "wall_s": wall, "host_cpu_s": cpu1 - cpu0,
                "host_cores_busy": (cpu1 - cpu0) / wall,
                "busiest_threads_cpu_s": busiest[:6],
            }
        sys.setswitchinterval(default_interval)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        _sync_all()
        with torch.profiler.profile(activities=activities) as prof:
            start = time.perf_counter()
            _drive(batching, requests)
            _sync_all()
            wall_ms = (time.perf_counter() - start) * 1e3
    finally:
        sys.setswitchinterval(default_interval)
        batching.close()
    kernels: Dict[int, List[Tuple[float, float]]] = {}
    waits: Dict[str, Dict[str, float]] = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(event.device_index, []).append(
                (event.time_range.start, event.time_range.end))
            continue
        if event.name in _WAITS:
            entry = waits.setdefault(event.name, {"calls": 0, "ms": 0.0})
            entry["calls"] += 1
            entry["ms"] += event.cpu_time_total / 1e3
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}_ops.txt").write_text(
        prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
    busy = {f"cuda:{i}": _union(v) / 1e3 for i, v in sorted(kernels.items())}
    return {
        "rows": len(requests), **walls,
        "traced_wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": {d: 1.0 - ms / wall_ms for d, ms in busy.items()},
        "kernels": {f"cuda:{i}": len(v) for i, v in sorted(kernels.items())},
        "host_waits": waits,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="'cpu' for four CPU shards")
    parser.add_argument("--model", default=None,
                        help="default llama3-8b on the card, tiny-gemma2 on the CPU")
    parser.add_argument("--requests", type=int, default=int(os.environ.get("BENCH_MESH_REQUESTS", "16")))
    parser.add_argument("--tokens", type=int, default=int(os.environ.get("BENCH_MESH_TOKENS", "8")))
    parser.add_argument("--trials", type=int, default=int(os.environ.get("BENCH_MESH_TRIALS", "3")))
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="profile one dispatch at each width")
    args = parser.parse_args(argv)

    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("bench_mesh: no CUDA device; pass --device cpu for CPU shards")
    model = args.model or ("tiny-gemma2" if cpu else "llama3-8b")
    options = dict(model=model, max_context=256)
    if cpu:
        options.update(device="cpu", dtype="float32")
        wide_devices = ["cpu"] * DP_WIDE
    else:
        options.update(device="cuda:0", dtype="bfloat16", quantization="int8")
        n_cards = torch.cuda.device_count()
        wide_devices = [f"cuda:{i % n_cards}" for i in range(DP_WIDE)]
    requests = _requests(args.requests, args.tokens)
    base = TorchBackend(**options)
    # Per-shard pools of exactly ONE resident row: capacity, and with it the
    # decode cohort's width, scales 1:1 with dp.
    prompt_tokens = max(len(base.tokenizer.encode(r.user_prompt)) for r in requests)
    num_pages = -(-(prompt_tokens + args.tokens) // PAGE_SIZE)

    plain_texts, _, _ = _run_engine(base, None, num_pages, requests, 1)
    dp1_texts, dp1_wall, dp1_disp = _run_engine(
        base, {"dp": 1, "tp": 1}, num_pages, requests, args.trials
    )
    plan = make_mesh(wide_devices, tp=1, dp=DP_WIDE)
    options.pop("device")
    wide = TorchBackend(**options, mesh=plan, params=base.params, config=base.config)
    dp4_texts, dp4_wall, dp4_disp = _run_engine(wide, None, num_pages, requests, args.trials)

    trace = None
    if args.trace:
        out_dir = pathlib.Path(args.trace)
        trace = {
            "dp4": _trace(wide, None, num_pages, requests[:DP_WIDE], out_dir, "dp4"),
            "dp1": _trace(base, {"dp": 1, "tp": 1}, num_pages, requests[:1], out_dir, "dp1"),
        }

    sps1 = len(requests) / dp1_wall
    sps4 = len(requests) / dp4_wall
    print(json.dumps({
        "bench_mesh": {
            "model": model,
            "device": "cpu" if cpu else torch.cuda.get_device_name(0),
            "devices": [str(d) for d in plan.data_devices],
            "distinct_devices": plan.distinct_devices,
            "requests": len(requests),
            "max_tokens": args.tokens,
            "trials": args.trials,
            "kv_pages_per_shard": num_pages,
            "dp1_statements_per_sec": sps1,
            "dp4_statements_per_sec": sps4,
            "dp1_wall_s": dp1_wall,
            "dp4_wall_s": dp4_wall,
            "dp1_generate_dispatches": dp1_disp,
            "dp4_generate_dispatches": dp4_disp,
            "mesh_scaling_efficiency": sps4 / (DP_WIDE * sps1),
            "texts_match_dp": dp1_texts == dp4_texts,
            "dp1_byte_identical_to_engine": dp1_texts == plain_texts,
            "note": (
                "efficiency = sps(dp=4) / (4 * sps(dp=1)), min wall over "
                f"{args.trials} trials per width; per-shard pools hold one "
                "row, so the decode cohort is dp-wide"
            ),
            **({"trace": trace} if trace is not None else {}),
        }
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Run one cell of the port's benchmark once and print its result.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, and with ``--trace 1``
``breakdown``); the last lines of standard error give each number compared
for ``correct`` beside its limit.  With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Top-level modules that no process of this benchmark may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "consensus_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _environment() -> None:
    """Build caches at fixed paths inside the checkout; no JAX through a
    library's optional back end."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()

    import torch

    from bench_port.harness import spec
    from bench_port.harness.cell import run_cell, verdict

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, PROCESS_START)

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3

    judged = verdict(out["readings"], cell.limits, out["failed"])
    units = {m.name: m.unit for m in cell.end_to_end + cell.per_layer}
    device_info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": cell.chips,
        "memory_peak_bytes": int(out["peak"]),
    }
    window = out["window"]
    if args.trace:
        device_info["busy_s"] = window.trace.busy_s()
        device_info["window_s"] = window.trace.window_s
    print(f"card: {_power_limit()}", file=sys.stderr)
    print(f"readings: {json.dumps(out['readings'])}", file=sys.stderr)
    for name, c in judged["compared"].items():
        print(f"compared {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    result = {
        "correct": judged["correct"],
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in out["metrics"].items()},
        "device": device_info,
    }
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["compared"] = judged["compared"]
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

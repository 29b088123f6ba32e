#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, one
JSON line each; any failure exits non-zero:

1. ``device``  -- the card (nvidia-smi name and power limit), torch and CUDA.
2. ``build``   -- every hand-written kernel built from ``consensus_tpu_torch/csrc``
   with nvcc, one process per source, all started together.
3. ``kernels`` -- each kernel against its plain PyTorch version on the card,
   case by case, with kernel / plain / library (SDPA) / bound times.
   ``mutant`` -- the same comparison must catch a deliberately broken build
   of the kernel (one middle key tile skipped).
4. ``main_path`` -- the package's llama3-8b config (full width, random
   weights, bf16 + int8) through ``consensus_tpu_torch.experiment.Experiment``:
   best_of_n, zero_shot and predefined to a results.csv, with every kernel
   launch count zeroed just before and read just after.

Then a ``{"kernels": [...]}`` summary line (times at the shapes the main
path gave each kernel), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
#: H100 SXM data-sheet peaks (dense): bf16 tensor-core rate and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: Kernel vs plain version, elementwise: |kernel - plain| <= ATOL + RTOL*|plain|.
#: RTOL covers the bf16 output rounding (2^-8 relative); ATOL the bf16 P of
#: the P.V product, up to 2^-8 * sum_j (p_j/l)|v_j| absolute, which does not
#: shrink with the output (a few-key row whose terms cancel).  On the H100
#: these inputs need ATOL 0.0032 at most; the mutant check below shows the
#: comparison still catches one lost key tile.
ATOL, RTOL = 5e-3, 1e-2
CONFIG = "consensus_tpu_torch/configs/llama3_8b_best_of_n.yaml"
OUT_DIR = ROOT / "results" / "chip_smoke"


def emit(payload) -> None:
    print(json.dumps(payload), flush=True)


def fail(message: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- flash attention ----------------------------------------------------------


def attention_pairs(lengths, seq, causal, window) -> int:
    """(query, key) pairs the masks keep, from this run's lengths."""
    total = 0
    for length in lengths:
        for i in range(length):
            keys = (i + 1) if causal else length
            if window is not None:
                keys = min(keys, window)
            total += keys
    return total


def flash_bound(q, k, lengths, causal=True, window=None):
    """(bound_ms, bound_by) of one launch: the bytes the function needs --
    o written in full, q, k and v read over each row's span only (outside
    it the output is 0), lengths and starts -- over the HBM rate, against
    4*hd FLOPs (Q.K and P.V) per kept (query, key, head) over the bf16
    tensor-core rate."""
    batch, seq, heads, hd = q.shape
    kv_heads = k.shape[2]
    span_tokens = sum(lengths)
    nbytes = (
        batch * seq * heads * hd * q.element_size()
        + span_tokens * (heads + 2 * kv_heads) * hd * q.element_size()
        + 8 * batch
    )
    ops = 4 * hd * heads * attention_pairs(lengths, seq, causal, window)
    mem_ms = nbytes / PEAK_HBM_BYTES * 1e3
    op_ms = ops / PEAK_BF16_FLOPS * 1e3
    return (op_ms, "operations") if op_ms >= mem_ms else (mem_ms, "bytes")


def flash_inputs(batch, seq, heads, kv_heads, hd, lengths, starts, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(batch, seq, heads, hd, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(batch, seq, kv_heads, hd, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(batch, seq, kv_heads, hd, generator=g, device="cuda").to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sts = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return q, k, v, lens, sts


def sdpa_call(q, k, v, lens, sts, scale, window):
    """The library yardstick: one scaled_dot_product_attention call with
    the same span/causal/window mask (softcap has no SDPA counterpart)."""
    import torch
    import torch.nn.functional as F

    seq = q.shape[1]
    pos = torch.arange(seq, device="cuda")
    valid = (pos[None] >= sts[:, None]) & (pos[None] < (sts + lens)[:, None])
    mask = valid[:, None, :, None] & valid[:, None, None, :] & (pos[None, :] <= pos[:, None])
    if window is not None:
        mask = mask & ((pos[:, None] - pos[None, :]) < window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True
    )


def compare(out, plain):
    """(within tolerance and finite, max abs error, the least atol that
    would pass with RTOL kept)."""
    import torch

    diff = (out.float() - plain.float()).abs()
    excess = diff - RTOL * plain.float().abs()
    within = bool((excess <= ATOL).all().item()) and bool(torch.isfinite(out).all().item())
    return within, diff.max().item(), max(0.0, excess.max().item())


def flash_case(name, batch, seq, heads, kv_heads, hd, lengths, starts, seed,
               scale=None, softcap=None, window=None):
    import torch
    from consensus_tpu_torch.ops import flash_attention as fa

    q, k, v, lens, sts = flash_inputs(batch, seq, heads, kv_heads, hd, lengths, starts, seed)
    kw = dict(scale=scale, softcap=softcap, window=window)
    before = fa.launches.count
    out = fa.flash_attention(q, k, v, lens, sts, **kw)
    torch.cuda.synchronize()
    launched = fa.launches.count - before
    plain = fa.flash_attention_reference(q, k, v, lens, sts, **kw)
    within, max_err, atol_needed = compare(out, plain)
    row = {
        "case": name, "shape": [batch, seq, heads, kv_heads, hd],
        "softcap": softcap, "window": window,
        "max_abs_err": max_err, "atol_needed": atol_needed,
        "tolerance": f"atol {ATOL} + rtol {RTOL}",
        "ok": within and launched == 1, "launches": launched,
    }
    eff_scale = scale if scale is not None else hd ** -0.5
    row["kernel_ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, lens, sts, **kw), reps=20)
    row["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_reference(q, k, v, lens, sts, **kw), reps=3, warmup=1
    )
    row["library_ms"] = cuda_ms(sdpa_call(q, k, v, lens, sts, eff_scale, window), reps=10)
    row["bound_ms"], row["bound_by"] = flash_bound(q, k, lengths, True, window)
    del q, k, v, out, plain
    torch.cuda.empty_cache()
    return row


def ragged(rng, batch, seq, low):
    """A quarter of the rows full, the rest uniform in [low, seq]."""
    return [seq] * (batch // 4) + [int(x) for x in rng.integers(low, seq + 1, batch - batch // 4)]


def kernel_cases():
    import numpy as np

    rng = np.random.default_rng(0)
    rows = []
    s = 768
    lens = ragged(rng, 32, s, s // 4)
    rows.append(flash_case("llama3-8b scoring, ragged right-padded", 32, s, 32, 8, 128,
                           lens, [0] * 32, seed=1))
    lens = ragged(rng, 8, s, 16)
    rows.append(flash_case("llama3-8b, left-padded starts", 8, s, 32, 8, 128,
                           lens, [s - n for n in lens], seed=2))
    s = 1024
    lens = ragged(rng, 8, s, s // 4)
    for window in (256, None):
        rows.append(flash_case(
            f"gemma2-9b, softcap 50, window {window}", 8, s, 16, 8, 256, lens, [0] * 8,
            seed=3, scale=224 ** -0.5, softcap=50.0, window=window,
        ))
    rows.append(flash_case("S=700 not a tile multiple, one row of length 0", 4, 700, 32, 8, 128,
                           [700, 0, 350, 1], [0, 0, 0, 699], seed=4))
    return rows


#: The broken build: skip key tile 4 (keys 256-319) of every query tile
#: whose keys reach past 512, inserted at the top of the kernel's k loop.
MUTANT_LOOP = "for (int k0 = (k_lo / BLOCK_K) * BLOCK_K; k0 < k_hi; k0 += BLOCK_K) {"
MUTANT_SKIP = "\n      if (k0 == 4 * BLOCK_K && k_hi > 8 * BLOCK_K) continue;"


def mutant_check():
    """Build the kernel with one middle key tile skipped and hold it against
    the plain version exactly as the real kernel is held: the comparison
    must fail, or the tolerance is too loose to catch a lost tile."""
    import ctypes

    import numpy as np
    import torch
    from consensus_tpu_torch.ops import build
    from consensus_tpu_torch.ops import flash_attention as fa

    source = (build.CSRC_DIR / "flash_attention.cu").read_text()
    if source.count(MUTANT_LOOP) != 1:
        fail("mutant: the kernel's k loop header is not where chip_smoke.py expects it")
    mutant = build.BUILD_DIR / "mutant" / "flash_attention_skip_tile.cu"
    mutant.parent.mkdir(parents=True, exist_ok=True)
    mutant.write_text(source.replace(MUTANT_LOOP, MUTANT_LOOP + MUTANT_SKIP))
    t0 = time.perf_counter()
    library = mutant.with_suffix(".so")
    build.compile_library(mutant, library)
    build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(library))

    s = 768
    lens = ragged(np.random.default_rng(0), 32, s, s // 4)
    q, k, v, lengths, starts = flash_inputs(32, s, 32, 8, 128, lens, [0] * 32, seed=1)
    out = torch.empty_like(q)
    fa.launch_kernel(lib, q, k, v, out, lengths, starts, 128 ** -0.5, None, None, True)
    plain = fa.flash_attention_reference(q, k, v, lengths, starts)
    within, max_err, atol_needed = compare(out, plain)
    del q, k, v, out, plain
    torch.cuda.empty_cache()
    return {
        "phase": "mutant", "mutation": "skip key tile 4 (keys 256-319) where keys reach past 512",
        "shape": [32, s, 32, 8, 128], "build_s": build_s, "max_abs_err": max_err,
        "atol_needed": atol_needed, "tolerance": f"atol {ATOL} + rtol {RTOL}",
        "caught": not within, "ok": not within,
    }


# -- main path ----------------------------------------------------------------

#: Flash path vs plain attention path on the same bf16 model, per scored
#: cell's mean logprob (the best-of-N utility): bf16 rounds at other places
#: in the two paths (P before P.V, the attention output) across 32 layers.
UTILITY_ATOL = 5e-2


def plain_attention_check(backend):
    """Score a few short cells through the kernel and through the einsum
    attention path (the same model with ``use_flash_attention`` off): the
    reference on a small input.  Returns (max |utility diff|, max |logprob
    diff|, kernel launches)."""
    import dataclasses

    from consensus_tpu_torch.backends.base import ScoreRequest
    from consensus_tpu_torch.ops import flash_attention as fa

    requests = [
        ScoreRequest(context=f"Agent {i}: opinion number {i} on the issue.",
                     continuation="We agree to keep talking." * (i + 1))
        for i in range(4)
    ]
    score = type(backend).score  # the unwrapped method: these calls are not timed
    before = fa.launches.count
    kernel = score(backend, requests)
    launched = fa.launches.count - before
    flash_config = backend.config
    backend.config = dataclasses.replace(flash_config, use_flash_attention=False)
    try:
        plain = score(backend, requests)
    finally:
        backend.config = flash_config
    utility_err = max(abs(a.mean() - b.mean()) for a, b in zip(kernel, plain))
    token_err = max(
        max(abs(x - y) for x, y in zip(a.logprobs, b.logprobs)) for a, b in zip(kernel, plain)
    )
    return utility_err, token_err, launched


def main_path():
    import numpy as np
    import pandas as pd
    import torch
    import yaml

    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.experiment import Experiment
    from consensus_tpu_torch.ops import flash_attention as fa

    config = yaml.safe_load((ROOT / CONFIG).read_text())
    config["output_dir"] = str(OUT_DIR)
    started = time.perf_counter()
    backend = TorchBackend(**config["backend_options"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - started

    timers = {"generate": 0.0, "score": 0.0}
    scored = []

    def timed(kind, fn):
        def call(requests):
            t0 = time.perf_counter()
            out = fn(requests)
            torch.cuda.synchronize()
            timers[kind] += time.perf_counter() - t0
            if kind == "score":
                scored.extend(out)
            return out
        return call

    backend.generate = timed("generate", backend.generate)
    backend.score = timed("score", backend.score)
    torch.cuda.reset_peak_memory_stats()

    fa.launches.reset()
    t0 = time.perf_counter()
    experiment = Experiment(config, backend=backend)
    frame = experiment.run()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches.count}
    main_shapes = fa.launches.last_shapes
    main_spans = (
        None if fa.launches.last_spans is None
        else tuple(t.tolist() for t in fa.launches.last_spans)
    )

    on_disk = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    methods = config["methods_to_run"]
    n_layers = backend.config.n_layers
    batches = backend.call_counts["score_batches"]
    tokens = dict(backend.token_counts)  # before the check below scores more
    utilities = np.array([r.mean(default=float("nan")) for r in scored], dtype=np.float64)
    checks = {
        "one_row_per_method": list(on_disk["method"]) == methods,
        "no_errors": bool((on_disk["error_message"] == "").all()),
        "statements_non_empty": bool(on_disk["statement"].astype(str).str.len().gt(0).all()),
        "utility_matrix_finite": utilities.size > 0 and bool(np.isfinite(utilities).all()),
        "flash_launches_eq_layers_x_score_batches": launches["flash_attention"] == n_layers * batches > 0,
    }
    utility_err, token_err, check_launches = plain_attention_check(backend)
    checks["utilities_match_plain_attention"] = (
        utility_err <= UTILITY_ATOL and check_launches == n_layers
    )
    row = {
        "phase": "main_path", "model": backend.config.name, "d_model": backend.config.d_model,
        "n_layers": n_layers, "vocab": backend.config.vocab_size, "dtype": "bfloat16",
        "quantization": backend.quantization, "methods": methods,
        "init_s": init_s, "experiment_s": wall, "generate_s": timers["generate"],
        "score_s": timers["score"], "statements_per_s": len(frame) / wall,
        "score_batches": batches, "score_cells": len(scored),
        "tokens": tokens, "launches": launches,
        "flash_shapes": main_shapes,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "results_csv": str(experiment.run_dir.relative_to(ROOT) / "results.csv"),
        "plain_attention_check": {
            "cells": 4, "max_utility_err": utility_err, "max_logprob_err": token_err,
            "tolerance": f"utility atol {UTILITY_ATOL}",
        },
        "checks": checks, "ok": all(checks.values()),
    }
    del backend, experiment
    torch.cuda.empty_cache()
    return row, launches, main_shapes, main_spans


def summary_flash(launches, main_shapes, main_spans, max_err):
    """Time the kernel at the (q, k) shapes and the row spans of the main
    path's last launch, on random q, k, v."""
    (batch, seq, heads, hd), (_, _, kv_heads, _) = main_shapes
    lens, starts = main_spans
    row = flash_case("main-path shape and spans", batch, seq, heads, kv_heads, hd,
                     lens, starts, seed=5)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "consensus_tpu_torch/csrc/flash_attention.cu",
        "replaces": "consensus_tpu/ops/flash_attention.py:181",
        "launches": launches["flash_attention"],
        "max_abs_err": max(max_err, row["max_abs_err"]),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": row["shape"],
        "span_tokens": sum(lens),
    }, row["ok"]


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        fail(f"torch is not importable: {exc}", 2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU", 2)
    if not (ROOT / "consensus_tpu_torch" / "csrc").is_dir():
        fail(f"no consensus_tpu_torch package beside {__file__}: run from a repository checkout", 3)
    sys.path.insert(0, str(ROOT))
    from consensus_tpu_torch.ops import build

    smi = nvidia_smi_line()
    emit({
        "phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
    })

    t0 = time.perf_counter()
    log = build.build("flash_attention")
    emit({
        "phase": "build", "kernels": ["flash_attention"], "seconds": time.perf_counter() - t0,
        "ptxas": [line for line in log.splitlines() if "registers" in line or "spill" in line],
    })

    cases = kernel_cases()
    mutant = mutant_check()
    kernels_ok = all(c["ok"] for c in cases)
    emit({"phase": "kernels", "flash_attention": cases, "ok": kernels_ok})
    emit(mutant)

    main_row, launches, main_shapes, main_spans = main_path()
    emit(main_row)
    if main_shapes is None:
        fail("the main path launched no flash-attention kernel")

    entry, summary_ok = summary_flash(
        launches, main_shapes, main_spans, max(c["max_abs_err"] for c in cases)
    )
    emit({"kernels": [entry]})
    print(smi, flush=True)
    if not (kernels_ok and mutant["ok"] and main_row["ok"] and summary_ok):
        fail("a phase failed (see its JSON line)")
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())

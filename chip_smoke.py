#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, one
JSON line each; any failure exits non-zero:

1. ``device``  -- the card (nvidia-smi name and power limit), torch and CUDA.
2. ``build``   -- every hand-written kernel (flash_attention, decode_attention)
   built from ``consensus_tpu_torch/csrc`` with nvcc, one nvcc process per
   source, started together from threads.
3. ``kernels`` -- each kernel against its plain PyTorch version on the card,
   case by case, with kernel / plain / library (SDPA) / bound times and the
   least atol each case needed.  Two ``mutant`` lines follow: the same
   comparison must catch a deliberately broken build of each kernel
   (flash_attention with one middle key tile skipped; decode_attention with
   every tail row reading the neighbouring slot's tail).
4. ``main_path`` -- the best-of-N config (llama3-8b at full width, random
   weights, bf16 + int8) through ``consensus_tpu_torch.experiment.Experiment``:
   best_of_n, zero_shot and predefined to a results.csv, with every kernel
   launch count zeroed just before and read just after; its scoring goes
   through flash_attention.
5. ``token_search_path`` -- the token-search config (same model, with
   ``use_decode_attention``) through ``Experiment``: beam_search and
   finite_lookahead to a results.csv, counts zeroed just before and read
   just after; every search step goes through decode_attention.  Then the
   kernel route of a few search steps is held against the einsum route of
   the same bf16 model.

Then a ``{"kernels": [...]}`` summary line (each kernel timed at the shapes
and spans its path gave it), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
TOKEN_SEARCH_CONFIG = "consensus_tpu_torch/configs/llama3_8b_token_search.yaml"
OUT_DIR = ROOT / "results" / "chip_smoke"
KERNELS = ("flash_attention", "decode_attention")


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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed between two events, so that the host's launch
    overhead (larger than a microsecond-scale kernel) does not enter."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_mutant(name: str, line: str, replacement: str):
    """Build ``csrc/<name>.cu`` with ``line`` replaced -> (loaded library,
    build seconds)."""
    import ctypes

    from consensus_tpu_torch.ops import build

    source = (build.CSRC_DIR / f"{name}.cu").read_text()
    if source.count(line) != 1:
        fail(f"mutant: the line {line!r} is not where chip_smoke.py expects it in {name}.cu")
    mutant = build.BUILD_DIR / "mutant" / f"{name}_mutant.cu"
    mutant.parent.mkdir(parents=True, exist_ok=True)
    mutant.write_text(source.replace(line, replacement))
    t0 = time.perf_counter()
    library = mutant.with_suffix(".so")
    build.compile_library(mutant, library)
    return ctypes.CDLL(str(library)), time.perf_counter() - t0


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
    import numpy as np
    import torch
    from consensus_tpu_torch.ops import flash_attention as fa

    lib, build_s = build_mutant("flash_attention", MUTANT_LOOP, MUTANT_LOOP + MUTANT_SKIP)
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
        "phase": "mutant", "kernel": "flash_attention",
        "mutation": "skip key tile 4 (keys 256-319) where keys reach past 512",
        "shape": [32, s, 32, 8, 128], "build_s": build_s, "max_abs_err": max_err,
        "atol_needed": atol_needed, "tolerance": f"atol {ATOL} + rtol {RTOL}",
        "caught": not within, "ok": not within,
    }


# -- decode attention ---------------------------------------------------------


def decode_keys(w0, starts, qpos, write_col, window):
    """(trunk keys per role, tail keys per row) the masks keep, from this
    run's spans."""
    trunk = []
    for start, pos in zip(starts, qpos):
        lo = start if window is None else max(start, pos + start - window + 1)
        trunk.append(max(0, w0 - lo))
    tail_lo = 0 if window is None else max(0, write_col - window + 1)
    return trunk, write_col + 1 - tail_lo


def decode_bound(n_slots, heads, kv, hd, w0, starts, qpos, write_col, window):
    """(bound_ms, bound_by) of one launch: the bytes the function needs -- q
    and out once, each role's trunk K/V over its kept span once (shared by
    the slots), each row's tail K/V over its kept columns, starts and qpos
    -- over the HBM rate, against 4*hd FLOPs (Q.K and P.V) per kept (row,
    head, key) over the bf16 tensor-core rate."""
    trunk, tail = decode_keys(w0, starts, qpos, write_col, window)
    n_roles = len(starts)
    rows = n_slots * n_roles
    nbytes = 2 * (
        2 * rows * heads * hd + 2 * sum(trunk) * kv * hd + 2 * rows * tail * kv * hd
    ) + 8 * n_roles
    ops = 4 * hd * heads * n_slots * (sum(trunk) + n_roles * tail)
    mem_ms = nbytes / PEAK_HBM_BYTES * 1e3
    op_ms = ops / PEAK_BF16_FLOPS * 1e3
    return (op_ms, "operations") if op_ms >= mem_ms else (mem_ms, "bytes")


def decode_inputs(n_slots, n_roles, heads, kv, hd, w0, ts, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = n_slots * n_roles

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    return (randn(rows, heads, hd), randn(n_roles, w0, kv, hd), randn(n_roles, w0, kv, hd),
            randn(rows, ts, kv, hd), randn(rows, ts, kv, hd))


def decode_sdpa_call(q, tk, tv, lk, lv, starts, qpos, write_col, n_slots, n_roles, scale,
                     window):
    """The library yardstick: one scaled_dot_product_attention call over
    per-row keys [trunk of the row's role | the row's tail], materialised
    here, outside the timed call, with the same boolean mask.  It reads the
    trunk once per slot (softcap has no SDPA counterpart)."""
    import torch
    import torch.nn.functional as F
    from consensus_tpu_torch.ops import decode_attention as da

    rows, w0, ts = q.shape[0], tk.shape[1], lk.shape[1]
    role = torch.arange(rows, device="cuda") % n_roles
    keys = torch.cat([tk[role], lk], dim=1).transpose(1, 2).contiguous()
    values = torch.cat([tv[role], lv], dim=1).transpose(1, 2).contiguous()
    trunk_ok, tail_ok = da._masks(starts, qpos, write_col, w0, ts, window, q.device)
    mask = torch.cat([trunk_ok[role], tail_ok.expand(rows, ts)], dim=-1)[:, None, None, :]
    qt = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        qt, keys, values, attn_mask=mask, scale=scale, enable_gqa=True
    )


def decode_case(name, n_slots, n_roles, heads, kv, hd, w0, ts, starts, write_col, seed,
                qpos=None, scale=None, softcap=None, window=None):
    """One case of decode_attention against its plain version; qpos
    defaults to where a left-padded trunk puts tail column write_col."""
    import torch
    from consensus_tpu_torch.ops import decode_attention as da

    q, tk, tv, lk, lv = decode_inputs(n_slots, n_roles, heads, kv, hd, w0, ts, seed)
    if qpos is None:
        qpos = [w0 - start + write_col for start in starts]
    sts = torch.tensor(starts, dtype=torch.int32, device="cuda")
    qps = torch.tensor(qpos, dtype=torch.int32, device="cuda")
    scale = scale if scale is not None else hd ** -0.5
    args = (q, tk, tv, lk, lv, sts, qps, write_col, n_slots, n_roles)
    kw = dict(scale=scale, softcap=softcap, window=window)
    before = da.launches.count
    out = da.decode_attention(*args, **kw)
    torch.cuda.synchronize()
    launched = da.launches.count - before
    plain = da.decode_attention_reference(*args, **kw)
    within, max_err, atol_needed = compare(out, plain)
    row = {
        "case": name, "shape": [n_slots, n_roles, heads, kv, hd, w0, ts],
        "write_col": write_col, "starts": list(starts), "softcap": softcap, "window": window,
        "max_abs_err": max_err, "atol_needed": atol_needed,
        "tolerance": f"atol {ATOL} + rtol {RTOL}",
        "ok": within and launched == 1, "launches": launched,
    }
    row["kernel_ms"] = graph_ms(lambda: da.decode_attention(*args, **kw), reps=200)
    row["plain_ms"] = cuda_ms(lambda: da.decode_attention_reference(*args, **kw), reps=10)
    row["library_ms"] = graph_ms(
        decode_sdpa_call(q, tk, tv, lk, lv, sts, qps, write_col, n_slots, n_roles, scale, window),
        reps=50,
    )
    row["bound_ms"], row["bound_by"] = decode_bound(
        n_slots, heads, kv, hd, w0, starts, qpos, write_col, window
    )
    del q, tk, tv, lk, lv, out, plain
    torch.cuda.empty_cache()
    return row


#: Trunk starts of the llama3-8b cases: a reference prompt cut to the
#: 824-column prefix budget and five shorter agent prompts, in W0=1024.
DECODE_STARTS = [200, 560, 604, 590, 615, 600]


def decode_cases():
    rows = [
        decode_case(f"llama3-8b beam, write_col {wc}", 4, 6, 32, 8, 128, 1024, 200,
                    DECODE_STARTS, wc, seed=20 + i)
        for i, wc in enumerate((0, 100, 199))
    ]
    rows.append(decode_case("llama3-8b lookahead trunk session (P=1)", 1, 6, 32, 8, 128, 1024,
                            200, DECODE_STARTS, 100, seed=24))
    rows.append(decode_case("gemma2-9b, softcap 50, window 256", 4, 6, 16, 8, 256, 1024, 200,
                            DECODE_STARTS, 100, seed=25, scale=224 ** -0.5, softcap=50.0,
                            window=256))
    rows.append(decode_case("W0=700 not a tile multiple, one role's span one column", 4, 3, 32,
                            8, 128, 700, 50, [0, 350, 699], 37, seed=26))
    return rows


#: The broken build: every tail block reads the neighbouring slot's tail.
DECODE_MUTANT_LINE = "const size_t tail_row = (size_t)p * R + r;"
DECODE_MUTANT = "const size_t tail_row = (size_t)((p + 1) % P) * R + r;"


def decode_mutant_check():
    """Build decode_attention with tail rows reading the neighbouring
    slot's tail and hold it against the plain version as the real kernel is
    held, at the beam shape: the comparison must fail."""
    import torch
    from consensus_tpu_torch.ops import decode_attention as da

    lib, build_s = build_mutant("decode_attention", DECODE_MUTANT_LINE, DECODE_MUTANT)
    write_col = 100
    q, tk, tv, lk, lv = decode_inputs(4, 6, 32, 8, 128, 1024, 200, seed=21)
    sts = torch.tensor(DECODE_STARTS, dtype=torch.int32, device="cuda")
    qps = torch.tensor([1024 - s + write_col for s in DECODE_STARTS], dtype=torch.int32,
                       device="cuda")
    out = torch.empty_like(q)
    da.launch_kernel(lib, q, tk, tv, lk, lv, sts, qps, write_col, out, 4, 6, 128 ** -0.5,
                     None, None)
    plain = da.decode_attention_reference(q, tk, tv, lk, lv, sts, qps, write_col, 4, 6,
                                          128 ** -0.5)
    within, max_err, atol_needed = compare(out, plain)
    del q, tk, tv, lk, lv, out, plain
    torch.cuda.empty_cache()
    return {
        "phase": "mutant", "kernel": "decode_attention",
        "mutation": "tail rows of slot p read slot (p + 1) % P's tail",
        "shape": [4, 6, 32, 8, 128, 1024, 200], "build_s": build_s, "max_abs_err": max_err,
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
    from consensus_tpu_torch.ops import decode_attention as da
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
    da.launches.reset()
    t0 = time.perf_counter()
    experiment = Experiment(config, backend=backend)
    frame = experiment.run()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
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
        "no_decode_launches": launches["decode_attention"] == 0,
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


# -- token-search path --------------------------------------------------------

#: Kernel route vs einsum route of the same bf16 model, per log-probability
#: of every id in every row after each step: the einsum route rounds its
#: logits, softmax weights and output to bf16, the kernel keeps fp32 until
#: its bf16 output, and the difference compounds over 32 layers.
ROUTE_ATOL = 0.1
ROUTE_STEPS = 3


def decode_route_check(backend, config):
    """search_prefill on the beam's prompts, then ROUTE_STEPS advances with
    fixed reordering parents and tokens, each run from the same state
    through the decode-kernel route and the einsum route of
    forward_trunk_tail.  Returns (max |logprob diff| over agent rows, the
    same over reference rows, kernel launches)."""
    import torch
    from consensus_tpu_torch.backends.session import SearchSpec
    from consensus_tpu_torch.methods.prompts import agent_prompt, reference_prompt
    from consensus_tpu_torch.models import stepper
    from consensus_tpu_torch.models.transformer import project_logits
    from consensus_tpu_torch.ops import decode_attention as da

    scenario, beam = config["scenario"], config["beam_search"]
    opinions = scenario["agent_opinions"]
    system, user = reference_prompt(scenario["issue"], opinions, variant="beam_search")
    spec = SearchSpec(
        ref_system=system, ref_user=user,
        agent_prompts=tuple(
            agent_prompt(scenario["issue"], o, variant="beam_search") for o in opinions.values()
        ),
        n_slots=beam["beam_width"], k=beam["beam_width"], sample=False,
        max_steps=beam["max_tokens"],
    )
    n_slots = spec.n_slots
    parents = [(p + 1) % n_slots for p in range(n_slots)]
    words = backend.tokenizer.encode("We agree")
    session = backend.open_fused_token_search(spec)
    agent_err = ref_err = 0.0
    try:
        session.propose()
        state = session._state
        before = da.launches.count
        for step in range(ROUTE_STEPS):
            tokens = [words[(step + p) % len(words)] for p in range(n_slots)]
            logprobs, states = {}, {}
            for kernel in (True, False):
                copy = state._replace(
                    tail_k=state.tail_k.clone(), tail_v=state.tail_v.clone(),
                    tail_positions=state.tail_positions.clone(),
                )
                hidden, states[kernel] = stepper.advance(
                    backend.params, backend.config, copy, parents, tokens, step, n_slots,
                    session.n_roles, use_decode_kernel=kernel,
                )
                logits = project_logits(backend.params, backend.config, hidden)
                logprobs[kernel] = torch.log_softmax(logits, dim=-1).reshape(
                    n_slots, session.n_roles, -1
                )
            diff = (logprobs[True] - logprobs[False]).abs()
            agent_err = max(agent_err, diff[:, 1:].max().item())
            ref_err = max(ref_err, diff[:, 0].max().item())
            state = states[True]
        launched = da.launches.count - before
    finally:
        session.close()
    return agent_err, ref_err, launched


def token_search_path():
    import pandas as pd
    import torch
    import yaml

    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.experiment import Experiment
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    config = yaml.safe_load((ROOT / TOKEN_SEARCH_CONFIG).read_text())
    config["output_dir"] = str(OUT_DIR)
    started = time.perf_counter()
    backend = TorchBackend(**config["backend_options"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - started

    sessions = []
    open_session = backend.open_fused_token_search

    def opened(spec):
        session = open_session(spec)
        sessions.append(type(session).__name__)
        return session

    backend.open_fused_token_search = opened
    torch.cuda.reset_peak_memory_stats()

    fa.launches.reset()
    da.launches.reset()
    t0 = time.perf_counter()
    experiment = Experiment(config, backend=backend)
    frame = experiment.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
    shapes = {key: (count, args) for key, (count, args) in da.launches.shapes.items()}
    del backend.open_fused_token_search

    on_disk = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    methods = config["methods_to_run"]
    n_layers = backend.config.n_layers
    advances = backend.call_counts["search_advances"]
    tokens = dict(backend.token_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checks = {
        "one_row_per_method": list(on_disk["method"]) == methods,
        "no_errors": bool((on_disk["error_message"] == "").all()),
        "statements_non_empty": bool(on_disk["statement"].astype(str).str.len().gt(0).all()),
        "fused_sessions_only": len(sessions) == len(methods)
        and all(name == "TorchTokenSearchSession" for name in sessions),
        "decode_launches_eq_layers_x_advances": launches["decode_attention"] == n_layers * advances > 0,
    }
    agent_err, ref_err, check_launches = decode_route_check(backend, config)
    checks["k2_route_matches_einsum_route"] = (
        agent_err <= ROUTE_ATOL and ref_err <= ROUTE_ATOL
        and check_launches == ROUTE_STEPS * n_layers
    )
    row = {
        "phase": "token_search_path", "model": backend.config.name,
        "d_model": backend.config.d_model, "n_layers": n_layers,
        "vocab": backend.config.vocab_size, "dtype": "bfloat16",
        "quantization": backend.quantization, "methods": methods,
        "init_s": init_s, "experiment_s": wall,
        "generation_time_s": dict(zip(on_disk["method"], on_disk["generation_time_s"])),
        "search_advances": advances, "sessions": sessions, "tokens": tokens,
        "launches": launches,
        "decode_shapes": [
            {"q": list(q), "trunk": list(t), "tail": list(l), "launches": count}
            for (q, t, l), (count, _) in shapes.items()
        ],
        "peak_memory_gb": peak_gb,
        "results_csv": str(experiment.run_dir.relative_to(ROOT) / "results.csv"),
        "route_check": {
            "steps": ROUTE_STEPS, "max_agent_logprob_err": agent_err,
            "max_ref_logprob_err": ref_err, "launches": check_launches,
            "tolerance": f"logprob atol {ROUTE_ATOL}",
        },
        "checks": checks, "ok": all(checks.values()),
    }
    del backend, experiment
    torch.cuda.empty_cache()
    return row, launches, shapes


def summary_decode(launches, shapes, max_err):
    """Time the kernel at every (q, trunk, tail) shape the token-search path
    launched, with the spans and write_col of that shape's last launch, on
    random inputs.  The entry's numbers are those of the shape launched
    most (the larger on a tie); ``by_shape`` holds them all."""
    by_shape = []
    for (q, trunk, tail), (count, (starts, qpos, write_col)) in shapes.items():
        (rows, heads, hd), (n_roles, w0, kv, _), ts = q, trunk, tail[1]
        row = decode_case(
            "token-search path shape and spans", rows // n_roles, n_roles, heads, kv, hd, w0,
            ts, starts.tolist(), write_col, seed=27, qpos=qpos.tolist(),
        )
        row["path_launches"] = count
        by_shape.append(row)
    best = max(by_shape, key=lambda r: (r["path_launches"], r["shape"][0]))
    return {
        "name": "decode_attention",
        "route": "cuda",
        "source": "consensus_tpu_torch/csrc/decode_attention.cu",
        "replaces": "consensus_tpu/ops/decode_attention.py:245",
        "launches": launches["decode_attention"],
        "max_abs_err": max([max_err] + [r["max_abs_err"] for r in by_shape]),
        "ms": best["kernel_ms"],
        "plain_ms": best["plain_ms"],
        "bound_ms": best["bound_ms"],
        "bound_by": best["bound_by"],
        "library_ms": best["library_ms"],
        "shape": best["shape"],
        "write_col": best["write_col"],
        "by_shape": [
            {key: r[key] for key in ("shape", "write_col", "starts", "path_launches", "kernel_ms",
                                     "plain_ms", "library_ms", "bound_ms", "bound_by",
                                     "max_abs_err")}
            for r in by_shape
        ],
    }, all(r["ok"] for r in by_shape)


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    emit({
        "phase": "build", "kernels": list(KERNELS), "seconds": time.perf_counter() - t0,
        "ptxas": {
            name: [line for line in log.splitlines() if "registers" in line or "spill" in line]
            for name, log in logs.items()
        },
    })

    flash_cases = kernel_cases()
    decode_cases_ = decode_cases()
    mutants = [mutant_check(), decode_mutant_check()]
    kernels_ok = all(c["ok"] for c in flash_cases + decode_cases_)
    emit({"phase": "kernels", "flash_attention": flash_cases,
          "decode_attention": decode_cases_, "ok": kernels_ok})
    for mutant in mutants:
        emit(mutant)

    main_row, launches, main_shapes, main_spans = main_path()
    emit(main_row)
    if main_shapes is None:
        fail("the main path launched no flash-attention kernel")
    search_row, search_launches, search_shapes = token_search_path()
    emit(search_row)
    if not search_shapes:
        fail("the token-search path launched no decode-attention kernel")

    flash_entry, flash_ok = summary_flash(
        launches, main_shapes, main_spans, max(c["max_abs_err"] for c in flash_cases)
    )
    decode_entry, decode_ok = summary_decode(
        search_launches, search_shapes, max(c["max_abs_err"] for c in decode_cases_)
    )
    emit({"kernels": [flash_entry, decode_entry]})
    print(smi, flush=True)
    if not (kernels_ok and all(m["ok"] for m in mutants) and main_row["ok"]
            and search_row["ok"] and flash_ok and decode_ok):
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

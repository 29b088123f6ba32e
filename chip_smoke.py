#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, one
JSON line each; any failure exits non-zero:

1. ``device``  -- the card (nvidia-smi name and power limit), torch and CUDA.
2. ``build``   -- every hand-written kernel (flash_attention, decode_attention)
   built from ``consensus_tpu_torch/csrc`` with nvcc, together with the
   three deliberately broken builds below: one nvcc process per source, all
   started together from threads.  Per kernel function: registers and
   spill bytes from ptxas.
3. ``kernels`` -- each kernel against its plain PyTorch version on the card,
   case by case, with kernel / plain / library (SDPA) / bound times and the
   least atol each case needed; kernel and SDPA are timed as calls captured
   in a CUDA graph.  Three ``mutant`` lines follow: the same comparison
   must catch each broken build (flash_attention with one middle key tile
   skipped; flash_attention with every key tile taken as interior, so no
   mask is applied; decode_attention with every tail row reading the
   neighbouring slot's tail).
4. ``main_path`` -- the best-of-N config (llama3-8b at full width, random
   weights, bf16 + int8) through ``consensus_tpu_torch.experiment.Experiment``:
   best_of_n, zero_shot and predefined to a results.csv, with every kernel
   launch count zeroed just before and read just after; its scoring goes
   through flash_attention.
5. ``token_search_path`` -- the token-search config (same model, with
   ``use_decode_attention``) through ``Experiment``: beam_search and
   finite_lookahead to a results.csv, then finite_lookahead alone at
   scenario 1's other two seeds (43, 44), whose sessions must advance
   (seed 42's first pick is a terminator: an empty statement, as the
   reference's method writes on the same draws); counts zeroed just before
   and read just after; every search step and brushup decode step goes
   through decode_attention.  Then the
   kernel route of a few search steps is held against the einsum route of
   the same bf16 model.
6. ``reference_defaults_path`` -- the reference-defaults config (scenario
   1's backend options and nothing else) through ``Experiment``: best-of-N's
   drafts decode from a shared prompt trunk in int8-KV segments, zero_shot
   takes the classic segmented rows, best-of-N scores through the fused
   score matrix, counts zeroed just before and read just after.  The fused
   utilities are held against the same backend's per-call fallback.
7. ``decode_route_check`` -- one fixed 128-token sequence teacher-forced
   for 4 rows through ``forward_trunk_tail`` over one shared 1024-column
   trunk by six routes: a dense tail by einsum, the same by
   decode_attention, frozen 64-column blocks, the classic layout (one trunk
   row per request), each held against the first; frozen blocks in int8
   and the classic layout with an int8 trunk, each held against its own
   bf16 layout, and checked to attend int8 values with scales.
8. ``shared_trunk_decode_path`` -- ``generate`` of 4 identical 200-token
   requests on the reference-defaults config plus ``use_decode_attention``:
   the monolithic shared-trunk decode, every step through decode_attention,
   counts zeroed just before and read just after.
9. ``threefry_on_card`` -- the port's threefry (bit for bit ``jax.random``
   on the CPU, pinned by the tests) on the card equals the same calls on
   the CPU, bit for bit; ms per decode step of split + gumbel + argmax.
10. ``greedy_batch_invariance`` -- one greedy 200-token request of the
   habermas-eval config decoded inside batches of 1, 8, 9 and 32 distinct
   requests: token for token the same, or the first step that differs;
   the backend's ``deterministic_greedy`` must match the result.
11. ``habermas_eval_path`` -- the habermas-eval config through
   ``run_pipeline`` (``cli/run_experiment_with_eval.py``): best_of_n,
   habermas_machine and predefined, the resident judge's comparative
   ranking, evaluation under gemma2-9b and llama3-8b (each at full width,
   the gemma2-9b backend freed after its phase), aggregation; counts
   zeroed just before and read just after; evaluation embeds through
   flash_attention under each model.

Then a ``{"kernels": [...]}`` summary line (each kernel timed at the shapes
and spans its path gave it), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
REFERENCE_CONFIG = "consensus_tpu_torch/configs/llama3_8b_reference_defaults.yaml"
HABERMAS_CONFIG = "consensus_tpu_torch/configs/llama3_8b_habermas_eval.yaml"
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


def build_mutant(tag: str, name: str, line: str, replacement: str):
    """Build ``csrc/<name>.cu`` with ``line`` replaced, as
    ``_build/mutant/<tag>.so`` -> (library path, build seconds)."""
    from consensus_tpu_torch.ops import build

    source = (build.CSRC_DIR / f"{name}.cu").read_text()
    if source.count(line) != 1:
        fail(f"mutant: the line {line!r} is not where chip_smoke.py expects it in {name}.cu")
    mutant = build.BUILD_DIR / "mutant" / f"{tag}.cu"
    mutant.parent.mkdir(parents=True, exist_ok=True)
    mutant.write_text(source.replace(line, replacement))
    t0 = time.perf_counter()
    library = mutant.with_suffix(".so")
    build.compile_library(mutant, library)
    return library, time.perf_counter() - t0


def ptxas_report(log: str):
    """Per kernel function in nvcc's ``-Xptxas -v`` output: registers and
    spill bytes."""
    import re

    functions, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = {"function": entry.group(1)}
            functions.append(current)
        elif current is not None and "spill stores" in line:
            stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line).groups()
            current["spill_bytes"] = int(stores) + int(loads)
        elif current is not None and "registers" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return functions


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
    row["kernel_ms"] = graph_ms(lambda: fa.flash_attention(q, k, v, lens, sts, **kw), reps=20)
    row["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_reference(q, k, v, lens, sts, **kw), reps=3, warmup=1
    )
    row["library_ms"] = graph_ms(sdpa_call(q, k, v, lens, sts, eff_scale, window), reps=10)
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


#: The broken builds, by tag: (kernel, line of its source, replacement, what
#: it breaks).  Each line must occur exactly once in the source.
MUTANTS = {
    "flash_skip_tile": (
        "flash_attention", "if (!empty) {",
        "if (!empty && !(k0 == 256 && kt_hi * BK > 512)) {",
        "skip the key tile that starts at key 256 where the block's keys reach past 512",
    ),
    "flash_no_mask": (
        "flash_attention",
        "const bool interior = full_rows && k0 >= lo_max && k0 + BK <= hi_min;",
        "const bool interior = true;",
        "every key tile taken as interior: no span, causal or window mask",
    ),
    "decode_neighbour_tail": (
        "decode_attention", "const size_t tail_row = (size_t)p * a.R + r;",
        "const size_t tail_row = (size_t)((p + 1) % a.P) * a.R + r;",
        "tail rows of slot p read slot (p + 1) % P's tail",
    ),
}


def mutant_row(tag, build_s, shape, out, plain):
    within, max_err, atol_needed = compare(out, plain)
    kernel, _, _, mutation = MUTANTS[tag]
    return {
        "phase": "mutant", "kernel": kernel, "mutation": mutation, "shape": shape,
        "build_s": build_s, "max_abs_err": max_err, "atol_needed": atol_needed,
        "tolerance": f"atol {ATOL} + rtol {RTOL}", "caught": not within, "ok": not within,
    }


def mutant_check(tag, library, build_s):
    """Hold a broken flash_attention build against the plain version
    exactly as the real kernel is held, at the scoring case's shape: the
    comparison must fail, or the tolerance (or the cases) could not tell."""
    import ctypes

    import numpy as np
    import torch
    from consensus_tpu_torch.ops import flash_attention as fa

    s = 768
    lens = ragged(np.random.default_rng(0), 32, s, s // 4)
    q, k, v, lengths, starts = flash_inputs(32, s, 32, 8, 128, lens, [0] * 32, seed=1)
    out = torch.empty_like(q)
    fa.launch_kernel(ctypes.CDLL(str(library)), q, k, v, out, lengths, starts, 128 ** -0.5,
                     None, None, True)
    plain = fa.flash_attention_reference(q, k, v, lengths, starts)
    row = mutant_row(tag, build_s, [32, s, 32, 8, 128], out, plain)
    del q, k, v, out, plain
    torch.cuda.empty_cache()
    return row


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
    # Wide beams: 16 slots put 64 (llama3-8b) or 32 (gemma2-9b) query rows
    # in a (role, kv head) group, four or two 16-row tiles.
    rows.append(decode_case("llama3-8b, 16 slots (64 rows per group)", 16, 6, 32, 8, 128, 1024,
                            200, DECODE_STARTS, 150, seed=28))
    rows.append(decode_case("gemma2-9b, 16 slots, softcap 50, window 256", 16, 6, 16, 8, 256,
                            1024, 200, DECODE_STARTS, 150, seed=29, scale=224 ** -0.5,
                            softcap=50.0, window=256))
    # Shared-trunk generation: best-of-N's 4 drafts bucket to 8 rows (4 of
    # them padding, done from the start) over one role's 1024-column prompt
    # trunk (best-of-N's reference prompt fills it: start 0), 256-column tails.
    rows += [
        decode_case(f"llama3-8b shared-trunk generation, write_col {wc}", 8, 1, 32, 8, 128,
                    1024, 256, [0], wc, seed=30 + i)
        for i, wc in enumerate((0, 128, 255))
    ]
    return rows


def decode_mutant_check(library, build_s):
    """Hold the neighbour-tail decode_attention build against the plain
    version as the real kernel is held, at the beam shape: the comparison
    must fail."""
    import ctypes

    import torch
    from consensus_tpu_torch.ops import decode_attention as da

    write_col = 100
    q, tk, tv, lk, lv = decode_inputs(4, 6, 32, 8, 128, 1024, 200, seed=21)
    sts = torch.tensor(DECODE_STARTS, dtype=torch.int32, device="cuda")
    qps = torch.tensor([1024 - s + write_col for s in DECODE_STARTS], dtype=torch.int32,
                       device="cuda")
    out = torch.empty_like(q)
    da.launch_kernel(ctypes.CDLL(str(library)), q, tk, tv, lk, lv, sts, qps, write_col, out,
                     4, 6, 128 ** -0.5, None, None)
    plain = da.decode_attention_reference(q, tk, tv, lk, lv, sts, qps, write_col, 4, 6,
                                          128 ** -0.5)
    row = mutant_row("decode_neighbour_tail", build_s, [4, 6, 32, 8, 128, 1024, 200], out,
                     plain)
    del q, tk, tv, lk, lv, out, plain
    torch.cuda.empty_cache()
    return row


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
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    config = yaml.safe_load((ROOT / TOKEN_SEARCH_CONFIG).read_text())
    config["output_dir"] = str(OUT_DIR)
    started = time.perf_counter()
    backend = TorchBackend(**config["backend_options"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - started

    sessions, opened_sessions = [], []
    open_session = backend.open_fused_token_search

    def opened(spec):
        session = open_session(spec)
        sessions.append(type(session).__name__)
        opened_sessions.append(session)
        return session

    backend.open_fused_token_search = opened
    torch.cuda.reset_peak_memory_stats()

    # Scenario 1 runs seeds 42-44; the config keeps the first.  Finite
    # lookahead stops at its first pick when that is a terminator, and then
    # writes an empty statement as the reference's method does on the same
    # draws (tests/test_torch_search_methods.py, sampled statements).  So the
    # method also runs at scenario 1's other two seeds, whose statements must
    # advance its trunk session through decode_attention (P=1, R=6).
    lookahead_config = dict(
        config, experiment_name=config["experiment_name"] + "_lookahead_seeds",
        seed=config["seed"] + 1, num_seeds=2, methods_to_run=["finite_lookahead"],
    )
    # The brushups' classic generation decodes one forward_trunk_tail per
    # step through decode_attention, as the reference's does: counted here.
    with Wrapped(gen, ("forward_trunk_tail",)) as decode_steps:
        fa.launches.reset()
        da.launches.reset()
        t0 = time.perf_counter()
        experiment = Experiment(config, backend=backend)
        experiment.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lookahead = Experiment(lookahead_config, backend=backend)
        lookahead.run()
        torch.cuda.synchronize()
        lookahead_wall = time.perf_counter() - t0 - wall
        launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
        shapes = {key: (count, args) for key, (count, args) in da.launches.shapes.items()}
    brushup_steps = decode_steps.calls["forward_trunk_tail"]
    session_steps = [session._step for session in opened_sessions]
    del backend.open_fused_token_search, opened_sessions

    on_disk = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    seeds_on_disk = pd.read_csv(lookahead.run_dir / "results.csv", keep_default_na=False)
    methods = config["methods_to_run"]
    n_layers = backend.config.n_layers
    advances = backend.call_counts["search_advances"]
    tokens = dict(backend.token_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    statements = list(on_disk["statement"].astype(str)) + list(
        seeds_on_disk["statement"].astype(str)
    )
    seed_steps = session_steps[len(methods):]
    lookahead_launches = sum(
        count for (q, trunk, _), (count, _) in shapes.items() if q[0] == trunk[0] == 6
    )
    checks = {
        "one_row_per_method": list(on_disk["method"]) == methods,
        "no_errors": bool((on_disk["error_message"] == "").all())
        and bool((seeds_on_disk["error_message"] == "").all()),
        # A statement is empty exactly when its session emitted no token.
        "statements_non_empty": len(session_steps) == len(statements) and all(
            (len(text) > 0) == (steps > 0) for text, steps in zip(statements, session_steps)
        ),
        "lookahead_seeds_advanced": list(seeds_on_disk["seed"]) == [config["seed"] + 1, config["seed"] + 2]
        and len(seed_steps) == 2 and all(steps > 0 for steps in seed_steps)
        and bool(seeds_on_disk["statement"].astype(str).str.len().gt(0).all()),
        "fused_sessions_only": len(sessions) == len(methods) + 2
        and all(name == "TorchTokenSearchSession" for name in sessions),
        "decode_launches_eq_layers_x_advances_and_brushup_steps": launches["decode_attention"]
        == n_layers * (advances + brushup_steps) and advances > 0 and brushup_steps > 0,
        # Beam's queries are 4 x 6 rows; lookahead's trunk session 1 x 6.
        "lookahead_launched_decode_attention_at_p1_r6": lookahead_launches
        == n_layers * sum(session_steps[1:]) and sum(seed_steps) > 0,
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
        "lookahead_seeds": {
            "seeds": list(seeds_on_disk["seed"]), "experiment_s": lookahead_wall,
            "generation_time_s": list(seeds_on_disk["generation_time_s"]),
            "statement_chars": [len(t) for t in seeds_on_disk["statement"].astype(str)],
            "session_steps": seed_steps, "decode_launches_p1_r6": lookahead_launches,
            "results_csv": str(lookahead.run_dir.relative_to(ROOT) / "results.csv"),
        },
        "search_advances": advances, "brushup_decode_steps": brushup_steps,
        "sessions": sessions, "session_steps": session_steps,
        "statement_chars": {m: len(t) for m, t in zip(on_disk["method"], on_disk["statement"].astype(str))},
        "tokens": tokens,
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
    del backend, experiment, lookahead
    torch.cuda.empty_cache()
    return row, launches, shapes


# -- reference-defaults path ---------------------------------------------------

#: Generation routes counted by wrapping the module functions.
GENERATION_ROUTES = (
    "generate_tokens", "generate_tokens_shared_trunk", "generate_tokens_shared_trunk_segmented",
    "generate_tokens_segmented",
)


class Wrapped:
    """Replaces attributes of ``obj`` (a module or a class) for a ``with``
    block and restores them after: each of ``names`` by a wrapper that
    counts its calls (and hands each result to ``record``), each key of
    ``make`` by ``make[key](original)``."""

    def __init__(self, obj, names=(), record=None, make=None):
        self.obj, self.record = obj, record
        self.calls = {name: 0 for name in names}
        self.make = dict(make or {}, **{name: self._counting(name) for name in names})

    def _counting(self, name):
        def make(fn):
            def wrapper(*args, **kwargs):
                self.calls[name] += 1
                out = fn(*args, **kwargs)
                if self.record is not None:
                    self.record(name, out)
                return out
            return wrapper
        return make

    def __enter__(self):
        self.saved = {name: getattr(self.obj, name) for name in self.make}
        for name, fn in self.saved.items():
            setattr(self.obj, name, self.make[name](fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.obj, name, fn)


def reference_defaults_path():
    """The reference-defaults config through ``Experiment`` on the card ->
    (row, backend, config); the backend stays up for the next phases."""
    import dataclasses

    import numpy as np
    import pandas as pd
    import torch
    import yaml

    from consensus_tpu_torch.backends.score_matrix import fallback_score_matrix_many
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.experiment import Experiment
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.models import stepper
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    config = yaml.safe_load((ROOT / REFERENCE_CONFIG).read_text())
    config["output_dir"] = str(OUT_DIR)
    started = time.perf_counter()
    backend = TorchBackend(**config["backend_options"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - started

    timers = {"generate": 0.0, "score": 0.0, "score_matrix": 0.0}
    matrices = []
    inside_matrix = []  # a per-call fallback's score counts under score_matrix

    def timed(kind, fn):
        def call(requests):
            inside_matrix.append(kind == "score_matrix")
            t0 = time.perf_counter()
            try:
                out = fn(requests)
                torch.cuda.synchronize()
            finally:
                inside_matrix.pop()
            if not any(inside_matrix):
                timers[kind] += time.perf_counter() - t0
            if kind == "score_matrix":
                matrices.extend(zip(requests, out))
            return out
        return call

    for kind in timers:
        setattr(backend, kind, timed(kind, getattr(backend, kind)))
    pools = []
    torch.cuda.reset_peak_memory_stats()
    pool_sizes = Wrapped(
        stepper, ("make_page_state",),
        record=lambda _, state: pools.append(sum(t.nbytes for t in state)),
    )
    with Wrapped(gen, GENERATION_ROUTES) as routes, pool_sizes:
        fa.launches.reset()
        da.launches.reset()
        t0 = time.perf_counter()
        experiment = Experiment(config, backend=backend)
        frame = experiment.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for kind in timers:
        delattr(backend, kind)

    on_disk = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    methods = config["methods_to_run"]
    stats = dict(backend.matrix_stats)
    tokens = dict(backend.token_counts)  # before the checks below score more
    tok = backend.tokenizer

    def context_tokens(request):
        return [len(tok.encode(backend._score_prefix(a.to_score_request("")), add_bos=True))
                for a in request.agents]

    # The fused path takes a matrix only when every agent context plus the
    # longest candidate fits max_context; otherwise the whole matrix goes
    # per call, as in the reference.  With the byte tokenizer the contexts
    # run to ~935 tokens, so the experiment's drafts may not fit: the same
    # agents then score the drafts cut to the room left, through the fused
    # path, once more.
    windows = [
        (max(context_tokens(request)), max(len(tok.encode(c)) for c in request.candidates))
        for request, _ in matrices
    ]
    fits = [ctx + cont <= backend.max_context for ctx, cont in windows]
    direct = []
    with pool_sizes:
        for request, _ in matrices:
            room = backend.max_context - max(context_tokens(request))
            cut = []
            for text in request.candidates:
                while text and len(tok.encode(text)) > room:
                    text = text[:-1]
                cut.append(text)
            before = dict(backend.matrix_stats)
            request = dataclasses.replace(request, candidates=tuple(cut))
            t0 = time.perf_counter()
            result = backend.score_matrix([request])[0]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            direct.append((request, result, {
                key: backend.matrix_stats[key] - before[key] for key in before
            }, seconds))
    # The fused utilities against the same backend's per-call fallback
    # (shared-context scoring here: each agent's drafts share its context).
    fused = [(q, r) for q, r in matrices if r.path == "fused"] + [(q, r) for q, r, _, _ in direct]
    matrix_err, per_call_s = 0.0, []
    for request, result in fused:
        t0 = time.perf_counter()
        fallback = fallback_score_matrix_many(backend, [request])[0]
        torch.cuda.synchronize()
        per_call_s.append(time.perf_counter() - t0)
        matrix_err = max(matrix_err, float(np.abs(
            np.asarray(result.utilities, np.float64) - fallback.utilities
        ).max()))
    checks = {
        "one_row_per_method": list(on_disk["method"]) == methods,
        "no_errors": bool((on_disk["error_message"] == "").all()),
        "statements_non_empty": bool(on_disk["statement"].astype(str).str.len().gt(0).all()),
        "matrix_route_follows_window": len(matrices) >= 1 and all(
            (r.path == "fused") == fit for (_, r), fit in zip(matrices, fits)
        ) and stats["fallbacks"] == fits.count(False),
        "fused_matrix_without_fallback": all(
            r.path == "fused" and d["fallbacks"] == 0 and d["chunks"] >= 1
            for _, r, d, _ in direct
        ) and stats["chunks"] >= fits.count(True),
        "shared_trunk_segmented_route": routes.calls["generate_tokens_shared_trunk_segmented"] >= 1,
        "classic_segmented_route": routes.calls["generate_tokens_segmented"] >= 1,
        "fused_matches_per_call_fallback": bool(fused) and matrix_err <= UTILITY_ATOL,
    }
    row = {
        "phase": "reference_defaults_path", "model": backend.config.name,
        "d_model": backend.config.d_model, "n_layers": backend.config.n_layers,
        "vocab": backend.config.vocab_size, "dtype": "bfloat16",
        "quantization": backend.quantization, "methods": methods,
        "backend_options": config["backend_options"],
        "init_s": init_s, "experiment_s": wall, "generate_s": timers["generate"],
        "score_s": timers["score"] + timers["score_matrix"],
        "score_matrix_s": timers["score_matrix"], "statements_per_s": len(frame) / wall,
        "generation_routes": routes.calls, "matrix_stats": stats,
        "matrix_cells": [int(r.cells) for _, r in matrices],
        "matrix_paths": [r.path for _, r in matrices],
        "agent_context_tokens": [context_tokens(q) for q, _ in matrices],
        "candidate_tokens": [[len(tok.encode(c)) for c in q.candidates] for q, _ in matrices],
        "cut_candidates": {
            "candidate_tokens": [[len(tok.encode(c)) for c in q.candidates] for q, _, _, _ in direct],
            "paths": [r.path for _, r, _, _ in direct],
            "matrix_stats": [d for _, _, d, _ in direct],
            "fused_s": [t for _, _, _, t in direct],
        },
        "page_pool_bytes": pools, "tokens": tokens, "launches": launches,
        "peak_memory_gb": peak_gb,
        "results_csv": str(experiment.run_dir.relative_to(ROOT) / "results.csv"),
        "matrix_check": {
            "fused_matrices": len(fused), "max_utility_err": matrix_err,
            "per_call_s": per_call_s, "tolerance": f"utility atol {UTILITY_ATOL}",
        },
        "checks": checks, "ok": all(checks.values()),
    }
    del experiment
    return row, backend, config


#: Teacher-forced decode routes of forward_trunk_tail.  The bf16 routes
#: regroup the same sums and are held to ROUTE_ATOL against route (a), the
#: dense tail by einsum.  Each int8 route is held against its own bf16
#: layout (frozen_int8 vs frozen, classic_int8 vs classic), so that gap is
#: the quantization error alone, and to INT8_ATOL.
#: 128 steps in two 64-column segments: cut from 256 steps in 128-column
#: segments to keep the whole script well inside its time limit.
GEN_ROUTE_STEPS = 128
GEN_ROUTE_ROWS = 4
GEN_SEGMENT = 64
GEN_ROUTES = ("einsum", "kernel", "frozen", "frozen_int8", "classic", "classic_int8")
#: route -> the route it is held against.
GEN_ROUTE_BASE = {"kernel": "einsum", "frozen": "einsum", "classic": "einsum",
                  "frozen_int8": "frozen", "classic_int8": "classic"}
#: On the H100 (over 256 steps in 128-column segments) the int8 routes'
#: gaps against their own bf16 layouts measured 0.0716 (frozen) and 0.0684
#: (classic) at most, 0.0122 and 0.0129 on average; the bf16 regroupings'
#: 0.067-0.069 at most, 0.0063 on average.  The largest gap over the steps
#: x 4 rows x every id sits near
#: 0.07 whatever perturbs this random-weight model, so the mean gap is
#: what holds the quantization error.
INT8_ATOL = 0.08
INT8_MEAN_ATOL = 0.02


def _int8_block(block) -> bool:
    """An (int8 values, float32 per-(token, head) scales) pair whose every
    scale is positive: each column was written quantized."""
    import torch

    return (isinstance(block, tuple) and block[0].dtype == torch.int8
            and block[1].dtype == torch.float32 and block[1].shape[-1] == 1
            and block[1].shape[:-1] == block[0].shape[:-1]
            and bool((block[1] > 0).all()) and bool((block[0] != 0).any()))


def generation_route_check(backend, config):
    """One fixed 128-token sequence teacher-forced for 4 rows over one shared
    1024-column prompt trunk by the six routes of ``GEN_ROUTES`` -> (max and
    mean |logprob diff| of each route against its ``GEN_ROUTE_BASE`` route,
    max against the einsum route; whether every tail, frozen block and trunk the
    int8 routes attended was int8 with scales; decode_attention launches of
    the kernel route)."""
    import dataclasses

    import torch

    from consensus_tpu_torch.methods.prompts import reference_prompt
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.models.transformer import (
        KVCache, forward_trunk_tail, params_dtype, project_logits, quantize_kv,
    )
    from consensus_tpu_torch.ops import decode_attention as da

    tok, params, rows = backend.tokenizer, backend.params, GEN_ROUTE_ROWS
    scenario = config["scenario"]
    system, user = reference_prompt(scenario["issue"], scenario["agent_opinions"])
    w0 = backend.max_context
    prompt = tok.encode(tok.chat_prompt(user, system), add_bos=True)[-w0:]
    tokens = torch.full((1, w0), tok.pad_id, dtype=torch.int32, device="cuda")
    tokens[0, w0 - len(prompt):] = torch.tensor(prompt, dtype=torch.int32)
    valid = torch.zeros((1, w0), dtype=torch.bool, device="cuda")
    valid[0, w0 - len(prompt):] = True
    text = " ".join(scenario["agent_opinions"].values())
    seq = torch.tensor(tok.encode(text)[:GEN_ROUTE_STEPS], dtype=torch.int32, device="cuda")
    c, dtype = backend.config, params_dtype(params)
    int8_layout = {}

    def run(route):
        cfg = dataclasses.replace(c, use_decode_attention=route == "kernel")
        quantized = route.endswith("_int8")
        trunk = shared
        n_slots, n_roles = rows, 1
        if route.startswith("classic"):
            # One trunk row per request, as generate_tokens_segmented holds it.
            n_slots, n_roles = 1, rows
            k, v = (t.expand(-1, rows, -1, -1, -1).contiguous() for t in (shared.k, shared.v))
            if quantized:
                k, v = quantize_kv(k), quantize_kv(v)
            trunk = KVCache(k, v, shared.key_positions.expand(rows, -1),
                            shared.key_valid.expand(rows, -1))
        if quantized:
            int8_layout[route] = route == "frozen_int8" or (
                _int8_block(trunk.k) and _int8_block(trunk.v)
            )
        seg = GEN_ROUTE_STEPS if route in ("einsum", "kernel") else GEN_SEGMENT
        base = last_pos.expand(rows)
        frozen_k, frozen_v, frozen_pos, logprobs = [], [], [], []
        shape = (c.n_layers, rows, seg, c.n_kv_heads, c.head_dim)
        for start in range(0, GEN_ROUTE_STEPS, seg):
            if quantized:
                tail_k, tail_v = (
                    (torch.zeros(shape, dtype=torch.int8, device="cuda"),
                     torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device="cuda"))
                    for _ in range(2)
                )
            else:
                tail_k, tail_v = (torch.zeros(shape, dtype=dtype, device="cuda")
                                  for _ in range(2))
            tail_pos = base[:, None] + 1 + start + torch.arange(seg, device="cuda")[None]
            for col in range(seg):
                step = start + col
                hidden, tail_k, tail_v = forward_trunk_tail(
                    params, cfg, seq[step].expand(rows), base + 1 + step, trunk, tail_k,
                    tail_v, tail_pos, col, n_slots, n_roles, frozen_k=frozen_k,
                    frozen_v=frozen_v, frozen_positions=frozen_pos,
                )
                logprobs.append(torch.log_softmax(project_logits(params, cfg, hidden), dim=-1))
            if quantized:
                # The segment's tail, now a frozen block, was written int8.
                int8_layout[route] &= _int8_block(tail_k) and _int8_block(tail_v)
            frozen_k.append(tail_k)
            frozen_v.append(tail_v)
            frozen_pos.append(tail_pos)
        return torch.stack(logprobs)

    with torch.inference_mode():
        _, shared, last_pos = gen._prefill_shared(params, c, tokens, valid)
        out = {}
        for route in GEN_ROUTES:
            before = da.launches.count
            out[route] = run(route)
            if route == "kernel":
                launched = da.launches.count - before
        gaps = {
            route: (out[route] - out[base]).abs().max().item()
            for route, base in GEN_ROUTE_BASE.items()
        }
        mean_gaps = {
            route: (out[route] - out[base]).abs().mean().item()
            for route, base in GEN_ROUTE_BASE.items()
        }
        gaps_vs_einsum = {
            route: (out[route] - out["einsum"]).abs().max().item() for route in GEN_ROUTES[1:]
        }
    return gaps, mean_gaps, gaps_vs_einsum, int8_layout, launched


def decode_route_row(backend, config):
    t0 = time.perf_counter()
    gaps, mean_gaps, gaps_vs_einsum, int8_layout, launched = generation_route_check(
        backend, config
    )
    n_layers = backend.config.n_layers
    int8_gap = max(gaps["frozen_int8"], gaps["classic_int8"])
    checks = {
        "kernel_route_within_atol": gaps["kernel"] <= ROUTE_ATOL,
        "frozen_route_within_atol": gaps["frozen"] <= ROUTE_ATOL,
        "classic_route_within_atol": gaps["classic"] <= ROUTE_ATOL,
        "int8_routes_within_int8_atol": 0 < min(gaps["frozen_int8"], gaps["classic_int8"])
        and int8_gap <= INT8_ATOL
        and max(mean_gaps["frozen_int8"], mean_gaps["classic_int8"]) <= INT8_MEAN_ATOL,
        "int8_routes_attend_int8_with_scales": all(int8_layout.values()),
        "kernel_launches_eq_layers_x_steps": launched == n_layers * GEN_ROUTE_STEPS,
    }
    return {
        "phase": "decode_route_check", "steps": GEN_ROUTE_STEPS, "rows": GEN_ROUTE_ROWS,
        "trunk_columns": backend.max_context, "segment": GEN_SEGMENT,
        "held_against": GEN_ROUTE_BASE, "max_logprob_gap": gaps, "mean_logprob_gap": mean_gaps,
        "max_logprob_gap_vs_einsum": gaps_vs_einsum, "int8_layout": int8_layout,
        "kernel_launches": launched,
        "tolerance": f"bf16 routes logprob atol {ROUTE_ATOL}; int8 routes atol {INT8_ATOL}, "
                     f"mean {INT8_MEAN_ATOL}",
        "seconds": time.perf_counter() - t0,
        "checks": checks, "ok": all(checks.values()),
    }


def shared_trunk_decode_path(backend, config):
    """``generate`` of 4 identical 200-token requests (best-of-N's drafts) on
    a backend of the reference-defaults config plus ``use_decode_attention``,
    sharing the weights of ``backend`` -> (row, launches, decode shapes)."""
    import torch

    from consensus_tpu_torch.backends.base import GenerationRequest
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.methods.prompts import reference_prompt
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    k2_backend = TorchBackend(
        **config["backend_options"], use_decode_attention=True, params=backend.params,
        device="cuda",
    )
    scenario, best_of_n = config["scenario"], config["best_of_n"]
    system, user = reference_prompt(scenario["issue"], scenario["agent_opinions"])
    requests = [
        GenerationRequest(user_prompt=user, system_prompt=system,
                          max_tokens=best_of_n["max_tokens"],
                          temperature=best_of_n["temperature"], seed=config["seed"] + i)
        for i in range(best_of_n["n"])
    ]
    with Wrapped(gen, GENERATION_ROUTES + ("forward_trunk_tail",)) as calls:
        fa.launches.reset()
        da.launches.reset()
        t0 = time.perf_counter()
        results = k2_backend.generate(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
        shapes = {key: (count, args) for key, (count, args) in da.launches.shapes.items()}
    steps = calls.calls.pop("forward_trunk_tail")
    n_layers = k2_backend.config.n_layers
    checks = {
        "monolithic_shared_trunk_route": calls.calls["generate_tokens_shared_trunk"] == 1
        and sum(calls.calls.values()) == 1,
        "decode_launches_eq_layers_x_steps": launches["decode_attention"] == n_layers * steps > 0,
        "results_ok": all(r.ok for r in results),
    }
    row = {
        "phase": "shared_trunk_decode_path", "requests": len(requests),
        "max_tokens": best_of_n["max_tokens"], "generate_s": wall, "decode_steps": steps,
        "tokens_generated": [len(r.token_ids) for r in results],
        "generation_routes": calls.calls, "launches": launches,
        "decode_shapes": [
            {"q": list(q), "trunk": list(t), "tail": list(l), "launches": count}
            for (q, t, l), (count, _) in shapes.items()
        ],
        "checks": checks, "ok": all(checks.values()),
    }
    return row, launches, shapes


def summary_decode(launches, shapes, max_err):
    """Time the kernel at every (q, trunk, tail) shape the token-search path
    and shared-trunk generation launched, with the spans and write_col of
    that shape's last launch, on random inputs.  The entry's numbers are those of the shape launched
    most (the larger on a tie); ``by_shape`` holds them all."""
    by_shape = []
    for (q, trunk, tail), (count, (starts, qpos, write_col)) in shapes.items():
        (rows, heads, hd), (n_roles, w0, kv, _), ts = q, trunk, tail[1]
        row = decode_case(
            "path shape and spans", rows // n_roles, n_roles, heads, kv, hd, w0,
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

# -- threefry on the card ---------------------------------------------------------

THREEFRY_VOCABS = (268, 128256, 256128)


def threefry_on_card():
    """The port's threefry on CUDA against the same calls on the CPU, bit
    for bit (the chip machine has no JAX: the CPU side is pinned to
    ``jax.random`` by tests/test_torch_threefry.py), and the cost of one
    decode step's sampling (split the (8, 2) keys, gumbel, argmax)."""
    import torch

    from consensus_tpu_torch.utils import threefry as tf

    def same(a, b):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))

    checks = {}
    for device_name in ("prng_key", "split", "fold_in"):
        checks[device_name] = True
    for seed in range(50):
        cpu, gpu = tf.prng_key(seed), tf.prng_key(seed, "cuda")
        checks["prng_key"] &= same(cpu, gpu)
        checks["split"] &= same(tf.split(cpu, 8), tf.split(gpu, 8))
        data = torch.arange(8) * 7919 + seed
        checks["fold_in"] &= same(
            tf.fold_in(tf.split(cpu, 8), data), tf.fold_in(tf.split(gpu, 8), data.cuda())
        )
    rng = torch.Generator().manual_seed(0)
    step_ms = {}
    for vocab in THREEFRY_VOCABS:
        keys_cpu = tf.split(tf.prng_key(vocab), 8)
        keys = keys_cpu.cuda()
        checks[f"gumbel_8x{vocab}"] = same(tf.gumbel(keys_cpu, (vocab,)), tf.gumbel(keys, (vocab,)))
        logits_cpu = torch.randn(8, vocab, generator=rng) * 3
        logits = logits_cpu.cuda()
        checks[f"categorical_8x{vocab}"] = same(
            tf.categorical(keys_cpu, logits_cpu), tf.categorical(keys, logits)
        )

        def step(keys=keys, logits=logits, vocab=vocab):
            pairs = tf.split(keys)
            return torch.argmax(logits + tf.gumbel(pairs[:, 1], (vocab,)), dim=-1)

        if vocab != 256128:
            step_ms[f"8x{vocab}"] = cuda_ms(step, reps=20)
    return {
        "phase": "threefry_on_card", "seeds": 50, "vocabs": list(THREEFRY_VOCABS),
        "step_ms": step_ms,
        "step": "split (8, 2) keys + gumbel (8, V) + argmax, CUDA events, host launches included",
        "checks": checks, "ok": all(checks.values()),
    }


# -- greedy batch invariance -------------------------------------------------------

GREEDY_WIDTHS = (1, 8, 9, 32)
GREEDY_TOKENS = 200


def greedy_batch_invariance():
    """One greedy request (a Habermas ranking prompt) decoded inside batches
    of 1, 8, 9 and 32 distinct requests (row buckets 8, 8, 16, 32) on the
    habermas-eval config's backend.  The Habermas Machine elides ranking
    retries when ``deterministic_greedy`` says greedy argmax does not
    change with batch width; the flag must match what the card does."""
    import torch
    import yaml

    from consensus_tpu_torch.backends.base import GenerationRequest
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.methods.habermas import _ranking_prompt

    config = yaml.safe_load((ROOT / HABERMAS_CONFIG).read_text())
    backend = TorchBackend(**config["backend_options"], device="cuda")
    scenario = config["scenario"]
    opinions = list(scenario["agent_opinions"].values())
    statements = [config["predefined"]["predefined_statement"]] + opinions[:3]

    def request(i):
        rotated = statements[i % 4:] + statements[: i % 4]
        prompt = _ranking_prompt(scenario["issue"], opinions[(i // 4) % 5], rotated)
        if i >= 20:
            prompt += f"\n(Variant {i}.)"
        return GenerationRequest(user_prompt=prompt, max_tokens=GREEDY_TOKENS, temperature=0.0,
                                 seed=config["seed"] + 100_000 + i, chat=True)

    target = request(0)
    outputs, seconds = {}, {}
    for width in GREEDY_WIDTHS:
        batch = [request(i) for i in range(1, width)]
        at = (width * 5) // 9
        batch.insert(at, target)
        t0 = time.perf_counter()
        outputs[width] = list(backend.generate(batch)[at].token_ids)
        torch.cuda.synchronize()
        seconds[width] = time.perf_counter() - t0
    first = outputs[GREEDY_WIDTHS[0]]
    first_diff = {}
    for width, ids in outputs.items():
        diff = next((i for i, (a, b) in enumerate(zip(first, ids)) if a != b), None)
        if diff is None and len(ids) != len(first):
            diff = min(len(ids), len(first))
        first_diff[width] = diff
    invariant = all(d is None for d in first_diff.values())
    flag = backend.deterministic_greedy
    del backend
    torch.cuda.empty_cache()
    checks = {
        "target_decoded": len(first) > 0,
        "deterministic_greedy_matches_card": flag == invariant,
    }
    return {
        "phase": "greedy_batch_invariance", "widths": list(GREEDY_WIDTHS),
        "max_tokens": GREEDY_TOKENS, "tokens": {w: len(v) for w, v in outputs.items()},
        "invariant": invariant, "first_differing_step": first_diff,
        "deterministic_greedy": flag, "generate_s": seconds,
        "checks": checks, "ok": all(checks.values()),
    }


# -- habermas + evaluation path -----------------------------------------------------


def _evaluation_columns(agents):
    """The evaluation_results.csv schema of the JAX package
    (``consensus_tpu/evaluation.py``), without its ``param_*`` columns.
    The three judge-score welfare columns appear only where some judge
    score parsed."""
    columns = {"method", "issue", "statement", "method_with_params", "seed",
               "original_row_index", "evaluation_time_s"}
    for name in agents:
        columns |= {f"cosine_similarity_{name}", f"utility_cosine_similarity_{name}",
                    f"avg_logprob_{name}", f"utility_avg_logprob_{name}",
                    f"perplexity_{name}", f"judge_score_{name}"}
    for family in ("cosine", "avg_prob", "perplexity", "judge_score"):
        for rule in ("egalitarian", "utilitarian", "log_nash"):
            columns.add(f"{rule}_welfare_{family}")
    for rule in ("egalitarian", "utilitarian", "log_nash"):
        columns |= {f"utility_{rule}_welfare_cosine", f"utility_{rule}_welfare_logprob"}
    return columns


def habermas_eval_path():
    """``run_pipeline`` on the habermas-eval config -> (row, K1 launches,
    the K1 case at gemma2-9b's last evaluation launch)."""
    import numpy as np
    import pandas as pd
    import torch
    import yaml

    from consensus_tpu_torch.cli import run_experiment_with_eval as pipeline
    from consensus_tpu_torch.evaluation import StatementEvaluator
    from consensus_tpu_torch.methods import habermas
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    config_path = ROOT / HABERMAS_CONFIG
    config = yaml.safe_load(config_path.read_text())
    overrides = {
        "output_dir": str(OUT_DIR),
        # Random weights never write the <answer> envelope: the method's
        # own timing fallbacks (raw text as candidate and critique, identity
        # ranking) make every phase run its real workload.
        "habermas_machine": dict(config["habermas_machine"], pin_budget=True),
    }
    base_seed = config["seed"]
    timers = {}
    evaluations = {}
    budgets = []  # (route, max_new_tokens) of every decode
    batches = []  # habermas _generate_batch calls
    parses = []  # every ranking parse: parsed or not
    phases = {}

    def timed(kind, record=None):
        def make(original):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = original(*args, **kwargs)
                torch.cuda.synchronize()
                timers[kind] = timers.get(kind, 0.0) + time.perf_counter() - t0
                if record is not None:
                    record(out)
                return out
            return call
        return make

    def evaluation(original):
        def call(self, *args, **kwargs):
            torch.cuda.synchronize()
            entry = {"allocated_at_entry_gb": torch.cuda.memory_allocated() / 1e9}
            before = fa.launches.count
            t0 = time.perf_counter()
            out = original(self, *args, **kwargs)
            torch.cuda.synchronize()
            entry["seconds"] = time.perf_counter() - t0
            entry["flash_launches"] = fa.launches.count - before
            entry["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            c = self.backend.config
            entry["config"] = {"name": c.name, "d_model": c.d_model, "n_layers": c.n_layers,
                               "vocab": c.vocab_size}
            if entry["flash_launches"]:
                entry["last_flash"] = (fa.launches.last_shapes, tuple(
                    t.tolist() for t in fa.launches.last_spans), c)
            evaluations[self.evaluation_model] = entry
            return out
        return call

    def route(name, index):
        def make(original):
            def call(*args, **kwargs):
                budgets.append((name, int(args[index])))
                return original(*args, **kwargs)
            return call
        return make

    def generate_batch(original):
        def call(self, prompts, seeds, temperature):
            n_parses = len(parses)
            out = original(self, prompts, seeds, temperature)
            offset = seeds[0] - base_seed
            batches.append({"phase": offset // 100_000, "attempt": offset % 10_000 // 100,
                            "rows": len(prompts), "temperature": temperature,
                            "non_empty": sum(bool(r.strip()) for r in out),
                            "deterministic_greedy": self.backend.deterministic_greedy,
                            "first_parse": n_parses})
            return out
        return call

    def parse(original):
        def call(*args, **kwargs):
            ranking, explanation = original(*args, **kwargs)
            parses.append(ranking is not None)
            return ranking, explanation
        return call

    def phase_output(kind):
        def record(out):
            phases.setdefault(kind, []).append(out)
        return record

    patches = [
        Wrapped(habermas.HabermasMachineGenerator, make={
            "generate_statement": timed("habermas"),
            "_generate_batch": generate_batch,
            "_draft_candidates": timed("habermas_drafts", phase_output("candidates")),
            "_rank_all": timed("habermas_rankings", phase_output("rankings")),
            "_critiques": timed("habermas_critiques", phase_output("critiques")),
            "_revisions": timed("habermas_revisions", phase_output("revisions")),
        }),
        Wrapped(habermas, make={"process_ranking_response": parse}),
        Wrapped(StatementEvaluator, make={
            "evaluate_comparative_rankings": timed("judge_ranking"),
            "evaluate_results_file": evaluation,
        }),
        Wrapped(pipeline, make={"aggregate_run_dir": timed("aggregation")}),
        Wrapped(gen, make={
            name: route(name, 5 if "shared" in name else 4) for name in GENERATION_ROUTES
        }),
    ]
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        fa.launches.reset()
        da.launches.reset()
        t0 = time.perf_counter()
        run_dir = pathlib.Path(pipeline.run_pipeline(str(config_path), config_overrides=overrides))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    methods = config["methods_to_run"]
    agents = list(config["scenario"]["agent_opinions"])
    on_disk = pd.read_csv(run_dir / "results.csv", keep_default_na=False)
    statements = on_disk["statement"].astype(str)
    models = config["models"]["evaluation_models"]
    eval_frames = {}
    for model in models:
        path = run_dir / "evaluation" / model / "seed_0" / "evaluation_results.csv"
        eval_frames[model] = pd.read_csv(path) if path.exists() else None
    expected_columns = _evaluation_columns(agents)
    judge_welfare = {f"{rule}_welfare_judge_score" for rule in ("egalitarian", "utilitarian", "log_nash")}

    def finite(frame):
        # Judge scores are NaN where the judge's reply did not parse, as in
        # the JAX package; every other metric is finite.
        metric = [c for c in expected_columns
                  if c not in ("method", "issue", "statement", "method_with_params")
                  and "judge_score" not in c]
        return bool(np.isfinite(frame[metric].to_numpy(dtype=np.float64)).all())

    candidates = phases.get("candidates", [[]])[0]
    rankings = phases.get("rankings", [])
    critiques = phases.get("critiques", [[]])[0]
    revisions = phases.get("revisions", [[]])[0]
    hm_config = overrides["habermas_machine"]
    ranking_batches = [b for b in batches if b["phase"] == 1]
    counts = {
        "candidates": len(candidates),
        "ranking_rounds": len(rankings),
        "rankings_parsed": sum(parses), "rankings_unparsed": len(parses) - sum(parses),
        "ranking_attempts": len(ranking_batches),
        "retries": sum(b["attempt"] > 0 for b in batches),
        "critiques": sum(c is not None for c in critiques),
        "revisions": len(revisions),
        "generate_batches": [(b["phase"], b["attempt"], b["rows"], b["temperature"])
                             for b in batches],
    }
    # The reference's ranking semantics: a first attempt over every agent;
    # a retry of the unparsed agents only when deterministic_greedy is off
    # (num_retries_on_error's default 1); what stays unparsed falls back to
    # the identity ranking (the timing fallbacks), so every agent ranks.
    retry_semantics = bool(ranking_batches)
    for i, batch in enumerate(ranking_batches):
        following = ranking_batches[i + 1] if i + 1 < len(ranking_batches) else None
        if batch["attempt"] != 0:
            continue
        unparsed = batch["rows"] - sum(parses[batch["first_parse"]:batch["first_parse"] + batch["rows"]])
        retried = following is not None and following["attempt"] == 1
        expected = unparsed > 0 and not batch["deterministic_greedy"]
        retry_semantics &= retried == expected and (not retried or following["rows"] == unparsed)
    long_budget = 768  # 700 tokens on the {1, 1.5} x power-of-two ladder
    long_routes = [name for name, budget in budgets if budget == long_budget]
    judge_dir = run_dir / "evaluation" / "llm_judge" / "seed_0"
    gemma, llama = (evaluations.get(m, {}) for m in models)
    checks = {
        "one_error_free_row_per_method": list(on_disk["method"]) == methods
        and bool((on_disk["error_message"] == "").all())
        and bool(statements.str.len().gt(0).all())
        and not statements.str.startswith("[ERROR").any(),
        "habermas_ran_every_phase": counts["candidates"] == hm_config["num_candidates"]
        and counts["ranking_rounds"] == 1 + hm_config["num_rounds"]
        and len(critiques) == len(agents)
        and counts["revisions"] == min(hm_config["num_candidates"], 4),
        "ranking_fallback_semantics": retry_semantics
        and len(parses) == sum(b["rows"] for b in ranking_batches)
        and all(all(r is not None for r in round_.values()) for round_ in rankings),
        "evaluation_files_with_schema": all(
            f is not None and expected_columns - judge_welfare <= set(f.columns)
            and not (set(f.columns) - expected_columns - {c for c in f.columns if c.startswith("param_")})
            and len(f) == len(methods)
            for f in eval_frames.values()
        ),
        "evaluation_finite": all(f is not None and finite(f) for f in eval_frames.values()),
        "judge_files": all((judge_dir / name).exists() for name in (
            "ranking_results.csv", "ranking_reasoning.csv", "comparative_ranking_matrix.json")),
        "aggregated_metrics": (run_dir / "evaluation" / "improved_aggregate"
                               / "aggregated_metrics.csv").exists(),
        "flash_launches_under_each_evaluation_model": all(
            evaluations.get(m, {}).get("flash_launches", 0) > 0 for m in models
        ),
        "segmented_route_for_700_token_budgets": bool(long_routes) and all(
            name.endswith("segmented") for name in long_routes
        ),
        "gemma_backend_freed": bool(gemma) and bool(llama)
        and llama["allocated_at_entry_gb"] < gemma["allocated_at_entry_gb"] - 4.0,
    }
    gemma_case = None
    if gemma.get("last_flash"):
        (q_shape, k_shape), (lens, starts), c = gemma["last_flash"]
        layer = c.n_layers - 1
        gemma_case = flash_case(
            "gemma2-9b evaluation, last launch's shape and spans", q_shape[0], q_shape[1],
            q_shape[2], k_shape[2], q_shape[3], lens, starts, seed=31, scale=c.q_scale,
            softcap=c.attn_softcap, window=c.sliding_window if c.layer_is_local(layer) else None,
        )
        checks["gemma_flash_case_within_tolerance"] = gemma_case["ok"]
    else:
        checks["gemma_flash_case_within_tolerance"] = False
    for entry in evaluations.values():
        entry.pop("last_flash", None)
    row = {
        "phase": "habermas_eval_path", "config": HABERMAS_CONFIG, "methods": methods,
        "evaluation_models": models, "pipeline_s": wall,
        "phase_s": {
            "generation_by_method": dict(zip(on_disk["method"], on_disk["generation_time_s"])),
            **timers,
            **{f"evaluation_{m}": e["seconds"] for m, e in evaluations.items()},
        },
        "habermas_counts": counts,
        "decode_budgets": sorted({(n, b) for n, b in budgets}),
        "evaluations": evaluations, "launches": launches, "peak_memory_gb": peak_gb,
        "gemma_flash_case": gemma_case,
        "results_csv": str(run_dir.relative_to(ROOT) / "results.csv"),
        "checks": checks, "ok": all(checks.values()),
    }
    return row, launches, gemma_case


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
    with ThreadPoolExecutor(len(KERNELS) + len(MUTANTS)) as pool:
        builds = {name: pool.submit(build.build, name) for name in KERNELS}
        mutant_builds = {
            tag: pool.submit(build_mutant, tag, *spec[:3]) for tag, spec in MUTANTS.items()
        }
        ptxas = {name: ptxas_report(job.result()) for name, job in builds.items()}
        mutant_libs = {tag: job.result() for tag, job in mutant_builds.items()}
    emit({
        "phase": "build", "kernels": list(KERNELS), "mutants": list(MUTANTS),
        "seconds": time.perf_counter() - t0, "ptxas": ptxas,
        "hd128_spill_free": all(
            any("ILi128E" in f["function"] for f in functions)
            and all(f.get("spill_bytes") == 0 for f in functions if "ILi128E" in f["function"])
            for functions in ptxas.values()
        ),
    })

    flash_cases = kernel_cases()
    decode_cases_ = decode_cases()
    mutants = [
        mutant_check(tag, *mutant_libs[tag]) for tag in ("flash_skip_tile", "flash_no_mask")
    ] + [decode_mutant_check(*mutant_libs["decode_neighbour_tail"])]
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
    reference_row, backend, reference_config = reference_defaults_path()
    emit(reference_row)
    route_row = decode_route_row(backend, reference_config)
    emit(route_row)
    generate_row, generate_launches, generate_shapes = shared_trunk_decode_path(
        backend, reference_config
    )
    emit(generate_row)
    if not generate_shapes:
        fail("shared-trunk generation launched no decode-attention kernel")
    del backend
    torch.cuda.empty_cache()
    threefry_row = threefry_on_card()
    emit(threefry_row)
    greedy_row = greedy_batch_invariance()
    emit(greedy_row)
    habermas_row, habermas_launches, gemma_case = habermas_eval_path()
    emit(habermas_row)
    if gemma_case is None:
        fail("the habermas-eval path launched no flash-attention kernel under gemma2-9b")

    flash_entry, flash_ok = summary_flash(
        {"flash_attention": launches["flash_attention"] + habermas_launches["flash_attention"]},
        main_shapes, main_spans,
        max([c["max_abs_err"] for c in flash_cases] + [gemma_case["max_abs_err"]]),
    )
    flash_entry["by_path"] = {
        "main_path": launches["flash_attention"],
        "habermas_eval_path": habermas_launches["flash_attention"],
    }
    flash_entry["gemma2_9b_evaluation"] = {
        key: gemma_case[key] for key in ("shape", "softcap", "window", "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by", "max_abs_err")
    }
    decode_shapes = dict(search_shapes)
    for key, (count, args) in generate_shapes.items():
        decode_shapes[key] = (decode_shapes.get(key, (0, None))[0] + count, args)
    decode_entry, decode_ok = summary_decode(
        {"decode_attention": search_launches["decode_attention"]
         + generate_launches["decode_attention"] + habermas_launches["decode_attention"]},
        decode_shapes,
        max(c["max_abs_err"] for c in decode_cases_),
    )
    emit({"kernels": [flash_entry, decode_entry]})
    print(smi, flush=True)
    phases = [main_row, search_row, reference_row, route_row, generate_row, threefry_row,
              greedy_row, habermas_row]
    if not (kernels_ok and all(m["ok"] for m in mutants) and all(p["ok"] for p in phases)
            and flash_ok and decode_ok):
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

#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``
(``python3 chip_smoke.py sweep_path mcts_path concurrent_path serve_path
fleet_path checkpoint_path parallel_path tensor_parallel_path
tensor_parallel_replicated_kv tensor_parallel_split_heads`` runs any of
those late phases alone, with no summary and no ``ok`` line; parallel_path
alone also runs the kernels' per-card cases).  Phases, one JSON
line each; any failure exits non-zero:

1. ``device``  -- the card (nvidia-smi name and power limit), torch and CUDA.
2. ``build``   -- every hand-written kernel (flash_attention, decode_attention)
   built from ``consensus_tpu_torch/csrc`` with nvcc, together with the
   three deliberately broken builds below: one nvcc process per source, all
   started together from threads.  Per kernel function: registers and
   spill bytes from ptxas; each kernel's own build seconds,
   ``flash_attention_spill_free``: K1's four instantiations (hd 128 / 256
   by one / two consumer warpgroups) spill nothing, and
   ``decode_attention_spill_free``: K2's six (hd 128 / 256 by 1, 2 or 4
   16-row tiles) spill nothing (a failed check fails the run).
3. ``kernels`` -- each kernel against its plain PyTorch version on the card,
   case by case, with kernel / plain / library (SDPA) / bound times and the
   least atol each case needed; kernel and SDPA are timed as calls captured
   in a CUDA graph.  ``per_card``: on each card beyond the first, one K1
   and one K2 case, and both kernels launched on that card's tensors
   while cuda:0 is current (their shared-memory limit is set per device).
   Four ``mutant`` lines follow: the same comparison
   must catch each broken build (flash_attention with one middle key tile
   skipped; flash_attention with every key tile taken as interior, so no
   mask is applied; decode_attention with every tail row reading the
   neighbouring slot's tail; decode_attention with its cluster merge
   dropping the last split's partial).
4. ``main_path`` -- the best-of-N config (llama3-8b at full width, random
   weights, bf16 + int8) through ``consensus_tpu_torch.experiment.Experiment``:
   best_of_n, zero_shot and predefined to a results.csv, with every kernel
   launch count zeroed just before and read just after; its scoring goes
   through flash_attention.
5. ``token_search_path`` -- the token-search config (same model, with
   ``use_decode_attention``) through ``Experiment``: beam_search and
   finite_lookahead to a results.csv, then finite_lookahead alone at
   scenario 1's seed 43, whose session must advance
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
10. ``greedy_batch_invariance`` -- one greedy 32-token request of the
   habermas-eval config decoded inside batches of 1, 8, 9 and 32 distinct
   requests: token for token the same, or the first step that differs;
   the backend's ``deterministic_greedy`` must match the result.
11. ``habermas_eval_path`` -- the habermas-eval config through
   ``run_pipeline`` (``cli/run_experiment_with_eval.py``): best_of_n,
   habermas_machine (HABERMAS_TOKENS of its 700 tokens a phase) and
   predefined, the resident judge's comparative
   ranking, evaluation under gemma2-9b and llama3-8b (each at full width,
   the gemma2-9b backend freed after its phase), aggregation; counts
   zeroed just before and read just after; evaluation embeds through
   flash_attention under each model.
12. ``fallback_session_path`` -- the token-search config's backend with its
   session budget forced to 1 KiB, so ``open_token_search`` returns the
   full-prefix ``PrefixTokenSearchSession``: each step is one
   ``next_token_logprobs`` forward (rows bucketed to 8, through
   flash_attention) and per-call scoring (flash_attention).  Counts zeroed
   just before and read just after.  One deterministic spec (4 slots, k 4,
   scenario 1's agents) runs propose and 3 advances through the fused
   session and then through the fallback: logprobs within 0.1, top ids
   equal where the top-two margin exceeds 0.1.  Then beam_search (width 4)
   and finite_lookahead (branching 2, depth 2) through ``Experiment``, 6
   tokens each, every session a ``PrefixTokenSearchSession``.
13. ``sweep_path`` -- ``configs/appendix/llama/scenario_1/beam_search.yaml``
   unedited (``backend: tpu``, beam widths 2/4/6/8, 50 tokens, brushup) as
   the port's ``run_sweep.find_config_files`` finds it, through
   ``run_pipeline`` with one seed and no comparative ranking, its backend
   from ``get_backend`` plus ``use_decode_attention``; counts zeroed just
   before and read just after (decode_attention for every search step and
   brushup step).  Then ``post_hoc_evaluate.evaluate_run_dir`` under
   llama3-8b (per-agent utilities within 1e-3 of the pipeline's) and one
   welfare-gap table of ``corpus:v2:polarized-0004`` through the port's
   scenario registry.
14. ``mcts_path`` -- MCTS and its rollouts on one gemma2-2b backend (the
   north_star ``backend_options`` plus ``use_decode_attention``), counts
   zeroed just before and read just after: ``configs/examples/mcts.yaml``
   through ``Experiment``; ``configs/north_star/gemma/scenario_1/mcts.yaml``
   as ``run_sweep`` finds it, through ``run_pipeline`` (one seed, 4 tokens,
   the method's ``pin_budget`` timing mode) with its evaluation under
   gemma2-2b (flash_attention); a wave of 8 rollouts through ``rollout_many``
   against ``rollout_from`` on each path and speculative against sequential;
   the example config over the forced full-prefix fallback session (4
   tokens); the north_star finite-lookahead config with ``rollout_depth`` 4,
   speculative off and on (6 tokens, pinned).  Trunk advances and the
   fallback's generate steps go through decode_attention; the rollouts
   decode by einsum, as the reference's do.
15. ``concurrent_path`` -- the reference's default execution mode on the
   same gemma2-2b backend: concurrent runs whose backend calls merge into
   shared device batches through ``BatchingBackend``, each window's counts
   zeroed just before and read just after.  (a)
   ``configs/north_star/gemma/scenario_1/habermas_vs_best_of_n.yaml`` as
   ``run_sweep`` finds it, through ``run_pipeline`` with its evaluation
   under gemma2-2b, in the timing mode (``timing_pin_budget``), cut to one
   seed of 5, best_of_n n in {1, 3, 5, 10} and 16 of its 150 tokens,
   habermas num_candidates in {1, 3} and 16 of its 700 tokens; then the
   same runs one after another; (b)
   scenario 1's beam_search config, widths {2, 4}, 8 of 50 tokens, pinned,
   with brushup, concurrent then sequential: every session fused and opened
   through ``BatchingBackend.open_fused_token_search``.  Checks: a recorded
   merged generate and score_matrix replayed on the inner backend give each
   waiter's slice; concurrent rows equal the sequential ones or differ
   first at a draw of margin under 0.1; ``metrics.json``, ``journal.jsonl``
   and a resume that executes nothing; K1 and K2 launched in the windows.
16. ``serve_path`` -- the serving entry point on llama3-8b (the token-search
   config's backend options, ``use_flash_attention`` and
   ``use_decode_attention``, budgets pinned): (a) ``python -m
   consensus_tpu_torch.serve --backend torch`` as a subprocess, four
   concurrent ``POST /v1/consensus`` (best_of_n n=4 150 tokens; the same
   with per-call scoring, which reaches K1; beam_search width 2, 16 tokens,
   which reaches K2; zero_shot; each evaluated), ``/healthz``, SIGTERM:
   every response 200,
   drained, exit 0, K1 and K2 launched (read from the server's
   ``kernel_launches_total`` in ``/metrics``); (b) in process,
   ``create_server`` over one backend with the same weights, the requests
   cut to SERVE_CUT_TOKENS, unevaluated, four ways (engine cohorts, ``--no-engine``
   flush, K=1 and K=4 decode streams): tokens equal or first differing at a
   draw of margin under 0.1, statements equal or so explained, and one
   cohort through ``generate_stream`` at K=1 and K=4 exactly equal; (c) the
   cut requests without beam search under a fault plan (a transient error
   on the first generate, a NaN in the first score call) and
   ``supervise``: the retry gives the fault-free tokens, exactly one request
   fails, its siblings are equal, the breaker ends closed.
17. ``fleet_path`` -- the serving fleet on llama3-8b (serve_path's backend
   options): (a) ``python -m consensus_tpu_torch.serve --backend torch
   --fleet 2 --elastic --telemetry --slo --state-dir`` as a subprocess with
   the prefix cache on, 8 requests offered open loop at 0.5/s by the port's
   load generator (``fixed:2``; best_of_n n=4, the same with per-call
   scoring, zero_shot; 64 tokens; evaluated) while replica r1 is lost to a
   sticky device loss mid-load: every request 200, a failover, a respawn
   warm-seeded from the page store, the time to recover, the federated
   ``replica="fleet"`` latency sketch counting every request, a state per
   SLO at ``/v1/slo``, K1 and K2 launched, every statement equal to a
   one-replica run in process or a near-tie (margin under 0.1) on the
   reference trajectory, SIGTERM drain to exit 0, and the card's used
   memory after the respawn within 1.25x of before the loss; (b) the
   port's durability harness (SIGKILL under load, relaunch on the same
   state dir): replayed > 0, none lost, duplicated or mismatched; (c) in
   process, serve_path's cut requests through K=4 engine windows with and
   without speculation, and one cohort through ``generate_stream`` both
   ways: tokens equal or first differing at a draw of margin under 0.1,
   drafts proposed, accepted tokens per dispatch printed.
18. ``checkpoint_path`` -- real weights on gemma2-2b at full width and its
   real vocab (256128), in one temporary directory removed at the end:
   seeded random bf16 params written as a 3-shard HF checkpoint (the
   writer is ``export_hf`` here: the package has no exporter);
   ``TorchBackend(checkpoint=<hf dir>, quantization="int8")`` with both
   kernels, its params bit for bit ``quantize_params`` of the source;
   ``cli/ingest_checkpoint.ingest`` (int8, on the host CPU) and
   ``TorchBackend(checkpoint=<ingested>)``, its params bit for bit the
   same; both generate 4 seeded rows of 32 pinned tokens through
   decode_attention and score two statements under 3 agents through
   flash_attention, with identical ids and logprobs, counts zeroed just
   before and read just after; ``utils/mfu`` TFLOP/s and % of the H100's
   peak, the walls of the write, the HF load, the ingest and the restore,
   bytes on disk and peak device and host memory; then
   ``theory.run_experiment`` at ``--quick`` size on the card against the
   port's CPU run (alphas within a relative 1e-3, TV within 1e-3).

19. ``parallel_path`` -- the data-parallel mesh over the cards present
   (dp=4 over cuda:0-3 with four; with one card a ``MeshPlan`` of dp=2 over
   cuda:0 twice, ``make_mesh(devices=...)``), counts read per card
   (``launches_by_device``): (a) ``python -m consensus_tpu_torch.serve
   --mesh dp=N`` on llama3-8b (serve_path's options and cut requests, 4
   at once) against the same requests through ``create_server(mesh=
   "dp=1,tp=1")`` and the plain engine path in process, posted one at a
   time there: every statement equal to dp=1's or a near-tie under 0.1
   on dp=1's trajectory, dp=1 byte-identical to the plain engine,
   ``/healthz`` with one ``per_shard`` entry per dp shard, K1 and K2
   launched on every card; (b) main_path's best-of-N config cut to 16
   tokens on ``TorchBackend`` over the plan against dp=1: ids equal or
   first differing at a draw of margin under 0.1, scores within 0.1, K1 on
   every card; (c) ``parallel.train.train_step`` on gemma2-2b at full
   width (bf16, seeded), 3 AdamW steps of 2 rows x 256 tokens a shard:
   losses finite and falling, the first step's dp=N gradients within a
   relative L2 of 2e-2 of dp=1's, wall and peak per card; (d)
   ``ring_self_attention`` at B=1, S=8192, H=32, hd=128 (bf16) over the
   plan's devices against ``full_attention_reference`` on one card, and
   one peer copy between the first two distinct cards timed.
20. ``tensor_parallel_path`` -- tensor parallelism over tp=2 on cuda:0
   twice with one card; with four, dp=1 x tp=4 over cuda:0-3 and, for (b),
   dp=2 x tp=2 too: (a) K1 (llama3-8b and gemma2-2b scoring) and K2
   (llama3-8b beam) at one rank's heads on every card against their plain
   versions, and launched there with cuda:0 current; (b) main_path's
   best-of-N config with generation through K2, cut to 8 tokens, on
   ``TorchBackend(mesh=plan)`` against tp=1: ids equal or first differing
   at a draw of margin under 0.1, scores within 0.1, K1 and K2 launched on
   every card, and with four cards each card's weight bytes within 5% of
   1/tp of tp=1's; (c) serve_path's cut requests through
   ``create_server(mesh=plan)`` in process against a tp=1 server, every
   statement equal or explained by its own near-tie or its beam session's
   replay at tp within 0.1, ``/healthz`` naming tp, that replay the search
   session held step by step, K1 and K2 on every card; (d)
   ``train_step`` on gemma2-2b at full width over the plan (3 AdamW steps
   of 2 x 256 tokens): losses falling, the first step's gradients within a
   relative L2 of 2e-2 of tp=1's, peak per card; then, recorded and not
   judged, one decode step's wall and device-busy ms at tp against tp=1
   (8 rows) and the share of its device time in memory copies.
21. ``tensor_parallel_replicated_kv`` -- tensor parallelism past the kv
   heads: gemma2-2b at full width and its real vocab (int8, bf16) at tp=8,
   cuda:0 eight times with one card, cuda:0-3 twice each with four, every
   rank one query head and a copy of the kv head it reads.  Seeded weights
   written in the port's checkpoint format and restored straight into the
   ranks (each holding its head's ``wk``/``wv`` columns; gathered back,
   the whole tree).  (a) K1 and K2 at one rank's heads (1 q / 1 kv, hd 256,
   softcap 50) on every card against their plain versions; (b) 4 seeded
   16-token generations through K2 and 6 scored cells through K1 at tp=8
   against tp=1: ids equal or first differing at a draw of margin under
   0.1, scores within 0.1, K1 and K2 on every card; (c) serve_path's first
   cut best-of-N request (the engine) and its cut beam search (a fused
   session, replayed at tp=8 step by step) through
   ``create_server(mesh=plan)`` against tp=1, ``/healthz`` naming tp=8; (d) each card's KV bytes of a fixed cache
   equal to the rank's kv heads x its ranks on the card x the per-head
   bytes, and to the backend's own count; one decode step's wall and
   device-busy ms at tp=8 against tp=1, recorded; (e) one ``train_step`` at tp=8
   (2 x 256 tokens): float32 gradients within 2e-2 of tp=1's, and the
   ranks that share a kv head bit-equal after the AdamW step.
22. ``tensor_parallel_split_heads`` -- tensor parallelism that cuts a query
   head: the same model, weights and steps (a)-(e) as phase 21 at tp=16,
   cuda:0 sixteen times with one card, cuda:0-3 four times each with
   four.  Rank t owns half of query head t // 2's columns, holds a copy of
   that head's ``wq`` columns and of its kv head's ``wk``/``wv`` columns,
   runs K1 and K2 on that whole head (1 q / 1 kv, hd 256) and keeps its own
   half of the output for its ``wo`` rows.  Beyond phase 21's checks: the
   restored ranks hold their query head's ``wq`` columns, each kernel is
   launched 16x tp=1's count, and the two ranks that share a query head
   hold bit-equal ``wq`` copies after the AdamW step; weight bytes per
   card are recorded.

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
import threading
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
    # Captured on ``side``, a stream of the current card: torch.cuda.graph's
    # own default capture stream is made once, on the card current at the
    # first capture, and a later capture on another card would record
    # nothing.
    with torch.cuda.graph(graph, stream=side):
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
    # parallel_path's per-card case (cuda:1-3 with four cards) on cuda:0.
    rows.append(flash_case("llama3-8b scoring, the per-card case's lengths", 8, 768, 32, 8, 128,
                           [768, 700, 512, 384, 300, 768, 200, 650], [0] * 8, seed=50))
    # A TMA edge: S = 130 leaves the second 128-row query tile 2 rows deep
    # and the K/V boxes past S (zero-filled on load, clipped on store);
    # left-padded starts inside a tile, a row of length 0, hd 256, softcap 50.
    lens = [130, 67, 0, 3, 129, 1, 64, 100]
    rows.append(flash_case("S=130 TMA edge, left-padded, one row of length 0", 8, 130, 16, 8, 256,
                           lens, [130 - n for n in lens], seed=7, scale=256 ** -0.5,
                           softcap=50.0))
    # gemma2-2b (mcts_path's evaluation): 8 q / 4 kv heads, hd 256, scale
    # 256^-0.5, softcap 50; its 4096 window is wider than any row here.
    s = 512
    lens = ragged(rng, 8, s, s // 4)
    rows.append(flash_case("gemma2-2b evaluation, softcap 50", 8, s, 8, 4, 256, lens, [0] * 8,
                           seed=6, scale=256 ** -0.5, softcap=50.0, window=4096))
    return rows


#: The broken builds, by tag: (kernel, line of its source, replacement, what
#: it breaks).  Each line must occur exactly once in the source.
MUTANTS = {
    "flash_skip_tile": (
        "flash_attention",
        "const bool empty = !has_rows || k0 >= hi_max || k0 + BN <= lo_min;",
        "const bool empty = !has_rows || k0 >= hi_max || k0 + BN <= lo_min"
        " || (k0 == 256 && end > 512);",
        "skip the key tile that starts at key 256 where the row's span reaches past 512",
    ),
    "flash_no_mask": (
        "flash_attention",
        "const bool interior = full_rows && k0 >= lo_max && k0 + BN <= hi_min;",
        "const bool interior = true;",
        "every key tile taken as interior: no span, causal or window mask",
    ),
    "decode_neighbour_tail": (
        "decode_attention", "const size_t tail_row = (size_t)slot * a.R + s.r;",
        "const size_t tail_row = (size_t)((slot + 1) % a.P) * a.R + s.r;",
        "tail rows of slot p read slot (p + 1) % P's tail",
    ),
    "decode_drop_last_split": (
        "decode_attention",
        "for (int j = 0; j < n_parts; ++j) {  // every block's partial of the chunk",
        "for (int j = 0; j < n_parts - 1; ++j) {  // every block's partial of the chunk",
        "the cluster merge leaves out the last split's partial",
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
    # serve_path's classic decode of a 9-row engine or flush cohort: one slot
    # over 16 roles (rows bucketed to 16), each role a 1024-column prompt
    # trunk, 64-column tails (48 pinned tokens bucketed).
    rows.append(decode_case("llama3-8b classic decode, 9-row serving cohort (P=1, R=16)", 1, 16,
                            32, 8, 128, 1024, 64, [0] * 8 + [300] + [0] * 7, 38, seed=34))
    # gemma2-2b MCTS trunk advances (mcts_path): one slot over 5 roles (the
    # north_star scenario 1: reference + 4 agents), 8 q / 4 kv heads (2 q
    # rows per group), hd 256, softcap 50, window 4096, 8-column tails.
    rows.append(decode_case("gemma2-2b MCTS trunk advance (P=1, R=5)", 1, 5, 8, 4, 256, 1024, 8,
                            DECODE_STARTS[:5], 5, seed=33, scale=256 ** -0.5, softcap=50.0,
                            window=4096))
    # A tp rank's one query head over one kv head (gemma2-2b at tp=8 / 16,
    # the classic rows of tensor_parallel_*): 8 groups of one row each.
    rows.append(decode_case("tp rank, one head (H=1, KV=1, hd 256), softcap 50", 1, 8, 1, 1, 256,
                            128, 32, [0] * 8, 31, seed=35, scale=256 ** -0.5, softcap=50.0))
    # Every role's trunk span empty at write_col 0: one valid key a row (its
    # own tail column 0), every split of a cluster but one without keys.
    rows.append(decode_case("empty trunk spans, write_col 0 (one key a row)", 1, 6, 32, 8, 128,
                            1024, 200, [1024] * 6, 0, seed=36))
    return rows


def decode_mutant_check(tag, library, build_s):
    """Hold a broken decode_attention build against the plain version as
    the real kernel is held, at the beam shape (four slots, two key splits
    a group): the comparison must fail."""
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
    row = mutant_row(tag, build_s, [4, 6, 32, 8, 128, 1024, 200], out, plain)
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


#: token_search_path's finite lookahead at seed 43: cut from the config's
#: 200 tokens for time.
LOOKAHEAD_SEED_TOKENS = 16


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
    # method also runs at scenario 1's seed 43 (seed 44 is cut for time, and
    # its budget to LOOKAHEAD_SEED_TOKENS), whose statement must advance its
    # trunk session through decode_attention (P=1, R=6).
    lookahead_config = dict(
        config, experiment_name=config["experiment_name"] + "_lookahead_seeds",
        seed=config["seed"] + 1, num_seeds=1, methods_to_run=["finite_lookahead"],
        finite_lookahead=dict(config["finite_lookahead"], max_tokens=LOOKAHEAD_SEED_TOKENS),
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
        "lookahead_seeds_advanced": list(seeds_on_disk["seed"]) == [config["seed"] + 1]
        and len(seed_steps) == 1 and all(steps > 0 for steps in seed_steps)
        and bool(seeds_on_disk["statement"].astype(str).str.len().gt(0).all()),
        "fused_sessions_only": len(sessions) == len(methods) + 1
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
        # Concurrent experiments call the wrappers from worker threads.
        self._lock = threading.Lock()

    def _counting(self, name):
        def make(fn):
            def wrapper(*args, **kwargs):
                with self._lock:
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
#: 64 steps in two 32-column segments: cut from 256 steps in 128-column
#: segments (and then 128 in 64) to keep the whole script inside its time
#: limit.
GEN_ROUTE_STEPS = 64
GEN_ROUTE_ROWS = 4
GEN_SEGMENT = 32
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
GREEDY_TOKENS = 32


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


#: Habermas's budget a phase: cut from the config's 700 for time (its
#: rankings decode every agent's ranking to the full pinned budget, the
#: retries included); 128 is the least budget that still decodes in
#: segments (two of 64 columns).
HABERMAS_TOKENS = 128
#: The resident judge decodes up to 1000 greedy tokens an agent for the
#: comparative ranking and 300 a (statement x agent) cell for the judge
#: scores of each evaluation model (``StatementEvaluator``); random weights
#: never close the JSON, so every row ran all of them (the ranking alone
#: 107-151 s of the phase).  Both cut to this for the time limit (not
#: HABERMAS_TOKENS, whose routes the phase checks), and best-of-N's 200
#: tokens to HABERMAS_BEST_OF_N_TOKENS.
JUDGE_TOKENS = 32
HABERMAS_BEST_OF_N_TOKENS = 32


class _CappedGenerate:
    """``backend`` with every generate request's max_tokens cut to ``cap``."""

    def __init__(self, backend, cap):
        self._backend, self._cap = backend, cap

    def generate(self, requests, *args, **kwargs):
        import dataclasses

        return self._backend.generate(
            [dataclasses.replace(r, max_tokens=min(r.max_tokens, self._cap)) for r in requests],
            *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._backend, name)


def _judge_cut(original):
    """A ``StatementEvaluator`` method with the judge's decode budget cut to
    JUDGE_TOKENS."""
    def call(self, *args, **kwargs):
        judge = self.judge_backend
        self.judge_backend = _CappedGenerate(judge, JUDGE_TOKENS)
        try:
            return original(self, *args, **kwargs)
        finally:
            self.judge_backend = judge
    return call


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
        "habermas_machine": dict(config["habermas_machine"], pin_budget=True,
                                 max_tokens=HABERMAS_TOKENS),
        "best_of_n": dict(config["best_of_n"], max_tokens=HABERMAS_BEST_OF_N_TOKENS),
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
            "evaluate_comparative_rankings": lambda original: timed("judge_ranking")(
                _judge_cut(original)),
            "_judge_scores_batched": _judge_cut,
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
    long_budget = HABERMAS_TOKENS  # on the {1, 1.5} x power-of-two ladder
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
        "segmented_route_for_habermas_budgets": bool(long_routes) and all(
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



# -- full-prefix fallback session ---------------------------------------------------

#: Session budget that every fused session (and the fused score matrix)
#: declines, as tests/test_score_matrix.py forces it on the JAX backend.
FORCED_SESSION_CAP = 1024
#: Fused vs fallback session, bf16 on the card: the route check's bound.
SESSION_ATOL = 0.1
#: The reference prompt of the session check, cut to its last tokens so the
#: fused session (prefix room max_context - max_steps) and the fallback
#: (the last max_context tokens of prompt + sequence) see the same context.
SESSION_PROMPT_TOKENS = 960
SESSION_STEPS = 3
FALLBACK_TOKENS = 4


def _session_rows_diff(fused_rows, fallback_rows, tokenizer):
    """(max |ref logprob diff| by rank, max |agent logprob diff| over
    candidates both sessions proposed whose string re-encodes to their id,
    top ids equal wherever the fused top-two margin exceeds SESSION_ATOL,
    cells compared)."""
    ref_err = agent_err = 0.0
    tops_equal, compared = True, 0
    for f_row, p_row in zip(fused_rows, fallback_rows):
        f_lps = sorted((c.ref_logprob for c in f_row), reverse=True)
        p_lps = sorted((c.ref_logprob for c in p_row), reverse=True)
        ref_err = max([ref_err] + [abs(a - b) for a, b in zip(f_lps, p_lps)])
        if len(f_lps) > 1 and f_lps[0] - f_lps[1] > SESSION_ATOL:
            tops_equal &= max(f_row, key=lambda c: c.ref_logprob).token_id == max(
                p_row, key=lambda c: c.ref_logprob).token_id
        by_id = {c.token_id: c for c in p_row}
        for cand in f_row:
            other = by_id.get(cand.token_id)
            if other is None or tokenizer.encode(cand.token) != [cand.token_id]:
                continue
            compared += 1
            agent_err = max([agent_err] + [
                abs(a - b) for a, b in zip(cand.agent_logprobs, other.agent_logprobs)
            ])
    return ref_err, agent_err, tops_equal, compared


def fallback_session_path():
    """The token-search config's backend with its session budget forced
    small: ``open_token_search`` falls back to the full-prefix session,
    whose every step is one ``next_token_logprobs`` forward (through
    flash_attention) and per-call scoring (flash_attention) -> (row,
    launches, decode shapes, the K1 case at next_token_topk's last launch,
    the backend's weights)."""
    import pandas as pd
    import torch
    import yaml

    from consensus_tpu_torch.backends.session import (
        PrefixTokenSearchSession,
        SearchSpec,
        open_token_search,
    )
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.experiment import Experiment
    from consensus_tpu_torch.methods import beam_search, finite_lookahead
    from consensus_tpu_torch.methods.prompts import agent_prompt, reference_prompt
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    config = yaml.safe_load((ROOT / TOKEN_SEARCH_CONFIG).read_text())
    started = time.perf_counter()
    backend = TorchBackend(**config["backend_options"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - started
    tok = backend.tokenizer
    cap = backend._session_budget.cap

    # Check (i): one deterministic spec through both sessions.
    scenario = config["scenario"]
    system, user = reference_prompt(scenario["issue"], scenario["agent_opinions"],
                                    variant="beam_search")
    prompt_ids = tok.encode(tok.raw_prompt(user, system))
    spec = SearchSpec(
        ref_system=None, ref_user=tok.decode(prompt_ids[-SESSION_PROMPT_TOKENS:]),
        agent_prompts=tuple(
            agent_prompt(scenario["issue"], o, variant="beam_search")
            for o in scenario["agent_opinions"].values()
        ),
        n_slots=4, k=4, sample=False, max_steps=16,
    )
    fa.launches.reset()
    da.launches.reset()
    next_token_shapes = []

    def next_token(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            next_token_shapes.append((fa.launches.last_shapes, fa.launches.last_spans))
            return out
        return call

    phase_t0 = time.perf_counter()
    with Wrapped(gen, make={"next_token_topk": next_token}):
        fused = open_token_search(backend, spec)
        fused_rows, chosen = [fused.propose()], []
        try:
            for _ in range(SESSION_STEPS):
                # Each slot's best candidate whose string re-encodes to its id:
                # the fallback's state is the string, the fused session's the id.
                picks = [next((c for c in row if tok.encode(c.token) == [c.token_id]), row[0])
                         for row in fused_rows[-1]]
                chosen.append(picks)
                fused_rows.append(fused.advance_and_propose(list(range(spec.n_slots)), picks))
            fused_type = type(fused).__name__
        finally:
            fused.close()
        backend._session_budget.cap = FORCED_SESSION_CAP
        try:
            t0 = time.perf_counter()
            fallback = open_token_search(backend, spec)
            fallback_rows = [fallback.propose()]
            for picks in chosen:
                fallback_rows.append(
                    fallback.advance_and_propose(list(range(spec.n_slots)), picks)
                )
            torch.cuda.synchronize()
            session_s = time.perf_counter() - t0
            parity = [_session_rows_diff(f, p, tok) for f, p in zip(fused_rows, fallback_rows)]

            # Check (ii): both search methods through Experiment on the
            # forced budget, FALLBACK_TOKENS each, one seed.
            exp_config = dict(
                config, experiment_name=config["experiment_name"] + "_fallback",
                output_dir=str(OUT_DIR), num_seeds=1,
                beam_search=dict(config["beam_search"], beam_width=4,
                                 max_tokens=FALLBACK_TOKENS, brushup=False),
                finite_lookahead=dict(config["finite_lookahead"], branching_factor=2,
                                      max_depth=2, max_tokens=FALLBACK_TOKENS, brushup=False),
            )
            sessions = []

            def recording(factory):
                def opened(*args, **kwargs):
                    session = factory(*args, **kwargs)
                    sessions.append(session)
                    return session
                return opened

            with Wrapped(beam_search, make={"open_token_search": recording}), \
                    Wrapped(finite_lookahead, make={"open_token_search": recording}):
                experiment = Experiment(exp_config, backend=backend)
                experiment.run()
                torch.cuda.synchronize()
        finally:
            backend._session_budget.cap = cap
    wall = time.perf_counter() - phase_t0
    launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
    shapes = {key: (count, args) for key, (count, args) in da.launches.shapes.items()}
    on_disk = pd.read_csv(experiment.run_dir / "results.csv", keep_default_na=False)
    methods = config["methods_to_run"]
    steps = [s._step for s in sessions]
    gen_s = dict(zip(on_disk["method"], on_disk["generation_time_s"]))
    max_ref = max(p[0] for p in parity)
    max_agent = max(p[1] for p in parity)
    checks = {
        "fused_session_under_the_budget": fused_type == "TorchTokenSearchSession",
        "factory_fell_back": type(fallback) is PrefixTokenSearchSession,
        "top_ids_equal_where_margin_over_atol": all(p[2] for p in parity),
        "ref_logprobs_within_atol": max_ref <= SESSION_ATOL,
        "agent_logprobs_within_atol": max_agent <= SESSION_ATOL and sum(p[3] for p in parity) > 0,
        "rows_error_free": list(on_disk["method"]) == methods
        and bool((on_disk["error_message"] == "").all()),
        "prefix_sessions_only": len(sessions) == len(methods)
        and all(type(s) is PrefixTokenSearchSession for s in sessions),
        "flash_launches_in_window": launches["flash_attention"] > 0,
        "next_token_rows_bucketed_to_8": bool(next_token_shapes) and all(
            shape is not None and shape[0][0] % 8 == 0 for shape, _ in next_token_shapes
        ),
        "budget_released": backend._session_budget.used == 0,
    }
    row = {
        "phase": "fallback_session_path", "model": backend.config.name,
        "d_model": backend.config.d_model, "n_layers": backend.config.n_layers,
        "forced_session_cap_bytes": FORCED_SESSION_CAP, "init_s": init_s, "phase_s": wall,
        "session_check": {
            "slots": spec.n_slots, "k": spec.k, "steps": SESSION_STEPS,
            "prompt_tokens": SESSION_PROMPT_TOKENS, "fallback_s": session_s,
            "max_ref_logprob_err": max_ref, "max_agent_logprob_err": max_agent,
            "agent_cells_compared": sum(p[3] for p in parity),
            "tolerance": f"logprob atol {SESSION_ATOL}",
        },
        "methods": methods, "max_tokens": FALLBACK_TOKENS, "generation_time_s": gen_s,
        "session_steps": steps,
        "dispatches": [s.dispatch_count for s in sessions],
        # beam: one propose or advance per emitted token; lookahead: one
        # trunk call plus one tree level per emitted token.
        "s_per_step": {m: gen_s[m] / (n + 1) for m, n in zip(on_disk["method"], steps)},
        "statement_chars": [len(t) for t in on_disk["statement"].astype(str)],
        "launches": launches,
        "next_token_calls": len(next_token_shapes),
        "next_token_flash_shape": next_token_shapes[-1][0] if next_token_shapes else None,
        "results_csv": str(experiment.run_dir.relative_to(ROOT) / "results.csv"),
        "checks": checks, "ok": all(checks.values()),
    }
    case = None
    if next_token_shapes and next_token_shapes[-1][0] is not None:
        (q_shape, k_shape), (lens, starts) = next_token_shapes[-1]
        case = flash_case("next_token_topk, last launch's shape and spans", q_shape[0],
                          q_shape[1], q_shape[2], k_shape[2], q_shape[3], lens.tolist(),
                          starts.tolist(), seed=37)
        checks["next_token_flash_case_within_tolerance"] = case["ok"]
        row["ok"] = all(checks.values())
    params = backend.params
    del backend, experiment, fallback, sessions
    torch.cuda.empty_cache()
    return row, launches, shapes, case, params


# -- the repo's own config through the sweep runner ---------------------------------

SWEEP_ROOT = "configs/appendix"
SWEEP_CORPUS_REF = "corpus:v2:polarized-0004"
POST_HOC_ATOL = 1e-3


def sweep_path(params=None):
    """``configs/appendix/llama/scenario_1/beam_search.yaml``, unedited, as
    the port's ``run_sweep`` finds it, through ``run_pipeline`` with one
    seed; then ``post_hoc_evaluate`` on its run dir and one welfare-gap
    table of a corpus scenario -> (row, launches, decode shapes).  The
    backend is ``get_backend(config["backend"], **backend_options)`` (the
    config says ``tpu``) plus ``use_decode_attention``, the port's switch
    that sends search steps and the brushups' decode through
    decode_attention; ``params`` (the same seeded random weights) skips
    drawing them again."""
    import numpy as np
    import pandas as pd
    import torch
    import yaml

    from consensus_tpu_torch.backends import get_backend
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.cli import post_hoc_evaluate, run_sweep
    from consensus_tpu_torch.cli import run_experiment_with_eval as pipeline
    from consensus_tpu_torch.data.scenarios import fairness, registry
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    paths = run_sweep.find_config_files(str(ROOT / SWEEP_ROOT), ["llama"], [1], ["beam_search"])
    config = yaml.safe_load(paths[0].read_text())
    started = time.perf_counter()
    backend = get_backend(config["backend"], **config["backend_options"],
                          use_decode_attention=True, params=params, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - started
    fa.launches.reset()
    da.launches.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_dir = pathlib.Path(pipeline.run_pipeline(
        str(paths[0]), skip_comparative_ranking=True,
        config_overrides={"num_seeds": 1, "output_dir": str(OUT_DIR)}, backend=backend,
    ))
    torch.cuda.synchronize()
    pipeline_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
    shapes = {key: (count, args) for key, (count, args) in da.launches.shapes.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The same runs one after another, in the same call: the concurrent
    # widths' fused sessions take turns on the device, and must not lose to
    # this (the pipeline's window above also holds the evaluation, so the
    # two are compared by the experiments' own walls).
    from consensus_tpu_torch.experiment import Experiment

    sequential = Experiment(dict(config, num_seeds=1, output_dir=str(OUT_DIR),
                                 concurrent_execution=False,
                                 experiment_name="sequential_" + config["experiment_name"]),
                            backend=backend)
    sequential.run()
    generation_wall_s = {
        mode: json.loads((d / "token_counts.json").read_text())["wall_s"]
        for mode, d in (("concurrent", run_dir), ("sequential", sequential.run_dir))}

    on_disk = pd.read_csv(run_dir / "results.csv", keep_default_na=False)
    models = config["models"]["evaluation_models"]
    eval_path = {m: run_dir / "evaluation" / m / "seed_0" / "evaluation_results.csv" for m in models}

    def read_evaluation(path):
        # The evaluator writes an empty file when no statement was scorable.
        try:
            return pd.read_csv(path)
        except (FileNotFoundError, pd.errors.EmptyDataError):
            return None

    evaluated = {m: read_evaluation(p) for m, p in eval_path.items()}

    # Re-score the run dir with llama3-8b: the same numbers as the pipeline's.
    t0 = time.perf_counter()
    post_hoc_evaluate.evaluate_run_dir(str(run_dir), ["llama3-8b"], backend_name=backend)
    torch.cuda.synchronize()
    post_hoc_s = time.perf_counter() - t0
    rescored = read_evaluation(eval_path["llama3-8b"])
    agents = list(config["scenario"]["agent_opinions"])
    per_agent = [f"{prefix}{a}" for a in agents for prefix in (
        "cosine_similarity_", "utility_cosine_similarity_", "avg_logprob_", "utility_avg_logprob_")]
    first = evaluated["llama3-8b"]
    post_hoc_err = (
        float(np.abs(rescored[per_agent].to_numpy(float) - first[per_agent].to_numpy(float)).max())
        if first is not None and rescored is not None and len(first) == len(rescored)
        else float("inf")
    )

    # One welfare-gap table of a corpus scenario through the registry.
    t0 = time.perf_counter()
    scenario = registry.resolve_scenario_ref(SWEEP_CORPUS_REF)
    table = fairness.welfare_gap_table(backend, scenario)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    table_complete = table["n_agents"] == len(scenario["agent_opinions"]) and all(
        set(channel["winners"]) == set(fairness.RULES)
        and all(w in range(table["n_candidates"]) for w in channel["winners"].values())
        and all(len(v) == table["n_candidates"] and np.isfinite(v).all()
                for v in channel["welfare"].values())
        for channel in table["channels"].values()
    )

    widths = sorted(config["beam_search"]["beam_width"])
    checks = {
        "found_one_unedited_config": len(paths) == 1 and config["backend"] == "tpu",
        "backend_is_torch_on_cuda": isinstance(backend, TorchBackend)
        and backend.device.type == "cuda",
        "four_error_free_rows": len(on_disk) == len(widths)
        and list(on_disk["method"]) == ["beam_search"] * len(widths)
        and sorted(on_disk["param_beam_width"].astype(int)) == widths
        and bool((on_disk["error_message"] == "").all()),
        "evaluation_files": all(f is not None and len(f) > 0 for f in evaluated.values()),
        "aggregated_metrics": (run_dir / "evaluation" / "improved_aggregate"
                               / "aggregated_metrics.csv").exists(),
        "decode_launches": launches["decode_attention"] > 0,
        "post_hoc_matches_pipeline": post_hoc_err <= POST_HOC_ATOL,
        "welfare_table_complete": table_complete,
    }
    row = {
        "phase": "sweep_path", "config": str(paths[0].relative_to(ROOT)),
        "model": backend.config.name, "backend": config["backend"],
        "init_s": init_s, "pipeline_s": pipeline_s, "post_hoc_s": post_hoc_s,
        "welfare_table_s": table_s, "generation_wall_s": generation_wall_s,
        "generation_time_s": dict(zip(on_disk["param_beam_width"].astype(int),
                                      on_disk["generation_time_s"])),
        "search_advances": backend.call_counts["search_advances"],
        "statement_chars": [len(t) for t in on_disk["statement"].astype(str)],
        "evaluation_models": models, "post_hoc_max_err": post_hoc_err,
        "post_hoc_tolerance": f"per-agent utilities atol {POST_HOC_ATOL}",
        "welfare_table": {
            "ref": SWEEP_CORPUS_REF, "n_agents": table["n_agents"],
            "n_candidates": table["n_candidates"], "matrix_path": table["matrix_path"],
            "winners": {k: c["winners"] for k, c in table["channels"].items()},
            "rules_separated": {k: c["rules_separated"] for k, c in table["channels"].items()},
        },
        "launches": launches, "peak_memory_gb": peak_gb,
        "decode_shapes": [
            {"q": list(q), "trunk": list(t), "tail": list(l), "launches": count}
            for (q, t, l), (count, _) in shapes.items()
        ],
        "results_csv": str(run_dir.relative_to(ROOT) / "results.csv"),
        "checks": checks, "ok": all(checks.values()),
    }
    del backend
    torch.cuda.empty_cache()
    return row, launches, shapes


# -- MCTS and its rollouts on gemma2-2b ----------------------------------------------

MCTS_EXAMPLE_CONFIG = "configs/examples/mcts.yaml"
MCTS_SWEEP_ROOT = "configs/north_star"
#: Depth cuts of the north_star config (100 tokens, 5 seeds in the file).
MCTS_SWEEP_TOKENS = 4
#: The rollout check's session steps: its cache's tail width, and so the
#: shapes whose rounding the batched and single rollouts are held to.
ROLLOUT_MAX_STEPS = 8
#: The methods' own timing mode: no node or path is terminal, so the search
#: runs its whole budget (random weights propose an EOS within a few tokens).
PIN_BUDGET = {"pin_budget": True}
#: The example config over the forced full-prefix fallback: 4 of its 10 tokens.
MCTS_FALLBACK_TOKENS = 4
#: Finite lookahead with leaf rollouts, off and on speculative.
LOOKAHEAD_ROLLOUT = {"max_depth": 2, "rollout_depth": 4, "max_tokens": 6, "brushup": False,
                     "speculative_rollouts": [False, True], **PIN_BUDGET}
#: Rollout routes compared on the card (batched vs single, speculative vs
#: sequential): token ids equal wherever the reference draw's margin (top
#: score minus the runner-up, Gumbel noise included) exceeds this; agent
#: totals within ROLLOUT_TOTAL_ATOL where the ids agree.  Two bf16 routes
#: of different batch shapes round differently, as the route checks above
#: measure (logprob gaps up to ROUTE_ATOL), so a draw closer than that to a
#: tie may flip: its first divergence is reported, not required equal.
ROLLOUT_MARGIN = ROUTE_ATOL
ROLLOUT_TOTAL_ATOL = 0.1
ROLLOUT_WAVE = 8


def _rollout_margin(backend, session, path, ref_ids, step, salt, depth):
    """Margin of the draw at rollout ``step`` of the stream ``ref_ids`` on
    ``path``: the session's teacher-forced reference logprobs there over the
    temperature, plus that draw's Gumbel noise, top minus runner-up."""
    import torch
    from consensus_tpu_torch.models import stepper
    from consensus_tpu_torch.utils import threefry

    device = session._state.cur_pos.device
    draft = list(ref_ids[:step]) + [0] * (depth - step)
    suffix = torch.tensor([[c.token_id for c in path]], dtype=torch.int32, device=device)
    lp = stepper.rollout_verify_logprobs(
        backend.params, backend.config, session._state, session._step, suffix,
        torch.tensor([draft], dtype=torch.int32, device=device),
    )[0, 0, step]
    temperature = session.spec.temperature
    if temperature > 0:
        key = threefry.fold_in(threefry.fold_in(threefry.fold_in(session._base_key, 2), salt),
                               step)
        lp = lp / temperature + threefry.gumbel(key, (lp.shape[-1],))
    top2 = torch.topk(lp, 2).values
    return (top2[0] - top2[1]).item()


def _compare_rollouts(backend, session, wave, salts, depth, got, ref):
    """Per path: equal ids and totals, or the first divergence and the
    reference draw's margin there."""
    rows = []
    for path, salt, g, r in zip(wave, salts, got, ref):
        ids, ref_ids = g[0], r[0]
        first = next((t for t in range(min(len(ids), len(ref_ids))) if ids[t] != ref_ids[t]),
                     None if len(ids) == len(ref_ids) else min(len(ids), len(ref_ids)))
        if first is None:
            err = max(abs(a - b) for a, b in zip(g[2], r[2]))
            rows.append({"ids_equal": True, "tokens": len(ids), "max_total_err": err,
                         "ok": g[3] and r[3] and err <= ROLLOUT_TOTAL_ATOL})
        else:
            margin = _rollout_margin(backend, session, path, ref_ids, first, salt, depth)
            rows.append({"ids_equal": False, "first_divergence": first, "margin": margin,
                         "ok": margin <= ROLLOUT_MARGIN})
    return rows


def mcts_rollout_check(backend, config):
    """One north_star MCTS session spec, sequential and speculative: a wave
    of ROLLOUT_WAVE paths (spans 1 and 2) through ``rollout_many`` against
    ``rollout_from`` on each path alone, then the speculative session's
    ``rollout_many`` against the sequential one."""
    import dataclasses

    import torch
    from consensus_tpu_torch.backends.session import SearchSpec
    from consensus_tpu_torch.methods.beam_search import BIAS_AGAINST_TOKENS
    from consensus_tpu_torch.methods.mcts import FAILURE_REWARD
    from consensus_tpu_torch.methods.prompts import agent_prompt, reference_prompt

    scenario, cfg = config["scenario"], config["mcts"]
    opinions = scenario["agent_opinions"]
    system, user = reference_prompt(scenario["issue"], opinions, variant="mcts")
    depth = int(cfg["rollout_depth"])
    spec = SearchSpec(
        ref_system=system, ref_user=user,
        agent_prompts=tuple(agent_prompt(scenario["issue"], o, variant="mcts")
                            for o in opinions.values()),
        n_slots=1, k=int(cfg["expansion_sample_width"]), temperature=1.0, seed=config["seed"],
        sample=True, bias_against_tokens=BIAS_AGAINST_TOKENS, max_steps=ROLLOUT_MAX_STEPS,
        failure_logprob=FAILURE_REWARD, spec_draft_len=depth,
    )
    plain = backend.open_fused_token_search(spec)
    spec_session = backend.open_fused_token_search(dataclasses.replace(spec, speculative=True))
    salts = list(range(1, ROLLOUT_WAVE + 1))
    try:
        roots = [s.propose()[0] for s in (plain, spec_session)]
        nexts = [s.advance_and_propose([0], [root[0]])[0] for s, root in
                 zip((plain, spec_session), roots)]
        children = plain.propose_suffixes([[nexts[0][0]]], salt=1)[0]
        wave = [[c] for c in nexts[0]] + [[nexts[0][0], c] for c in children]
        wave = wave[:ROLLOUT_WAVE]
        same_trunk = [c.token_id for c in roots[0]] == [c.token_id for c in roots[1]] and [
            c.token_id for c in nexts[0]] == [c.token_id for c in nexts[1]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched = plain.rollout_many(wave, depth, salts)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        singles = [plain.rollout_from(p, depth, s) for p, s in zip(wave, salts)]
        torch.cuda.synchronize()
        singles_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        speculative = spec_session.rollout_many(wave, depth, salts)
        torch.cuda.synchronize()
        speculative_s = time.perf_counter() - t0
        batched_vs_single = _compare_rollouts(backend, plain, wave, salts, depth, batched, singles)
        spec_vs_sequential = _compare_rollouts(backend, plain, wave, salts, depth, speculative,
                                               batched)
        drafts = dict(spec_session.draft_tokens)
    finally:
        plain.close()
        spec_session.close()
    return {
        "wave": len(wave), "spans": sorted({len(p) for p in wave}), "depth": depth,
        "same_trunk_both_sessions": same_trunk,
        "rollout_many_s": batched_s, "rollout_from_s_total": singles_s,
        "speculative_rollout_many_s": speculative_s,
        "batched_vs_single": batched_vs_single, "speculative_vs_sequential": spec_vs_sequential,
        "draft_tokens": drafts,
        "accepted_draft_tokens_per_verify_dispatch":
            drafts["verified"] / max(drafts["verify_dispatches"], 1),
        "tolerance": f"ids equal where the reference margin > {ROLLOUT_MARGIN}; "
                     f"agent totals atol {ROLLOUT_TOTAL_ATOL}",
        "ok": same_trunk and all(r["ok"] for r in batched_vs_single + spec_vs_sequential)
        and drafts["verify_dispatches"] > 0,
    }


def mcts_path():
    """MCTS and its rollouts on one gemma2-2b ``TorchBackend`` (the
    north_star ``backend_options`` plus ``use_decode_attention``), counts
    zeroed just before and read just after -> (row, launches, decode
    shapes, the K1 case at the evaluation's last launch).  (a) the example
    MCTS config through ``Experiment``; (b) the north_star scenario-1 MCTS
    config as ``run_sweep`` finds it, through ``run_pipeline`` with its
    evaluation, pinned to its whole budget; (c) ``mcts_rollout_check``; (d)
    the example config over the forced full-prefix fallback session; (e)
    finite lookahead with leaf rollouts, sequential and speculative."""
    import pandas as pd
    import torch
    import yaml

    from consensus_tpu_torch.backends import get_backend, torch_backend
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.cli import run_experiment_with_eval as pipeline
    from consensus_tpu_torch.cli import run_sweep
    from consensus_tpu_torch.evaluation import StatementEvaluator
    from consensus_tpu_torch.experiment import Experiment
    from consensus_tpu_torch.methods import finite_lookahead, mcts
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    paths = run_sweep.find_config_files(str(ROOT / MCTS_SWEEP_ROOT), ["gemma"], [1], ["mcts"])
    sweep_config = yaml.safe_load(paths[0].read_text())
    example = yaml.safe_load((ROOT / MCTS_EXAMPLE_CONFIG).read_text())
    lookahead_path = paths[0].with_name("finite_lookahead.yaml")
    lookahead = yaml.safe_load(lookahead_path.read_text())
    started = time.perf_counter()
    backend = get_backend(sweep_config["backend"], **sweep_config["backend_options"],
                          use_decode_attention=True, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - started

    sessions = []  # (part, session class name)
    statements = []  # (part, seconds, search_stats or None)
    part = {"name": ""}
    timings = {}  # rollout function -> [calls, seconds, decode steps]

    def opened(original):
        def call(backend_, spec):
            session = original(backend_, spec)
            # A concurrent run's session comes through BatchingBackend,
            # which wraps it to take turns on the device.
            sessions.append((part["name"], type(getattr(session, "session", session)).__name__))
            return session
        return call

    def statement_timer(original):
        def call(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = original(self, *args, **kwargs)
            torch.cuda.synchronize()
            stats = dict(getattr(self, "search_stats", {}) or {})
            stats.pop("visit_log", None)
            statements.append((part["name"], time.perf_counter() - t0, stats))
            return out
        return call

    def rollout_timer(name, depth_of):
        def make(original):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = original(*args, **kwargs)
                torch.cuda.synchronize()
                entry = timings.setdefault(name, [0, 0.0, 0])
                entry[0] += 1
                entry[1] += time.perf_counter() - t0
                entry[2] += depth_of(args)
                return out
            return call
        return make

    evaluation_s = []

    def evaluation_timer(original):
        def call(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = original(self, *args, **kwargs)
            torch.cuda.synchronize()
            evaluation_s.append(time.perf_counter() - t0)
            return out
        return call

    flash_calls = Wrapped(torch_backend, ("_embed_forward", "token_logprobs",
                                          "token_logprobs_streamed"))
    patches = [
        Wrapped(mcts, make={"open_token_search": opened}),
        Wrapped(finite_lookahead, make={"open_token_search": opened}),
        Wrapped(mcts.MCTSGenerator, make={"generate_statement": statement_timer}),
        Wrapped(finite_lookahead.FiniteLookaheadGenerator,
                make={"generate_statement": statement_timer}),
        Wrapped(torch_backend, make={
            "rollout_scored": rollout_timer("rollout_scored", lambda a: a[6]),
            "rollout_scored_many": rollout_timer("rollout_scored_many", lambda a: a[7]),
            "rollout_verify_many": rollout_timer("rollout_verify_many", lambda a: 1),
        }),
        Wrapped(StatementEvaluator, make={"evaluate_results_file": evaluation_timer}),
        flash_calls,
    ]
    decode_steps = Wrapped(gen, ("forward_trunk_tail", "next_token_topk"))
    phase_s, frames = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for patch in patches + [decode_steps]:
            stack.enter_context(patch)
        fa.launches.reset()
        da.launches.reset()

        part["name"] = "a_example"
        t0 = time.perf_counter()
        run = Experiment(dict(example, output_dir=str(OUT_DIR)), backend=backend)
        run.run()
        torch.cuda.synchronize()
        phase_s["a_example"] = time.perf_counter() - t0
        frames["a_example"] = run.run_dir

        part["name"] = "b_north_star"
        t0 = time.perf_counter()
        mcts_cut = dict(sweep_config["mcts"], max_tokens=MCTS_SWEEP_TOKENS, **PIN_BUDGET)
        flash_before = fa.launches.count
        forwards_before = sum(flash_calls.calls.values())
        run_dir = pathlib.Path(pipeline.run_pipeline(
            str(paths[0]), skip_comparative_ranking=True,
            config_overrides={"num_seeds": 1, "output_dir": str(OUT_DIR), "mcts": mcts_cut},
            backend=backend,
        ))
        torch.cuda.synchronize()
        phase_s["b_north_star"] = time.perf_counter() - t0
        frames["b_north_star"] = run_dir
        evaluation_flash = fa.launches.count - flash_before
        evaluation_forwards = sum(flash_calls.calls.values()) - forwards_before
        last_flash = (fa.launches.last_shapes,
                      tuple(t.tolist() for t in fa.launches.last_spans)) if evaluation_flash else None

        part["name"] = "c_rollout_check"
        t0 = time.perf_counter()
        rollout_check = mcts_rollout_check(backend, sweep_config)
        phase_s["c_rollout_check"] = time.perf_counter() - t0

        part["name"] = "d_fallback"
        cap = backend._session_budget.cap
        backend._session_budget.cap = FORCED_SESSION_CAP
        try:
            t0 = time.perf_counter()
            fallback_config = dict(
                example, output_dir=str(OUT_DIR),
                experiment_name=example["experiment_name"] + "_fallback",
                mcts=dict(example["mcts"], max_tokens=MCTS_FALLBACK_TOKENS),
            )
            run = Experiment(fallback_config, backend=backend)
            run.run()
            torch.cuda.synchronize()
            phase_s["d_fallback"] = time.perf_counter() - t0
            frames["d_fallback"] = run.run_dir
        finally:
            backend._session_budget.cap = cap

        part["name"] = "e_lookahead"
        t0 = time.perf_counter()
        lookahead_config = dict(
            lookahead, output_dir=str(OUT_DIR), num_seeds=1,
            experiment_name=lookahead["experiment_name"] + "_rollouts",
            finite_lookahead=dict(lookahead["finite_lookahead"], **LOOKAHEAD_ROLLOUT),
        )
        run = Experiment(lookahead_config, backend=backend)
        run.run()
        torch.cuda.synchronize()
        phase_s["e_lookahead"] = time.perf_counter() - t0
        frames["e_lookahead"] = run.run_dir
        launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
        shapes = {key: (count, args) for key, (count, args) in da.launches.shapes.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    results = {name: pd.read_csv(path / "results.csv", keep_default_na=False)
               for name, path in frames.items()}
    n_layers = backend.config.n_layers
    advances = backend.call_counts["search_advances"]
    gen_steps = decode_steps.calls["forward_trunk_tail"]
    forwards = sum(flash_calls.calls.values()) + decode_steps.calls["next_token_topk"]
    eval_frame = None
    eval_file = frames["b_north_star"] / "evaluation" / "gemma2-2b" / "seed_0" / "evaluation_results.csv"
    if eval_file.exists():
        eval_frame = pd.read_csv(eval_file)
    expected_sessions = {"a_example": "TorchTokenSearchSession",
                         "b_north_star": "TorchTokenSearchSession",
                         "d_fallback": "PrefixTokenSearchSession",
                         "e_lookahead": "TorchTokenSearchSession"}
    per_statement = {}
    for name, seconds, stats in statements:
        entry = per_statement.setdefault(name, [])
        entry.append({"s": seconds, **{k: stats.get(k) for k in
                                       ("device_dispatches", "waves", "selections", "collisions")
                                       if k in stats}})
    b_stats = per_statement.get("b_north_star", [{}])[0]
    many = timings.get("rollout_scored_many", [0, 0.0, 0])
    checks = {
        "found_one_unedited_config": len(paths) == 1 and sweep_config["backend"] == "tpu"
        and example["backend_options"] == sweep_config["backend_options"],
        "backend_is_torch_on_cuda": isinstance(backend, TorchBackend)
        and backend.device.type == "cuda" and backend.config.name == "gemma2-2b",
        "rows_error_free": all(
            len(frame) > 0 and bool((frame["error_message"] == "").all())
            and not frame["statement"].astype(str).str.startswith("[ERROR").any()
            for frame in results.values()
        ) and list(results["e_lookahead"]["param_speculative_rollouts"].astype(str)) == [
            "False", "True"],
        "sessions_of_the_expected_class": bool(sessions) and all(
            cls == expected_sessions.get(name, cls) for name, cls in sessions
        ) and {name for name, _ in sessions} >= set(expected_sessions),
        "rollout_scored_many_called": many[0] > 0,
        "rollout_verify_many_called": timings.get("rollout_verify_many", [0])[0] > 0,
        "rollout_check": rollout_check["ok"],
        "decode_launches_eq_layers_x_advances_and_decode_steps":
            launches["decode_attention"] == n_layers * (advances + gen_steps) and advances > 0,
        "flash_launches_eq_layers_x_forwards":
            launches["flash_attention"] == n_layers * forwards and evaluation_flash > 0
            and evaluation_flash == n_layers * evaluation_forwards,
        "evaluation_file": eval_frame is not None and list(eval_frame["method"]) == ["mcts"],
        "aggregated_metrics": (frames["b_north_star"] / "evaluation" / "improved_aggregate"
                               / "aggregated_metrics.csv").exists(),
    }
    flash_case_row = None
    if last_flash is not None:
        (q_shape, k_shape), (lens, starts) = last_flash
        c = backend.config
        flash_case_row = flash_case(
            "gemma2-2b evaluation, last launch's shape and spans", q_shape[0], q_shape[1],
            q_shape[2], k_shape[2], q_shape[3], lens, starts, seed=41, scale=c.q_scale,
            softcap=c.attn_softcap,
        )
    checks["gemma2_2b_flash_case_within_tolerance"] = bool(flash_case_row and flash_case_row["ok"])
    row = {
        "phase": "mcts_path", "model": backend.config.name, "d_model": backend.config.d_model,
        "n_layers": n_layers, "heads": [backend.config.n_heads, backend.config.n_kv_heads],
        "head_dim": backend.config.head_dim, "vocab": backend.config.vocab_size,
        "configs": {"a_example": MCTS_EXAMPLE_CONFIG,
                    "b_north_star": str(paths[0].relative_to(ROOT)),
                    "e_lookahead": str(lookahead_path.relative_to(ROOT))},
        "cuts": {"b_north_star": {"num_seeds": 1, "max_tokens": MCTS_SWEEP_TOKENS, **PIN_BUDGET},
                 "d_fallback": {"max_tokens": MCTS_FALLBACK_TOKENS},
                 "e_lookahead": {k: v for k, v in LOOKAHEAD_ROLLOUT.items()}},
        "init_s": init_s, "phase_s": phase_s, "evaluation_s": evaluation_s,
        "s_per_statement": {name: [e["s"] for e in entries]
                            for name, entries in per_statement.items()},
        "statement_stats": per_statement,
        "s_per_wave_north_star": b_stats.get("s", 0.0) / max(b_stats.get("waves") or 1, 1),
        "dispatches_per_statement": {name: [e.get("device_dispatches") for e in entries]
                                     for name, entries in per_statement.items()},
        "rollouts": {name: {"calls": c, "seconds": s, "steps": n}
                     for name, (c, s, n) in timings.items()},
        "s_per_rollout_step": many[1] / max(many[2], 1),
        "fallback_s_per_token": phase_s["d_fallback"] / MCTS_FALLBACK_TOKENS,
        "search_advances": advances, "generate_decode_steps": gen_steps,
        "flash_forwards": {**flash_calls.calls, "next_token_topk": decode_steps.calls["next_token_topk"]},
        "evaluation_flash_launches": evaluation_flash,
        "sessions": sessions,
        "statement_chars": {name: [len(t) for t in frame["statement"].astype(str)]
                            for name, frame in results.items()},
        "lookahead_speculative_statements_equal": len(set(
            results["e_lookahead"]["statement"].astype(str))) == 1,
        "rollout_check": rollout_check,
        "launches": launches, "peak_memory_gb": peak_gb,
        "decode_shapes": [
            {"q": list(q), "trunk": list(t), "tail": list(l), "launches": count}
            for (q, t, l), (count, _) in shapes.items()
        ],
        "gemma2_2b_flash_case": flash_case_row,
        "results_csv": {name: str(path.relative_to(ROOT) / "results.csv")
                        for name, path in frames.items()},
        "checks": checks, "ok": all(checks.values()),
    }
    return row, launches, shapes, flash_case_row, backend


# -- co-batched concurrent runs on gemma2-2b -------------------------------------

CONCURRENT_ROOT = "configs/north_star"
#: Depth cuts of the headline config (habermas_vs_best_of_n) and of
#: scenario 1's beam_search config for the time limit; widths unchanged.
CONCURRENT_CUTS = {
    "num_seeds": 1,
    "best_of_n": {"n": [1, 3, 5, 10], "max_tokens": 16},
    "habermas_machine": {"num_candidates": [1, 3], "max_tokens": 16},
}
CONCURRENT_BEAM_CUTS = {"num_seeds": 1, "beam_search": {"beam_width": [2, 4], "max_tokens": 8}}
#: A concurrent row differing from its sequential twin passes when the
#: first differing token sits at a draw whose top-two margin (sequential
#: stream, teacher-forced) is under this: the rule of ``_compare_rollouts``.
DRAW_MARGIN = ROUTE_ATOL
#: Tolerance of a replayed merged score matrix where the replay is not
#: bit-identical (an op not run-to-run deterministic on the card).
REPLAY_ATOL = 1e-3
#: Divergent generate requests whose margin is computed (one forward each).
MAX_MARGIN_CHECKS = 48


def _request_key(r):
    return (r.system_prompt, r.user_prompt, r.seed, float(r.temperature), r.max_tokens)


def _draw_margin(backend, request, ids, step):
    """Margin of the draw at ``step`` of the token stream ``ids`` generated
    for ``request``: the teacher-forced logits of the prompt and
    ``ids[:step]`` over the temperature, plus that step's Gumbel noise from
    the request's row key (greedy: the logits alone), top minus runner-up."""
    import torch
    from consensus_tpu_torch.models.transformer import forward
    from consensus_tpu_torch.utils import threefry

    # The prompt is cut to max_context as generation cuts it; the generated
    # tokens follow it at positions max_context and on (cutting prompt and
    # tokens together would drop prompt tokens the draw attended).
    prompt = backend.tokenizer.encode(backend._render_prompt(request), add_bos=True)
    seq = prompt[-backend.max_context:] + list(ids[:step])
    device = backend.device
    tokens = torch.tensor([seq], dtype=torch.int32, device=device)
    positions = torch.arange(len(seq), dtype=torch.int32, device=device)[None]
    with torch.inference_mode():
        logits, _ = forward(backend.params, backend.config, tokens, positions,
                            torch.ones_like(tokens, dtype=torch.bool))
        lp = logits[0, -1].float()
        if request.temperature > 0:
            key = backend._row_keys("generate", [request.seed])
            for _ in range(step + 1):
                pairs = threefry.split(key)
                key, sub = pairs[:, 0], pairs[:, 1]
            lp = lp / request.temperature + threefry.gumbel(sub, (lp.shape[-1],))[0]
        top2 = torch.topk(lp, 2).values
    return (top2[0] - top2[1]).item()


def _compare_generations(backend, concurrent, sequential):
    """Every seeded generate request of both modes: ids equal, or the first
    difference and the sequential draw's margin there."""
    out = {"equal": 0, "diverged": [], "only_one_mode": 0, "unseeded": 0}
    for key, got in concurrent.items():
        if key[2] is None:
            out["unseeded"] += 1
            continue
        if key not in sequential:
            out["only_one_mode"] += 1
            continue
        request, ref_ids = sequential[key][0]
        for _, ids in got:
            first = next((t for t in range(min(len(ids), len(ref_ids))) if ids[t] != ref_ids[t]),
                         None if len(ids) == len(ref_ids) else min(len(ids), len(ref_ids)))
            if first is None:
                out["equal"] += 1
            elif len(out["diverged"]) < MAX_MARGIN_CHECKS:
                margin = _draw_margin(backend, request, ref_ids, first)
                out["diverged"].append({"seed": key[2], "temperature": key[3], "step": first,
                                        "margin": margin, "ok": margin < DRAW_MARGIN})
            else:
                out["diverged"].append({"step": first, "ok": False, "margin": None})
    return out


def _replay_check(backend, records):
    """Replay one recorded merged ``generate`` (the cheapest: rows x
    max_tokens) and one merged ``score_matrix`` on the inner backend; each
    waiter's slice must equal the replay's rows: bit for bit, or (an op not
    run-to-run deterministic on the card) token streams whose first
    difference sits at a draw of margin under REPLAY_ATOL, utilities within
    REPLAY_ATOL."""
    import numpy as np

    out = {}
    generates = [r for r in records if r[0] == "generate"]
    if generates:
        _, merged, waiters = min(generates, key=lambda r: len(r[1]) * max(
            q.max_tokens for q in r[1]))
        replay = backend.generate(merged)
        cursor, exact, near = 0, True, True
        for n, result, error in waiters:
            if error is not None:
                exact = near = False
                continue
            for got, again, request in zip(result, replay[cursor:cursor + n],
                                           merged[cursor:cursor + n]):
                if got.token_ids != again.token_ids:
                    exact = False
                    a, b = got.token_ids, again.token_ids
                    first = next((t for t in range(min(len(a), len(b))) if a[t] != b[t]),
                                 min(len(a), len(b)))
                    near = near and _draw_margin(backend, request, b, first) < REPLAY_ATOL
            cursor += n
        out["generate"] = {"waiters": len(waiters), "rows": len(merged),
                           "max_tokens": max(q.max_tokens for q in merged),
                           "bit_identical": exact, "ok": exact or near}
    matrices = [r for r in records if r[0] == "score_matrix"]
    if matrices:
        _, merged, waiters = min(matrices, key=lambda r: len(r[1]))
        replay = backend.score_matrix(merged)
        cursor, err = 0, 0.0
        for n, result, error in waiters:
            if error is not None:
                err = float("inf")
                continue
            for got, again in zip(result, replay[cursor:cursor + n]):
                err = max(err, float(np.abs(np.asarray(got.utilities, np.float64)
                                            - np.asarray(again.utilities, np.float64)).max()))
            cursor += n
        out["score_matrix"] = {"waiters": len(waiters), "matrices": len(merged),
                               "bit_identical": err == 0.0, "max_abs_err": err,
                               "ok": err <= REPLAY_ATOL}
    out["ok"] = bool(out) and all(v["ok"] for v in out.values())
    return out


def _histogram_quantile(series, boundaries, q):
    """Upper bound of the histogram bucket holding quantile ``q``."""
    target, seen = q * series["count"], 0
    for bound, n in zip(list(boundaries) + [float("inf")], series["bucket_counts"]):
        seen += n
        if seen >= target:
            return bound
    return float("inf")


def _batching_summary(metrics):
    """Per kind: flushes by reason, mean batch fill, queue-wait p50 / p90
    (bucket upper bounds), from a cell's metrics.json delta."""
    families = metrics["metrics"]["families"]
    out = {}
    for series in families.get("batching_batch_fill_sessions", {}).get("series", []):
        kind = series["labels"]["kind"]
        out.setdefault(kind, {})["mean_fill"] = series["sum"] / series["count"]
        out[kind]["max_fill"] = series["max"]
    wait = families.get("batching_queue_wait_seconds", {})
    for series in wait.get("series", []):
        kind = series["labels"]["kind"]
        out.setdefault(kind, {}).update(
            queue_wait_p50_le_s=_histogram_quantile(series, wait["bucket_boundaries"], 0.5),
            queue_wait_p90_le_s=_histogram_quantile(series, wait["bucket_boundaries"], 0.9),
            queue_wait_mean_s=series["sum"] / series["count"],
        )
    for series in families.get("batching_flushes_total", {}).get("series", []):
        labels = series["labels"]
        out.setdefault(labels["kind"], {}).setdefault("flushes", {})[labels["reason"]] = \
            series["value"]
    return out


def concurrent_path(backend):
    """The reference's default execution mode on the gemma2-2b backend of
    ``mcts_path`` (the north_star ``backend_options`` plus
    ``use_decode_attention``): concurrent runs whose calls merge through
    ``BatchingBackend``, against the same runs one after another -> (row,
    launches, decode shapes).  (a) the headline config (habermas_vs_best_of_n)
    as ``run_sweep`` finds it, through ``run_pipeline`` with its evaluation,
    in the timing mode; (b) scenario 1's beam_search config through
    ``Experiment``, its fused sessions on worker threads; both cut by
    CONCURRENT_CUTS / CONCURRENT_BEAM_CUTS."""
    import json as json_
    import numpy as np
    import pandas as pd
    import torch
    import yaml

    from consensus_tpu_torch.backends import batching as batching_mod
    from consensus_tpu_torch.backends.torch_backend import TorchBackend, TorchTokenSearchSession
    from consensus_tpu_torch.cli import run_experiment_with_eval as pipeline
    from consensus_tpu_torch.cli import run_sweep
    from consensus_tpu_torch.experiment import Experiment
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    root = str(ROOT / CONCURRENT_ROOT)
    (headline_path,) = run_sweep.find_config_files(root, ["gemma"], [1], ["habermas_vs_best_of_n"])
    (beam_path,) = run_sweep.find_config_files(root, ["gemma"], [1], ["beam_search"])
    headline = yaml.safe_load(headline_path.read_text())
    beam = yaml.safe_load(beam_path.read_text())

    def cut(config, cuts, **extra):
        out = dict(config, output_dir=str(OUT_DIR), **extra)
        for key, value in cuts.items():
            out[key] = dict(config[key], **value) if isinstance(value, dict) else value
        return out

    # One record per merged flush with two or more waiters: (kind, merged
    # requests, [(rows, result, error) per waiter]).
    records = []

    def recording(original):
        def call(self, snapshot, reason):
            original(self, snapshot, reason)
            for kind in ("generate", "score_matrix"):
                queue = snapshot[kind]
                if len(queue) >= 2:
                    records.append((kind, [r for e in queue for r in e.requests],
                                    [(len(e.requests), e.result, e.error) for e in queue]))
        return call

    generated = {}  # mode -> request key -> [(request, token ids)]
    matrices = {}  # mode -> candidates -> welfare
    mode = {"name": ""}

    inner_calls = Wrapped(TorchBackend, ("generate", "score", "score_matrix", "embed",
                                         "next_token_logprobs"))

    def generate_recorder(original):
        def call(self, requests):
            results = original(self, requests)
            table = generated.setdefault(mode["name"], {})
            for request, result in zip(requests, results):
                table.setdefault(_request_key(request), []).append((request, result.token_ids))
            return results
        return call

    def matrix_recorder(original):
        def call(self, requests):
            results = original(self, requests)
            table = matrices.setdefault(mode["name"], {})
            for request, result in zip(requests, results):
                table[request.candidates] = np.asarray(result.welfare, np.float64)
            return results
        return call

    sessions = []

    def opened(original):
        def call(self, spec):
            session = original(self, spec)
            sessions.append((mode["name"], session))
            return session
        return call

    decode_steps = Wrapped(gen, ("forward_trunk_tail",))
    windows = {}
    stats = {}
    backend.pin_generation_budget = True  # the timing mode's backend half
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(Wrapped(batching_mod.BatchingBackend, make={
                "_run_batches": recording, "open_fused_token_search": opened}))
            stack.enter_context(Wrapped(TorchBackend, make={"generate": generate_recorder,
                                                             "score_matrix": matrix_recorder}))
            stack.enter_context(inner_calls)
            stack.enter_context(decode_steps)

            def window(name, fn):
                mode["name"] = name
                calls_before = dict(inner_calls.calls)
                rows_before = dict(backend.call_counts)
                tokens_before = dict(backend.token_counts)
                steps_before = decode_steps.calls["forward_trunk_tail"]
                fa.launches.reset()
                da.launches.reset()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                windows[name] = {
                    "wall_s": time.perf_counter() - t0,
                    "launches": {"flash_attention": fa.launches.count,
                                 "decode_attention": da.launches.count},
                    "decode_shapes": {k: (c, a) for k, (c, a) in da.launches.shapes.items()},
                    "inner_calls": {k: inner_calls.calls[k] - calls_before[k]
                                    for k in inner_calls.calls},
                    "inner_rows": {k: backend.call_counts[k] - rows_before[k]
                                   for k in backend.call_counts},
                    "tokens": {k: backend.token_counts[k] - tokens_before[k]
                               for k in backend.token_counts},
                    "decode_steps": decode_steps.calls["forward_trunk_tail"] - steps_before,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                }
                return out

            # (a) the headline config, concurrent, through run_pipeline.
            overrides = {k: v for k, v in cut(headline, CONCURRENT_CUTS).items()
                         if k in CONCURRENT_CUTS or k == "output_dir"}
            overrides["timing_pin_budget"] = True
            run_dir = pathlib.Path(window("a_concurrent", lambda: pipeline.run_pipeline(
                str(headline_path), skip_comparative_ranking=True,
                config_overrides=overrides, backend=backend)))
            stats["a_generation_wall_s"] = json_.loads(
                (run_dir / "token_counts.json").read_text())["wall_s"]
            # Read before the resume below rewrites the run dir's artifacts.
            metrics = json_.loads((run_dir / "metrics.json").read_text())
            journal = [line for line in (run_dir / "journal.jsonl").read_text().splitlines()
                       if line]
            # The same runs one after another.
            # (Its name must not extend the headline's: a resume takes the
            # newest run dir whose name starts with the experiment's.)
            sequential_config = cut(headline, CONCURRENT_CUTS, timing_pin_budget=True,
                                    concurrent_execution=False,
                                    experiment_name="sequential_" + headline["experiment_name"])
            seq_run = Experiment(sequential_config, backend=backend)
            window("a_sequential", seq_run.run)
            # (b) beam search with brushup, concurrent then sequential.
            beam_config = cut(beam, CONCURRENT_BEAM_CUTS, timing_pin_budget=True)
            beam_runs = {}
            for name, concurrent in (("b_concurrent", True), ("b_sequential", False)):
                config = dict(beam_config, concurrent_execution=concurrent,
                              experiment_name=f"{name}_{beam['experiment_name']}")
                run = Experiment(config, backend=backend)
                window(name, run.run)
                beam_runs[name] = run
            mode["name"] = "replay"
            slicing = _replay_check(backend, records)
            # Resume of (a)'s run dir: nothing executes, the same results.csv.
            executed = []

            def counted(original):
                def call(self, method, *args, **kwargs):
                    executed.append(method)
                    return original(self, method, *args, **kwargs)
                return call

            resume_config = dict(yaml.safe_load((run_dir / "config.yaml").read_text()),
                                 resume=True)
            before_csv = (run_dir / "results.csv").read_text()
            with Wrapped(Experiment, make={"_run_one": counted}):
                Experiment(resume_config, backend=backend).run()
    finally:
        backend.pin_generation_budget = False

    frames = {
        "a_concurrent": pd.read_csv(run_dir / "results.csv", keep_default_na=False),
        "a_sequential": pd.read_csv(seq_run.run_dir / "results.csv", keep_default_na=False),
        "b_concurrent": pd.read_csv(beam_runs["b_concurrent"].run_dir / "results.csv",
                                    keep_default_na=False),
        "b_sequential": pd.read_csv(beam_runs["b_sequential"].run_dir / "results.csv",
                                    keep_default_na=False),
    }
    generation = {
        part: _compare_generations(backend, generated.get(f"{part}_concurrent", {}),
                                   generated.get(f"{part}_sequential", {}))
        for part in ("a", "b")
    }
    diverged_seeds = {part: {(d.get("seed"), d.get("temperature")) for d in g["diverged"]}
                      for part, g in generation.items()}

    def rows_match(part, method):
        """Rows of ``method`` equal between the modes, or explained: a draw
        of the run's requests diverged within DRAW_MARGIN, or (best_of_n)
        the same drafts with the two chosen candidates' sequential welfare
        within DRAW_MARGIN."""
        conc, seq = frames[f"{part}_concurrent"], frames[f"{part}_sequential"]
        conc, seq = conc[conc.method == method], seq[seq.method == method]
        out = {"rows": len(conc), "equal": 0, "explained": 0, "unexplained": 0}
        if len(conc) != len(seq):
            out["unexplained"] = max(len(conc), len(seq))
            return out
        for (_, c), (_, q) in zip(conc.iterrows(), seq.iterrows()):
            if c["statement"] == q["statement"]:
                out["equal"] += 1
                continue
            seeds = {s for s, _ in diverged_seeds[part]}
            if method == "best_of_n":
                run_seeds = set(range(int(q["seed"]), int(q["seed"]) + int(q["param_n"])))
                near = False
                for candidates, welfare in matrices.get(f"{part}_sequential", {}).items():
                    if q["statement"] in candidates and c["statement"] in candidates:
                        i = candidates.index(q["statement"])
                        j = candidates.index(c["statement"])
                        near = near or abs(welfare[i] - welfare[j]) < DRAW_MARGIN
                explained = bool(run_seeds & seeds) or near
            else:
                explained = int(q["seed"]) in seeds and c.get(
                    "pre_brushup_statement", "") == q.get("pre_brushup_statement", "")
            out["explained" if explained else "unexplained"] += 1
        return out

    comparisons = {
        "best_of_n": rows_match("a", "best_of_n"),
        "beam_search": rows_match("b", "beam_search"),
    }
    habermas = {part: frames[f"a_{part}"][frames[f"a_{part}"].method == "habermas_machine"]
                for part in ("concurrent", "sequential")}
    key_cols = ["method", "seed", "param_num_candidates"]
    batching_summary = _batching_summary(metrics)
    (experiment_span,) = [s for s in metrics["spans"] if s["name"] == "experiment"]
    b_sessions = [session for name, session in sessions if name == "b_concurrent"]
    n_layers = backend.config.n_layers
    b = windows["b_concurrent"]
    advances = sum(session._step for session in b_sessions)
    session_tokens = {
        "generated": sum(s.spec.n_slots * s._step for s in b_sessions),
        "scored": sum(s.spec.n_slots * s.spec.k * (s.n_roles - 1) * (1 + s._step)
                      for s in b_sessions),
    }
    brushup_tokens = sum(len(ids) for entries in generated.get("b_concurrent", {}).values()
                         for _, ids in entries)
    eval_file = run_dir / "evaluation" / "gemma2-2b" / "seed_0" / "evaluation_results.csv"
    a = windows["a_concurrent"]
    checks = {
        "rows_error_free": all(
            len(f) > 0 and bool((f["error_message"] == "").all())
            and not f["statement"].astype(str).str.startswith("[ERROR").any()
            for f in frames.values()),
        "habermas_same_rows_both_modes": len(habermas["concurrent"]) == 2
        and habermas["concurrent"][key_cols].astype(str).values.tolist()
        == habermas["sequential"][key_cols].astype(str).values.tolist(),
        "draws_equal_or_within_margin": all(
            d["ok"] for g in generation.values() for d in g["diverged"]),
        "rows_equal_or_explained": all(c["unexplained"] == 0 for c in comparisons.values()),
        "slicing_exact": slicing["ok"],
        "metrics_json": metrics["schema"] == "consensus_tpu.metrics.v1"
        and {c["name"] for c in experiment_span["children"]} >= {
            "generate/best_of_n", "generate/habermas_machine"}
        and any(v.get("max_fill", 0) > 1 for v in batching_summary.values()),
        "journal_one_record_per_row": len(journal) == len(frames["a_concurrent"]),
        "resume_executes_nothing": executed == []
        and (run_dir / "results.csv").read_text() == before_csv,
        "evaluation_file": eval_file.exists(),
        "b_sessions_fused_through_batching": len(b_sessions) == len(frames["b_concurrent"])
        and all(isinstance(getattr(s, "session", None), TorchTokenSearchSession)
                for s in b_sessions),
        "b_decode_launches_eq_layers_x_advances_and_brushup_steps":
            b["launches"]["decode_attention"] == n_layers * (advances + b["decode_steps"])
            and advances > 0,
        "b_token_counts_eq_session_sums": b["tokens"] == {
            "generated": session_tokens["generated"] + brushup_tokens,
            "scored": session_tokens["scored"]},
        "k1_and_k2_launched": a["launches"]["flash_attention"] > 0
        and a["launches"]["decode_attention"] > 0 and b["launches"]["decode_attention"] > 0,
    }
    statements = {name: len(f) for name, f in frames.items()}
    row = {
        "phase": "concurrent_path", "model": backend.config.name,
        "configs": {"a": str(headline_path.relative_to(ROOT)),
                    "b": str(beam_path.relative_to(ROOT))},
        "cuts": {"a": {**CONCURRENT_CUTS, "timing_pin_budget": True},
                 "b": {**CONCURRENT_BEAM_CUTS, "timing_pin_budget": True}},
        "max_concurrent_methods": headline.get("max_concurrent_methods"),
        "wall_s": {name: w["wall_s"] for name, w in windows.items()},
        "a_generation_wall_s": stats["a_generation_wall_s"],
        "s_per_statement": {name: windows[name]["wall_s"] / max(statements[name], 1)
                            for name in statements},
        "batch_counts": {
            "a_concurrent": {kind: sum(v.get("flushes", {}).values())
                             for kind, v in batching_summary.items()},
            "b_concurrent": beam_runs["b_concurrent"].last_batch_counts,
        },
        "inner_calls": {name: w["inner_calls"] for name, w in windows.items()},
        "inner_rows": {name: w["inner_rows"] for name, w in windows.items()},
        "tokens": {name: w["tokens"] for name, w in windows.items()},
        "batching": batching_summary,
        "launches": {name: w["launches"] for name, w in windows.items()},
        "decode_steps": {name: w["decode_steps"] for name, w in windows.items()},
        "peak_memory_gb": {name: w["peak_memory_gb"] for name, w in windows.items()},
        "b_search_advances": advances, "b_session_tokens": session_tokens,
        "b_brushup_tokens": brushup_tokens,
        "generation_compare": {part: {k: (v if k != "diverged" else v[:12])
                                      for k, v in g.items()} for part, g in generation.items()},
        "row_compare": comparisons,
        "habermas_rows_differing_in_text": int(sum(
            c != q for c, q in zip(habermas["concurrent"]["statement"],
                                   habermas["sequential"]["statement"]))),
        "slicing": slicing,
        "resume_executed_runs": len(executed),
        "results_csv": str(run_dir.relative_to(ROOT) / "results.csv"),
        "checks": checks, "ok": all(checks.values()),
    }
    launches = {k: sum(w["launches"][k] for w in windows.values()) for k in KERNELS}
    shapes = {}
    for w in windows.values():
        for key, (count, args) in w["decode_shapes"].items():
            shapes[key] = (shapes.get(key, (0, None))[0] + count, args)
    return row, launches, shapes


SERVE_CONFIG = TOKEN_SEARCH_CONFIG
#: serve_path's requests: (method, params, seed).  The second reaches K1
#: through per-call scoring; beam search reaches K2 through its fused
#: session; best-of-N's drafts and zero_shot decode through the engine.
SERVE_REQUESTS = (
    ("best_of_n", {"n": 4, "max_tokens": 150}, 7),
    ("best_of_n", {"n": 4, "max_tokens": 150, "matrix_scoring": False}, 7),
    ("beam_search", {"beam_width": 2, "max_tokens": 16}, 5),
    ("zero_shot", {"max_tokens": 50}, 42),
)
#: Depth cut of (b) and (c) for the time limit: max_tokens per method, and
#: no evaluation ((a) evaluates every response).
SERVE_CUT_TOKENS = {"best_of_n": 8, "beam_search": 8, "zero_shot": 8}
#: (c): one transient error on the first generate call, one NaN in row 0
#: of the first score call, under ``supervise``.
SERVE_FAULT_PLAN = {"seed": 3, "faults": [
    {"kind": "transient_error", "op": "generate", "call_index": 0},
    {"kind": "nan_logprobs", "op": "score", "call_index": 0, "row_index": 0},
]}
SERVE_DEVICE = "cuda"
SERVE_STARTUP_S = 600.0
SERVE_REQUEST_S = 900.0


def _serve_payloads(scenario, cut=False, methods=None):
    out = []
    for i, (method, params, seed) in enumerate(SERVE_REQUESTS):
        if methods is not None and method not in methods:
            continue
        params = dict(params)
        if cut:
            params["max_tokens"] = SERVE_CUT_TOKENS[method]
        out.append({"issue": scenario["issue"], "agent_opinions": scenario["agent_opinions"],
                    "method": method, "params": params, "seed": seed, "evaluate": not cut,
                    "request_id": f"serve-{i}-{method}", "timeout_s": SERVE_REQUEST_S})
    return out


def _http(url, payload=None, timeout=SERVE_REQUEST_S):
    """(status, body text, seconds) of one GET (or POST of ``payload``)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    request = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            status, body = response.status, response.read().decode()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read().decode()
    return status, body, time.perf_counter() - t0


def _post_all(base, payloads):
    """POST every payload at once -> ([(status, body dict, seconds)], wall s)."""
    out = [None] * len(payloads)

    def post(i):
        status, body, seconds = _http(base + "/v1/consensus", payloads[i])
        out[i] = (status, json.loads(body), seconds)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def _launches_from_metrics(base):
    """K1 / K2 launch counts from a server's ``kernel_launches_total``."""
    _, text, _ = _http(base + "/metrics")
    counts = {k: 0 for k in KERNELS}
    for line in text.splitlines():
        for kernel in KERNELS:
            if line.startswith(f'kernel_launches_total{{kernel="{kernel}"}}'):
                counts[kernel] = int(float(line.split()[-1]))
    return counts


def _launches_by_device_from_metrics(base):
    """{kernel: {device: launches}} from a server's
    ``kernel_launches_by_device_total``."""
    import re

    _, text, _ = _http(base + "/metrics")
    counts = {k: {} for k in KERNELS}
    pattern = re.compile(
        r'^kernel_launches_by_device_total\{kernel="(\w+)",device="([\w:]+)"\} (\S+)$')
    for line in text.splitlines():
        match = pattern.match(line)
        if match and match.group(1) in counts:
            counts[match.group(1)][match.group(2)] = int(float(match.group(3)))
    return counts


def _latency_stats(results, wall):
    latencies = sorted(seconds for _, _, seconds in results)
    return {"statuses": [status for status, _, _ in results], "wall_s": wall,
            "latency_p50_s": latencies[(len(latencies) - 1) // 2],
            "latency_max_s": latencies[-1], "statements_per_s": len(results) / wall}


def _engine_block(health):
    engine = health.get("engine") or {}
    keys = ("slots", "slot_occupancy_mean", "iterations", "kv_pages", "kv_page_size",
            "kv_pages_high_water", "decode_steps", "decode_windows", "decoded_tokens",
            "tokens_per_dispatch_mean")
    return {k: engine.get(k) for k in keys}


def _serve_subprocess(options, payloads, device, extra_args=(), tag="serve"):
    """(a): ``python -m consensus_tpu_torch.serve --backend torch`` as a
    subprocess (plus ``extra_args``); startup JSON, the payloads at once,
    /healthz, SIGTERM."""
    import os
    import select
    import signal

    cmd = [sys.executable, "-m", "consensus_tpu_torch.serve", "--backend", "torch",
           "--backend-options", json.dumps(options), "--port", "0", "--max-inflight", "4",
           "--default-timeout-s", str(SERVE_REQUEST_S), "--log-level", "WARNING",
           "--blackbox", str(OUT_DIR / f"{tag}_blackbox.json"), *extra_args]
    if device != "cuda":
        cmd += ["--device", device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = {"command": cmd[2:4] + cmd[4:6]}
    t0 = time.perf_counter()
    with open(OUT_DIR / f"{tag}_stderr.log", "w") as stderr:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=stderr, text=True,
                                env=env)
        try:
            ready, _, _ = select.select([proc.stdout], [], [], SERVE_STARTUP_S)
            line = proc.stdout.readline() if ready else ""
            if not line:
                out["error"] = f"no startup line (exit {proc.poll()})"
                return out
            startup = json.loads(line)
            base = startup["serving"]
            out["startup_s"] = time.perf_counter() - t0
            out["startup"] = {k: startup.get(k) for k in ("backend", "engine", "max_inflight")}
            before = _launches_from_metrics(base)
            by_device_before = _launches_by_device_from_metrics(base)
            results, wall = _post_all(base, payloads)
            after = _launches_from_metrics(base)
            by_device_after = _launches_by_device_from_metrics(base)
            _, health, _ = _http(base + "/healthz")
            health = json.loads(health)
            out.update(_latency_stats(results, wall))
            out["launches"] = {k: after[k] - before[k] for k in KERNELS}
            out["launches_by_device"] = {
                k: {d: n - by_device_before[k].get(d, 0) for d, n in by_device_after[k].items()}
                for k in KERNELS}
            out["healthz"] = {"status": health.get("status"), "engine": _engine_block(health),
                              "mesh": (health.get("engine") or {}).get("mesh"),
                              "device_batches": health.get("device_batches")}
            out["statements"] = [body.get("statement") for _, body, _ in results]
            out["errors"] = [body.get("error") for _, body, _ in results if "error" in body]
            t_stop = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            out["exit_code"] = proc.wait(timeout=300)
            out["drain_s"] = time.perf_counter() - t_stop
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _drain_stream(stream):
    results = {}
    while not stream.finished:
        stream.dispatch()
        results.update(stream.collect()[1])
    stream.close()
    return [results[i].token_ids for i in range(len(results))]


def serve_path(params=None):
    """The serving entry point on llama3-8b (the token-search config's
    backend options, with ``use_flash_attention`` and
    ``use_decode_attention``) -> (row, launches, decode shapes).  (a)
    ``python -m consensus_tpu_torch.serve --backend torch`` as a
    subprocess: SERVE_REQUESTS at once, /healthz, SIGTERM drain, launches
    read from its ``/metrics``; (b) in process, ``create_server`` over one
    backend instance (``params``: the same seeded weights), the cut
    requests four ways: engine with blocking cohorts, ``--no-engine``
    flush, engine with K=1 and K=4 decode streams; then one recorded cohort
    through ``generate_stream`` at K=1 and K=4 directly; (c) the cut
    requests without beam search under SERVE_FAULT_PLAN and ``supervise``."""
    import torch
    import yaml

    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.methods.prompts import clean_statement
    from consensus_tpu_torch.obs.metrics import Registry
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa
    from consensus_tpu_torch.serve import create_server

    config = yaml.safe_load((ROOT / SERVE_CONFIG).read_text())
    # The timing mode's backend half: every generation runs its full budget
    # (random weights draw EOS early), so decode rates are the workload's.
    options = dict(config["backend_options"], pin_generation_budget=True)
    scenario = config["scenario"]
    on_card = SERVE_DEVICE == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) the CLI in a subprocess, at the full request depth.
    cli = _serve_subprocess(options, _serve_payloads(scenario), SERVE_DEVICE)

    # (b) in process over one backend instance.
    started = time.perf_counter()
    backend = TorchBackend(**options, params=params, device=SERVE_DEVICE)
    sync()
    init_s = time.perf_counter() - started
    generated = {}  # mode -> request key -> [(request, token ids)]
    texts = {}  # mode -> every generated text, cleaned as best-of-N cleans it
    mode = {"name": ""}

    def record(requests, results):
        table = generated.setdefault(mode["name"], {})
        for request, result in zip(requests, results):
            table.setdefault(_request_key(request), []).append((request, tuple(result.token_ids)))
            texts.setdefault(mode["name"], set()).add(clean_statement(result.text))

    dense_generate, open_stream = backend.generate, backend.generate_stream

    def generate(requests):
        results = dense_generate(requests)
        record(requests, results)
        return results

    def generate_stream(requests, decode_steps=1, speculative=False):
        stream = open_stream(requests, decode_steps=decode_steps, speculative=speculative)
        collect = stream.collect

        def collect_and_record():
            row_tokens, finished = collect()
            rows = sorted(finished)
            record([requests[i] for i in rows], [finished[i] for i in rows])
            return row_tokens, finished
        stream.collect = collect_and_record
        return stream

    backend.generate, backend.generate_stream = generate, generate_stream
    windows = {}
    shapes = {}
    responses = {}

    def window(name, payloads, **server_options):
        mode["name"] = name
        registry = Registry()
        server = create_server(backend=backend, port=0, registry=registry, max_inflight=4,
                               default_timeout_s=SERVE_REQUEST_S, **server_options).start()
        fa.launches.reset()
        da.launches.reset()
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        try:
            results, wall = _post_all(server.base_url, payloads)
            sync()
            _, health, _ = _http(server.base_url + "/healthz")
            health = json.loads(health)
        finally:
            server.stop()
        info = _latency_stats(results, wall)
        info["launches"] = {"flash_attention": fa.launches.count,
                            "decode_attention": da.launches.count}
        for key, (count, args) in da.launches.shapes.items():
            shapes[key] = (shapes.get(key, (0, None))[0] + count, args)
        engine = _engine_block(health)
        info["engine"] = engine
        if engine.get("decoded_tokens"):
            info["decode_tokens_per_s"] = engine["decoded_tokens"] / wall
        info["breaker"] = (health.get("circuit_breaker") or {}).get("state")
        info["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        families = registry.snapshot()["families"]
        info["faults_injected"] = sum(
            s["value"] for s in families.get("faults_injected_total", {}).get("series", []))
        info["supervisor_retries"] = sum(
            s["value"] for s in families.get("supervisor_retries_total", {}).get("series", []))
        windows[name] = info
        responses[name] = [body for _, body, _ in results]

    cut = _serve_payloads(scenario, cut=True)
    try:
        window("b_engine", cut)
        window("b_flush", cut, engine=False)
        window("b_stream_k1", cut, engine_options={"decode_steps": 1})
        window("b_stream_k4", cut, engine_options={"decode_steps": 4})
        # The same cohort straight through generate_stream at K=1 and K=4.
        cohort = [entries[0][0] for entries in generated["b_engine"].values()]
        mode["name"] = "direct"
        k_family = {k: _drain_stream(open_stream(cohort, decode_steps=k)) for k in (1, 4)}
        # (c) faults under supervise (no beam search: the fault wrapper
        # hides fused sessions, whose fallback is far slower).
        fault_payloads = _serve_payloads(scenario, cut=True, methods=("best_of_n", "zero_shot"))
        window("c_faults", fault_payloads, fault_plan=SERVE_FAULT_PLAN,
               supervise={"backoff_s": 0.05})
    finally:
        backend.generate, backend.generate_stream = dense_generate, open_stream

    # Each mode against the engine's blocking cohorts: generate tokens equal
    # or first differing at a draw of margin under DRAW_MARGIN; a statement
    # equal, or explained: by such a divergence, or (best-of-N picking
    # another of the same candidates on a welfare near-tie of per-call
    # scores batched differently) by being one of the engine run's texts.
    ref = {body.get("request_id"): body.get("statement") for body in responses["b_engine"]}
    compares, statements = {}, {}
    for name in ("b_flush", "b_stream_k1", "b_stream_k4", "c_faults"):
        compare = _compare_generations(backend, generated.get(name, {}), generated["b_engine"])
        compare["all_diverged_ok"] = all(d["ok"] for d in compare["diverged"])
        compares[name] = compare
        statements[name] = [{
            "request_id": body.get("request_id"), "failed": "error" in body,
            "equal": body.get("statement") == ref.get(body.get("request_id")),
            "an_engine_candidate": body.get("statement") in texts.get("b_engine", ()),
        } for body in responses[name]]
    del backend
    if on_card:
        torch.cuda.empty_cache()

    def statements_ok(name):
        diverged = bool(compares[name]["diverged"]) and compares[name]["all_diverged_ok"]
        return all(r["equal"] or diverged or r["an_engine_candidate"]
                   for r in statements[name] if not r["failed"])

    faults = windows["c_faults"]
    failed = [r for r in statements["c_faults"] if r["failed"]]
    checks = {
        "a_served_every_request": cli.get("statuses") == [200] * len(SERVE_REQUESTS),
        "a_drained_and_exited_0": cli.get("exit_code") == 0,
        "a_launched_flash_attention": cli.get("launches", {}).get("flash_attention", 0) > 0,
        "a_launched_decode_attention": cli.get("launches", {}).get("decode_attention", 0) > 0,
        "a_engine_served": (cli.get("healthz", {}).get("engine", {}).get("decode_windows") or 0) > 0,
        "b_served_every_request": all(
            windows[n]["statuses"] == [200] * len(cut)
            for n in ("b_engine", "b_flush", "b_stream_k1", "b_stream_k4")),
        "b_streams_ran": all(windows[f"b_stream_k{k}"]["engine"]["decode_steps"] == k
                             and windows[f"b_stream_k{k}"]["engine"]["decode_windows"] > 0
                             for k in (1, 4)),
        "b_tokens_equal_or_diverge_below_margin": all(
            compares[n]["all_diverged_ok"] and not compares[n]["only_one_mode"]
            for n in ("b_flush", "b_stream_k1", "b_stream_k4")),
        "b_statements_equal_or_explained": all(
            statements_ok(n) for n in ("b_flush", "b_stream_k1", "b_stream_k4")),
        "b_stream_k1_equals_k4": k_family[1] == k_family[4],
        "c_transient_retried": faults["supervisor_retries"] >= 1,
        "c_faults_injected": faults["faults_injected"] == 2,
        "c_exactly_one_request_failed": len(failed) == 1,
        "c_siblings_equal_or_explained": statements_ok("c_faults")
        and compares["c_faults"]["all_diverged_ok"],
        "c_breaker_closed": faults["breaker"] == "closed",
    }
    row = {
        "phase": "serve_path", "model": options["model"], "config": SERVE_CONFIG,
        "requests": [[m, p, s] for m, p, s in SERVE_REQUESTS], "cut_tokens": SERVE_CUT_TOKENS,
        "a_cli": cli, "b_init_s": init_s, "windows": windows,
        "generation_compare": {n: {k: (v if k != "diverged" else v[:12]) for k, v in c.items()}
                               for n, c in compares.items()},
        "statements": statements,
        "k_family_cohort_rows": len(cohort),
        "checks": checks, "ok": all(checks.values()),
    }
    launches = {k: cli.get("launches", {}).get(k, 0)
                + sum(w["launches"][k] for w in windows.values()) for k in KERNELS}
    return row, launches, shapes


#: fleet_path: the serve_path (a) mix cut to FLEET_TOKENS, cycled over
#: FLEET_REQUESTS requests of the load generator's ``fixed:2`` scenario mix,
#: offered open loop at FLEET_RATE requests/s.
FLEET_MIX = (
    ("best_of_n", {"n": 4}),
    ("best_of_n", {"n": 4, "matrix_scoring": False}),
    ("zero_shot", {}),
)
FLEET_TOKENS = 64
FLEET_REQUESTS = 8
FLEET_RATE = 0.5
#: Replica r1 is lost at its first backend call this many seconds after its
#: backend was built (the load starts 1-2 s after that): a sticky device
#: loss that the supervisor, engine and router see as a real one, while r1
#: holds the requests it was given.  A call-index trigger lands later: one
#: replica's cohorts and scoring stretch under the other's host work (the
#: first score call came 41 s into the load on the card).  The respawn is
#: warm-seeded from what the page store holds then, and a prompt prefix
#: reaches the store only when a replica's first rows retire (15-17 s into
#: the load on the card, a cohort of 64 tokens under two replicas): a loss
#: at 8 s (r1's first call after it, at 17 s) raced that harvest and left
#: the store empty at the respawn in one run of six.  At 24 s the store
#: holds r0's first runs, and r1 still serves the requests that reached it
#: last (the final one arrives 14 s into the load and takes 17 s or more).
FLEET_KILL_AFTER_S = 24.0
#: Peak device memory after the respawn, over the peak before the loss.
FLEET_MEMORY_RATIO = 1.25
FLEET_DRAW_STEPS = 64
#: (b): requests resolved before the SIGKILL and left in flight by it.
DURABILITY_RESOLVED = 2
DURABILITY_INFLIGHT = 3
#: (c): the speculative windows' K.
SPEC_STEPS = 4


def _fleet_payloads():
    from consensus_tpu_torch.serve.loadgen import scenario_requests

    base = scenario_requests(FLEET_REQUESTS, method="best_of_n", params={}, base_seed=100,
                             evaluate=True, timeout_s=SERVE_REQUEST_S,
                             scenario_repeat="fixed:2")
    out = []
    for i, payload in enumerate(base):
        method, params = FLEET_MIX[i % len(FLEET_MIX)]
        out.append(dict(payload, method=method, params=dict(params, max_tokens=FLEET_TOKENS),
                        request_id=f"fleet-{i}-{method}"))
    return out


def _device_used_gb():
    import torch

    if not torch.cuda.is_available():
        return None
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 1e9


class _FleetWatch:
    """Polls the server's ``/healthz`` and the card's used memory while the
    load runs: when the fleet first reads a member short, when it reads
    whole again, and the device memory on either side."""

    def __init__(self, base):
        self.base = base
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self.t0 = time.perf_counter()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(30)

    def _run(self):
        while not self._stop.wait(0.25):
            try:
                _, body, _ = _http(self.base + "/healthz", timeout=10)
                fleet = json.loads(body).get("fleet") or {}
            except Exception:
                continue
            manager = fleet.get("manager") or {}
            self.samples.append({
                "t": time.perf_counter() - self.t0, "size": fleet.get("size"),
                "healthy": fleet.get("healthy"), "losses": manager.get("losses", 0),
                "respawns": manager.get("respawns", 0), "used_gb": _device_used_gb(),
            })

    def summary(self):
        lost_at = next((s["t"] for s in self.samples
                        if s["losses"] >= 1 or (s["healthy"] or 0) < (s["size"] or 0)), None)
        back_at = None
        if lost_at is not None:
            back_at = next((s["t"] for s in self.samples
                            if s["t"] > lost_at and s["respawns"] >= 1
                            and s["healthy"] == s["size"] == 2), None)
        used = [(s["t"], s["used_gb"]) for s in self.samples if s["used_gb"] is not None]
        before = [u for t, u in used if lost_at is None or t < lost_at]
        after = [u for t, u in used if back_at is not None and t >= back_at]
        during = [u for t, u in used if lost_at is not None and t >= lost_at
                  and (back_at is None or t < back_at)]
        timeline, last = [], None
        for s in self.samples:
            if last is None or s["t"] - last >= 1.0:
                last = s["t"]
                timeline.append([round(s["t"], 2), s["healthy"], s["size"], s["losses"],
                                 s["respawns"], None if s["used_gb"] is None
                                 else round(s["used_gb"], 2)])
        return {
            "loss_seen_s": lost_at, "whole_again_s": back_at,
            "time_to_recover_s": None if back_at is None else back_at - lost_at,
            "timeline_t_healthy_size_losses_respawns_used_gb": timeline,
            "peak_used_gb_before_loss": max(before) if before else None,
            "peak_used_gb_during_respawn": max(during) if during else None,
            "peak_used_gb_after_respawn": max(after) if after else None,
            "samples": len(self.samples),
        }


def _federated_sketch_count(text, family="serve_latency_sketch_seconds"):
    for line in text.splitlines():
        if line.startswith(f'{family}_count{{replica="fleet",outcome="ok"}}'):
            return int(float(line.split()[-1]))
    return None


def _fleet_cli(options, payloads, device, state_dir):
    """(a): ``python -m consensus_tpu_torch.serve --backend torch --fleet 2
    --elastic --telemetry --slo --state-dir`` as a subprocess, driven open
    loop by the port's load generator while r1 dies and respawns."""
    import os
    import select
    import signal

    from consensus_tpu_torch.serve.loadgen import run_loadgen

    fleet_options = {
        "fault_plans": [None, {"seed": 0, "faults": [
            {"kind": "device_lost", "op": "*", "after_s": FLEET_KILL_AFTER_S}]}],
    }
    cmd = [sys.executable, "-m", "consensus_tpu_torch.serve", "--backend", "torch",
           "--backend-options", json.dumps(options), "--port", "0", "--max-inflight", "4",
           "--default-timeout-s", str(SERVE_REQUEST_S), "--log-level", "WARNING",
           "--fleet", "2", "--elastic", "--telemetry", "--slo", "--state-dir", str(state_dir),
           "--fleet-options", json.dumps(fleet_options),
           "--engine-options", json.dumps({"prefix_cache": True})]
    if device != "cuda":
        cmd += ["--device", device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = {"command": cmd[2:4] + ["--fleet", "2", "--elastic", "--telemetry", "--slo",
                                  "--state-dir"]}
    t0 = time.perf_counter()
    with open(OUT_DIR / "fleet_stderr.log", "w") as stderr:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=stderr, text=True,
                                env=env)
        try:
            ready, _, _ = select.select([proc.stdout], [], [], SERVE_STARTUP_S)
            line = proc.stdout.readline() if ready else ""
            if not line:
                out["error"] = f"no startup line (exit {proc.poll()})"
                return out
            startup = json.loads(line)
            base = startup["serving"]
            out["startup_s"] = time.perf_counter() - t0
            out["startup"] = {k: startup.get(k) for k in ("fleet", "elastic", "engine")}
            before = _launches_from_metrics(base)
            with _FleetWatch(base) as watch:
                report = run_loadgen(base, payloads, FLEET_RATE, client_timeout_s=SERVE_REQUEST_S,
                                     include_slo=True, scenario_mix="fixed:2")
                # The fleet reads whole again once the respawn joins.
                deadline = time.perf_counter() + SERVE_STARTUP_S
                while time.perf_counter() < deadline:
                    summary = watch.summary()
                    if summary["whole_again_s"] is not None or summary["loss_seen_s"] is None:
                        break
                    time.sleep(0.5)
                time.sleep(1.0)
            after = _launches_from_metrics(base)
            out["watch"] = watch.summary()
            _, health, _ = _http(base + "/healthz")
            health = json.loads(health)
            status, slo, _ = _http(base + "/v1/slo")
            _, metrics_text, _ = _http(base + "/metrics")
            fleet = health.get("fleet") or {}
            manager = fleet.get("manager") or {}
            outcomes = report.pop("outcomes")
            out["report"] = {k: report.get(k) for k in (
                "completed", "availability", "wall_s", "throughput_rps", "latency_ms", "fleet",
                "replica_request_counts", "failover_fraction", "welfare", "slo",
                "prefix_hit_fraction")}
            out["outcomes"] = [{"request_id": o.request_id, "status": o.status,
                                "served_by": o.served_by, "latency_s": o.latency_s,
                                "started_s": o.started_s, "statement": o.statement}
                               for o in outcomes]
            out["launches"] = {k: after[k] - before[k] for k in KERNELS}
            out["fleet"] = {k: fleet.get(k) for k in (
                "size", "healthy", "lost", "failovers_total", "failovers", "affinity_hit_rate",
                "routed")}
            out["manager"] = {k: manager.get(k) for k in (
                "losses", "respawns", "warm_seeded", "quarantined")}
            out["page_store"] = {k: (manager.get("page_store") or {}).get(k)
                                 for k in ("runs", "disk")}
            out["health_status"] = health.get("status")
            out["health_blocks"] = sorted(k for k in ("slo", "welfare", "fleet") if k in health)
            out["slo_status"] = status
            out["slo_states"] = {s.get("name"): s.get("state")
                                 for s in json.loads(slo).get("specs", [])} if status == 200 else {}
            out["federated_ok_count"] = _federated_sketch_count(metrics_text)
            t_stop = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            out["exit_code"] = proc.wait(timeout=300)
            out["drain_s"] = time.perf_counter() - t_stop
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _trajectory_near_tie(backend, entries):
    """The first sampled draw along the recorded reference trajectories
    ``[(request, ids)]`` whose margin is under DRAW_MARGIN, or None."""
    checked = 0
    for request, ids in entries:
        for step in range(min(len(ids), FLEET_DRAW_STEPS)):
            checked += 1
            margin = _draw_margin(backend, request, ids, step)
            if margin < DRAW_MARGIN:
                return {"seed": request.seed, "step": step, "margin": margin,
                        "draws_checked": checked}
    return None


def _durability_run(options, device, state_dir):
    """(b): the port's SIGKILL harness on ``--backend torch``."""
    import os

    cmd = [sys.executable, "consensus_tpu_torch/scripts/durability_smoke.py",
           "--state-dir", str(state_dir), "--backend", "torch",
           "--backend-options", json.dumps(options),
           "--resolved", str(DURABILITY_RESOLVED), "--inflight", str(DURABILITY_INFLIGHT)]
    if device != "cuda":
        cmd += ["--device", device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=2 * SERVE_STARTUP_S)
    try:
        verdict = json.loads(done.stdout)
    except ValueError:
        verdict = {"ok": False, "error": (done.stdout + done.stderr)[-2000:]}
    verdict["exit_code"] = done.returncode
    verdict["wall_s"] = time.perf_counter() - t0
    return verdict


def fleet_path(params=None):
    """The serving fleet on llama3-8b (serve_path's backend options, budgets
    pinned) -> (row, launches, decode shapes).  (a) ``python -m
    consensus_tpu_torch.serve --backend torch --fleet 2 --elastic
    --telemetry --slo --state-dir`` as a subprocess with the prefix cache
    on, driven open loop by the port's load generator (FLEET_REQUESTS at
    FLEET_RATE, ``fixed:2``) while r1 is lost mid-load and respawns; every
    statement against a one-replica run in process over ``params`` (the
    same seeded weights); (b) the port's durability harness: SIGKILL under
    load, relaunch, replay, beside (c): in process over ``params``,
    serve_path's cut requests through the engine with K=SPEC_STEPS windows,
    speculative and not, and one recorded cohort through ``generate_stream``
    with and without speculation."""
    import shutil

    import torch
    import yaml

    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.obs.metrics import Registry
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa
    from consensus_tpu_torch.serve import create_server

    config = yaml.safe_load((ROOT / SERVE_CONFIG).read_text())
    options = dict(config["backend_options"], pin_generation_budget=True)
    on_card = SERVE_DEVICE == "cuda"
    payloads = _fleet_payloads()
    state_root = OUT_DIR / "fleet_state"
    shutil.rmtree(state_root, ignore_errors=True)

    # (a) the fleet CLI under load, with a replica lost mid-run.
    started = time.perf_counter()
    cli = _fleet_cli(options, payloads, SERVE_DEVICE, state_root / "fleet")
    cli["wall_s"] = time.perf_counter() - started

    # One backend in process for the reference run and for (c).
    started = time.perf_counter()
    backend = TorchBackend(**options, params=params, device=SERVE_DEVICE)
    init_s = time.perf_counter() - started
    generated = {}
    mode = {"name": ""}
    dense_generate, open_stream = backend.generate, backend.generate_stream

    def record(requests, results):
        table = generated.setdefault(mode["name"], {})
        for request, result in zip(requests, results):
            table.setdefault(_request_key(request), []).append((request, tuple(result.token_ids)))

    def generate(requests):
        results = dense_generate(requests)
        record(requests, results)
        return results

    def generate_stream(requests, decode_steps=1, speculative=False):
        stream = open_stream(requests, decode_steps=decode_steps, speculative=speculative)
        collect = stream.collect

        def collect_and_record():
            row_tokens, finished = collect()
            rows = sorted(finished)
            record([requests[i] for i in rows], [finished[i] for i in rows])
            return row_tokens, finished
        stream.collect = collect_and_record
        return stream

    backend.generate, backend.generate_stream = generate, generate_stream
    windows = {}
    launches = {k: cli.get("launches", {}).get(k, 0) for k in KERNELS}
    shapes = {}

    def drafts_proposed():
        family = backend.instruments.registry.snapshot()["families"].get(
            "spec_draft_proposed_tokens_total") or {}
        return sum(s["value"] for s in family.get("series", []))

    def window(name, batch, **server_options):
        mode["name"] = name
        registry = Registry()
        server = create_server(backend=backend, port=0, registry=registry, max_inflight=4,
                               default_timeout_s=SERVE_REQUEST_S, **server_options).start()
        proposed_before = drafts_proposed()
        fa.launches.reset()
        da.launches.reset()
        try:
            results, wall = _post_all(server.base_url, batch)
            if on_card:
                torch.cuda.synchronize()
            _, health, _ = _http(server.base_url + "/healthz")
            health = json.loads(health)
        finally:
            server.stop()
        info = _latency_stats(results, wall)
        latencies = sorted(seconds for _, _, seconds in results)
        info["latency_p95_s"] = latencies[max(0, -(-95 * len(latencies) // 100) - 1)]
        info["launches"] = {"flash_attention": fa.launches.count,
                            "decode_attention": da.launches.count}
        for key in KERNELS:
            launches[key] += info["launches"][key]
        for key, (count, args) in da.launches.shapes.items():
            shapes[key] = (shapes.get(key, (0, None))[0] + count, args)
        engine = health.get("engine") or {}
        info["engine"] = _engine_block(health)
        info["speculative"] = engine.get("speculative")
        info["spec_draft_proposed_tokens_total"] = drafts_proposed() - proposed_before
        info["statements"] = {body.get("request_id"): body.get("statement")
                              for _, body, _ in results}
        windows[name] = info

    # (b) durability (its own server processes) runs beside the in-process
    # reference run and (c); neither is timed against the other.
    durability = {}
    durability_thread = threading.Thread(target=lambda: durability.update(
        _durability_run(options, SERVE_DEVICE, state_root / "durable")))
    durability_thread.start()
    try:
        # The one-replica reference for (a): the same payloads and engine,
        # unevaluated (the statement is chosen before the evaluation).
        window("a_one_replica", [dict(p, evaluate=False) for p in payloads],
               engine_options={"prefix_cache": True})
        # (c) speculative windows against plain ones.
        cut = _serve_payloads(config["scenario"], cut=True)
        window("c_engine_plain", cut, engine_options={"decode_steps": SPEC_STEPS})
        window("c_engine_speculative", cut,
               engine_options={"decode_steps": SPEC_STEPS, "speculative": True})
        cohort = [entries[0][0] for entries in generated["c_engine_plain"].values()]
        mode["name"] = "c_stream"
        plain_stream = _drain_stream(open_stream(cohort, decode_steps=SPEC_STEPS))
        spec = open_stream(cohort, decode_steps=SPEC_STEPS, speculative=True)
        spec_stream = _drain_stream(spec)
        stream_spec = {"proposed": spec.spec_proposed, "accepted": spec.spec_accepted}
    finally:
        backend.generate, backend.generate_stream = dense_generate, open_stream
        durability_thread.join()

    # (a)'s statements against the one-replica run: equal, or the reference
    # trajectory of that request holds a sampled draw under DRAW_MARGIN
    # (the server returns statements, not token ids, so the divergence is
    # bounded from the reference side).
    reference = windows["a_one_replica"]["statements"]
    by_request = {}
    for entries in generated.get("a_one_replica", {}).values():
        for request, ids in entries:
            by_request.setdefault(request.user_prompt, []).append((request, ids))
    statement_rows = []
    for payload, outcome in zip(payloads, cli.get("outcomes", [])):
        rid = payload["request_id"]
        row = {"request_id": rid, "served_by": outcome["served_by"],
               "started_s": round(outcome["started_s"], 2),
               "latency_s": round(outcome["latency_s"], 2),
               "equal": outcome["statement"] == reference.get(rid)}
        if not row["equal"]:
            prompts = [key for key in by_request if payload["issue"] in key]
            entries = [e for key in prompts for e in by_request[key]
                       if e[0].seed is not None]
            row["near_tie"] = _trajectory_near_tie(backend, entries)
        statement_rows.append(row)
    spec_compare = _compare_generations(backend, generated.get("c_engine_speculative", {}),
                                        generated["c_engine_plain"])
    stream_compare = sum(a == b for a, b in zip(spec_stream, plain_stream))
    stream_diverged = []
    for request, a, b in zip(cohort, spec_stream, plain_stream):
        if a != b:
            first = next((t for t in range(min(len(a), len(b))) if a[t] != b[t]),
                         min(len(a), len(b)))
            margin = _draw_margin(backend, request, b, first)
            stream_diverged.append({"seed": request.seed, "step": first, "margin": margin,
                                    "ok": margin < DRAW_MARGIN})
    del backend
    if on_card:
        torch.cuda.empty_cache()

    report = cli.get("report") or {}
    watch = cli.get("watch") or {}
    manager = cli.get("manager") or {}
    completed = report.get("completed")
    before, after = watch.get("peak_used_gb_before_loss"), watch.get("peak_used_gb_after_respawn")
    spec_window = windows["c_engine_speculative"]
    spec_stats = spec_window.get("speculative") or {}
    checks = {
        "a_completed_every_request": completed == FLEET_REQUESTS,
        "a_availability_1": report.get("availability") == 1.0,
        "a_replica_lost": (manager.get("losses") or 0) >= 1,
        "a_failed_over": ((cli.get("fleet") or {}).get("failovers_total") or 0) >= 1,
        "a_respawned": (manager.get("respawns") or 0) >= 1,
        "a_time_to_recover_reported": watch.get("time_to_recover_s") is not None,
        "a_respawn_warm_seeded": sum((manager.get("warm_seeded") or {}).values()) > 0,
        "a_federated_sketch_count_eq_completed": cli.get("federated_ok_count") == completed,
        "a_slo_state_per_spec": cli.get("slo_status") == 200 and bool(cli.get("slo_states"))
        and all(state in ("ok", "burning", "violated")
                for state in cli.get("slo_states", {}).values()),
        "a_launched_flash_attention": cli.get("launches", {}).get("flash_attention", 0) > 0,
        "a_launched_decode_attention": cli.get("launches", {}).get("decode_attention", 0) > 0,
        "a_statements_equal_one_replica_or_near_tie": bool(statement_rows) and all(
            r["equal"] or r.get("near_tie") is not None for r in statement_rows),
        "a_drained_and_exited_0": cli.get("exit_code") == 0,
        "a_memory_after_respawn_within_ratio": (
            before is not None and after is not None and after <= FLEET_MEMORY_RATIO * before)
        if on_card else True,
        "b_replayed": (durability.get("replayed") or 0) > 0,
        "b_lost_0": durability.get("lost") == 0,
        "b_dup_0": durability.get("dup") == 0,
        "b_mismatches_0": durability.get("mismatches") == 0,
        "c_served_every_request": all(
            windows[n]["statuses"] == [200] * len(cut)
            for n in ("c_engine_plain", "c_engine_speculative")),
        "c_engine_tokens_equal_or_diverge_below_margin": all(
            d["ok"] for d in spec_compare["diverged"]) and not spec_compare["only_one_mode"],
        "c_stream_tokens_equal_or_diverge_below_margin": all(d["ok"] for d in stream_diverged),
        "c_drafts_proposed": spec_window["spec_draft_proposed_tokens_total"] > 0
        and stream_spec["proposed"] > 0,
    }
    def part(info):
        return {k: info.get(k) for k in ("wall_s", "latency_p50_s", "latency_p95_s",
                                         "statements_per_s")}
    row = {
        "phase": "fleet_path", "model": options["model"], "config": SERVE_CONFIG,
        "requests": FLEET_REQUESTS, "rate_rps": FLEET_RATE, "tokens": FLEET_TOKENS,
        "mix": [[m, p] for m, p in FLEET_MIX], "kill_after_s": FLEET_KILL_AFTER_S,
        "a_cli": {
            "wall_s": cli.get("wall_s"), "startup_s": cli.get("startup_s"),
            "latency_ms": report.get("latency_ms"),
            "statements_per_s": report.get("throughput_rps"),
            "failovers": (cli.get("fleet") or {}).get("failovers_total"),
            "time_to_recover_s": watch.get("time_to_recover_s"),
            "affinity_hit_rate": (cli.get("fleet") or {}).get("affinity_hit_rate"),
            "replica_request_counts": report.get("replica_request_counts"),
            "manager": manager, "page_store": cli.get("page_store"),
            "watch": watch,
            "slo_states": cli.get("slo_states"), "welfare": report.get("welfare"),
            "federated_ok_count": cli.get("federated_ok_count"),
            "launches": cli.get("launches"), "drain_s": cli.get("drain_s"),
            "exit_code": cli.get("exit_code"), "error": cli.get("error"),
            "statements": statement_rows,
        },
        "a_one_replica": part(windows["a_one_replica"]),
        "b_durability": durability,
        "c_speculative": {
            "init_s": init_s,
            "engine_plain": part(windows["c_engine_plain"]),
            "engine_speculative": part(spec_window),
            "engine_spec_stats": spec_stats,
            "accepted_tokens_per_dispatch": spec_stats.get("accepted_tokens_per_dispatch"),
            "draft_acceptance_rate": spec_stats.get("draft_acceptance_rate"),
            "engine_compare": {k: (v if k != "diverged" else v[:12])
                               for k, v in spec_compare.items()},
            "stream": dict(stream_spec, rows=len(cohort), equal_rows=stream_compare,
                           diverged=stream_diverged),
        },
        "launches": launches,
        "checks": checks, "ok": all(checks.values()),
    }
    return row, launches, shapes


# -- real weights: HF checkpoint, ingest, restore ----------------------------------

CHECKPOINT_MODEL = "gemma2-2b"
CHECKPOINT_SHARDS = 3
CHECKPOINT_SEED = 11
CHECKPOINT_ROWS = 4
CHECKPOINT_TOKENS = 32
CHECKPOINT_PROMPTS = (
    "Should the city add bike lanes?",
    "Write one sentence every neighbour can accept about the new park.",
    "Summarize the group's view on public transport funding.",
    "What do the agents agree on about school hours?",
)
CHECKPOINT_AGENTS = {
    "Agent 1": "Cities should build more bike lanes.",
    "Agent 2": "Roads are for cars; bikes slow traffic.",
    "Agent 3": "Only where streets are wide enough.",
}
CHECKPOINT_STATEMENTS = (
    "Build bike lanes where streets are wide enough, and keep car lanes elsewhere.",
    "The city should study traffic before deciding.",
)
#: theory.run_experiment on the card against the port's CPU run: the
#: tolerances tests/test_torch_theory.py holds the port to against JAX.
THEORY_ALPHA_RTOL = 1e-3
THEORY_TV_ATOL = 1e-3
#: HF names of the per-layer matrices: (ours, HF suffix); HF stores (out, in).
HF_MATRICES = (
    ("wq", "self_attn.q_proj.weight"), ("wk", "self_attn.k_proj.weight"),
    ("wv", "self_attn.v_proj.weight"), ("wo", "self_attn.o_proj.weight"),
    ("w_gate", "mlp.gate_proj.weight"), ("w_up", "mlp.up_proj.weight"),
    ("w_down", "mlp.down_proj.weight"),
)


def export_hf(params, config, out_dir, shards):
    """Write the port's (unquantized) params as an HF checkpoint directory:
    HF tensor names, (out, in) projections, ``shards`` files
    ``model-0000k-of-0000n.safetensors`` and a ``config.json`` naming the
    family and width.  The inverse of ``models/loader.py``; returns the
    bytes written."""
    from consensus_tpu_torch.utils import safetensors_io

    c = config
    tensors = {"model.embed_tokens.weight": params["embed"],
               "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        tensors["lm_head.weight"] = params["lm_head"]
    for i, layer in enumerate(params["layers"]):
        prefix = f"model.layers.{i}."
        for ours, hf in HF_MATRICES:
            tensors[prefix + hf] = layer[ours].t()
        tensors[prefix + "input_layernorm.weight"] = layer["attn_norm"]
        if c.use_post_norms:
            tensors[prefix + "post_attention_layernorm.weight"] = layer["post_attn_norm"]
            tensors[prefix + "pre_feedforward_layernorm.weight"] = layer["ffn_norm"]
            tensors[prefix + "post_feedforward_layernorm.weight"] = layer["post_ffn_norm"]
        else:
            tensors[prefix + "post_attention_layernorm.weight"] = layer["ffn_norm"]
    out_dir.mkdir(parents=True, exist_ok=True)
    names = sorted(tensors)
    chunk = -(-len(names) // shards)
    written = 0
    for shard in range(shards):
        file = f"model-{shard + 1:05d}-of-{shards:05d}.safetensors"
        piece = {n: tensors[n].contiguous() for n in names[shard * chunk:(shard + 1) * chunk]}
        written += safetensors_io.save_file(piece, out_dir / file, metadata={"format": "pt"})
        del piece
    family = "gemma2" if "gemma" in c.name else "llama"
    (out_dir / "config.json").write_text(json.dumps({
        "model_type": family, "hidden_size": c.d_model, "num_hidden_layers": c.n_layers,
        "num_attention_heads": c.n_heads, "num_key_value_heads": c.n_kv_heads,
        "head_dim": c.head_dim, "intermediate_size": c.ffn_hidden, "vocab_size": c.vocab_size,
        "tie_word_embeddings": c.tie_lm_head, "torch_dtype": "bfloat16",
    }, indent=1))
    return written


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*") if f.is_file())


def _params_equal(a, b) -> bool:
    """Every leaf bit for bit, int8 weights as their q and scale."""
    import torch

    from consensus_tpu_torch.utils.checkpoint import flatten_params

    (ta, qa), (tb, qb) = flatten_params(a), flatten_params(b)
    return qa == qb and ta.keys() == tb.keys() and all(
        ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape
        and bool(torch.equal(ta[k], tb[k].to(ta[k].device))) for k in ta
    )


class _HostPeak:
    """The process's largest resident set while the phase runs, sampled."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                for line in pathlib.Path("/proc/self/status").read_text().splitlines():
                    if line.startswith("VmRSS:"):
                        self.peak = max(self.peak, int(line.split()[1]) * 1024)
            except OSError:
                return
            self._stop.wait(0.05)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def checkpoint_path():
    """Real weights on gemma2-2b at full width and its real vocab (256128)
    -> (row, launches, decode shapes, the K1 case at the scoring's shape).
    In one temporary directory, removed at the end: (1) seeded random bf16
    params from ``init_params``, written as an HF checkpoint in
    CHECKPOINT_SHARDS shards; (2) ``TorchBackend(checkpoint=<hf dir>,
    quantization="int8")`` with both kernels: its params bit for bit
    ``quantize_params`` of the source; (3) ``cli/ingest_checkpoint.ingest``
    (int8, on the host CPU) and ``TorchBackend(checkpoint=<ingested>)``: its
    params bit for bit those of (2); (4) both backends generate
    CHECKPOINT_ROWS seeded rows of CHECKPOINT_TOKENS pinned tokens through
    K2 and score fixed statements under 3 agents through K1: identical ids
    and logprobs; (5) ``utils/mfu`` for (4), the walls, bytes on disk and
    peak memory; (6) ``theory.run_experiment`` at ``--quick`` size on the
    card against the port's CPU run."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from consensus_tpu_torch import theory
    from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.cli.ingest_checkpoint import ingest
    from consensus_tpu_torch.evaluation import EVAL_SYSTEM_TEMPLATE
    from consensus_tpu_torch.models.config import get_model_config
    from consensus_tpu_torch.models.loader import infer_config_name
    from consensus_tpu_torch.models.quant import quantize_params
    from consensus_tpu_torch.models.transformer import init_params
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa
    from consensus_tpu_torch.utils import mfu

    config = get_model_config(CHECKPOINT_MODEL)
    options = dict(model=CHECKPOINT_MODEL, quantization="int8", use_flash_attention=True,
                   use_decode_attention=True, pin_generation_budget=True, device="cuda")
    generate = [GenerationRequest(user_prompt=p, max_tokens=CHECKPOINT_TOKENS, temperature=1.0,
                                  seed=100 + i) for i, p in enumerate(CHECKPOINT_PROMPTS)]
    score = [ScoreRequest(context=EVAL_SYSTEM_TEMPLATE.format(issue=CHECKPOINT_PROMPTS[0],
                                                              opinion=opinion),
                          continuation=statement, role="user")
             for statement in CHECKPOINT_STATEMENTS for opinion in CHECKPOINT_AGENTS.values()]
    walls, sizes, runs = {}, {}, {}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    root = pathlib.Path(tempfile.mkdtemp(prefix="checkpoint_path_", dir=OUT_DIR))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _HostPeak() as host:
            t0 = time.perf_counter()
            generator = torch.Generator(device="cuda")
            generator.manual_seed(CHECKPOINT_SEED)
            source = init_params(config, generator, "cuda", torch.bfloat16)
            torch.cuda.synchronize()
            walls["init_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            hf_dir = root / "hf"
            export_hf(source, config, hf_dir, CHECKPOINT_SHARDS)
            walls["write_s"] = time.perf_counter() - t0
            sizes["hf_bytes"] = _dir_bytes(hf_dir)
            inferred = infer_config_name(str(hf_dir))

            t0 = time.perf_counter()
            from_hf = TorchBackend(checkpoint=str(hf_dir), **options)
            torch.cuda.synchronize()
            walls["hf_load_s"] = time.perf_counter() - t0
            hf_equal = _params_equal(from_hf.params, quantize_params(source))
            del source
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            ingested = ingest(str(hf_dir), str(root / "ingested"), model=None,
                              quantization="int8", dtype="bfloat16")
            walls["ingest_s"] = time.perf_counter() - t0
            sizes["ingested_bytes"] = _dir_bytes(ingested)
            t0 = time.perf_counter()
            restored = TorchBackend(checkpoint=str(ingested), **options)
            torch.cuda.synchronize()
            walls["restore_s"] = time.perf_counter() - t0
            restored_equal = _params_equal(restored.params, from_hf.params)

            # One short warm-up call of each kind outside the window: the
            # timed runs measure the model, not first-call set-up.
            from_hf.generate([dataclasses.replace(generate[0], max_tokens=2)])
            from_hf.score(score[:1])
            torch.cuda.synchronize()
            fa.launches.reset()
            da.launches.reset()
            for name, backend in (("hf", from_hf), ("ingested", restored)):
                t0 = time.perf_counter()
                generated = backend.generate(generate)
                torch.cuda.synchronize()
                generate_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                scored = backend.score(score)
                torch.cuda.synchronize()
                runs[name] = {"generate_s": generate_s, "score_s": time.perf_counter() - t0,
                              "ids": [list(r.token_ids) for r in generated],
                              "logprobs": [list(r.logprobs) for r in scored]}
            launches = {"flash_attention": fa.launches.count, "decode_attention": da.launches.count}
            decode_shapes = {k: (c, a) for k, (c, a) in da.launches.shapes.items()}
            last_flash = (fa.launches.last_shapes,
                          tuple(t.tolist() for t in fa.launches.last_spans)
                          ) if launches["flash_attention"] else None
            device_peak_gb = torch.cuda.max_memory_allocated() / 1e9
            vocab = from_hf.config.vocab_size
            del from_hf, restored
            torch.cuda.empty_cache()

            t0 = time.perf_counter()
            card_curves, card_tv = theory.run_experiment(**theory.QUICK, out_plot=None,
                                                         device="cuda")
            walls["theory_card_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu_curves, cpu_tv = theory.run_experiment(**theory.QUICK, out_plot=None,
                                                       device="cpu")
            walls["theory_cpu_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    n_params = mfu.param_count(config)
    tokens = sum(len(ids) for ids in runs["hf"]["ids"]) + sum(
        len(lp) for lp in runs["hf"]["logprobs"])
    for run in runs.values():
        run["tokens"] = tokens
        run["wall_s"] = run["generate_s"] + run["score_s"]
        run["tflops"] = mfu.useful_tflops_per_sec(n_params, tokens, run["wall_s"])
        run["pct_of_h100_peak"] = mfu.pct_of_peak(run["tflops"])
    theory_match = card_curves.keys() == cpu_curves.keys() and all(
        np.allclose(card_curves[k], cpu_curves[k], rtol=THEORY_ALPHA_RTOL, atol=0)
        for k in cpu_curves) and abs(card_tv - cpu_tv) <= THEORY_TV_ATOL
    flash_case_row = None
    if last_flash is not None:
        (q_shape, k_shape), (lens, starts) = last_flash
        flash_case_row = flash_case(
            "gemma2-2b checkpoint scoring, last launch's shape and spans", q_shape[0],
            q_shape[1], q_shape[2], k_shape[2], q_shape[3], lens, starts, seed=53,
            scale=config.q_scale, softcap=config.attn_softcap,
        )
    generated_rows = runs["hf"]["ids"]
    checks = {
        "infer_config_name_gemma2_2b": inferred == CHECKPOINT_MODEL,
        "real_vocab": vocab == config.vocab_size == 256128,
        "hf_params_eq_quantize_params_of_source": hf_equal,
        "restored_params_eq_hf_params": restored_equal,
        "identical_token_ids": runs["hf"]["ids"] == runs["ingested"]["ids"],
        "identical_logprobs": runs["hf"]["logprobs"] == runs["ingested"]["logprobs"],
        "rows_of_pinned_length": len(generated_rows) == CHECKPOINT_ROWS and all(
            len(ids) == CHECKPOINT_TOKENS for ids in generated_rows),
        "logprobs_finite": all(np.isfinite(lp).all() and len(lp) > 0
                               for lp in runs["hf"]["logprobs"]),
        "flash_launched": launches["flash_attention"] > 0,
        "decode_launched": launches["decode_attention"] > 0,
        "gemma2_2b_flash_case_within_tolerance": bool(flash_case_row and flash_case_row["ok"]),
        "theory_card_matches_cpu": bool(theory_match),
        "temporary_directory_removed": not root.exists(),
    }
    row = {
        "phase": "checkpoint_path", "model": CHECKPOINT_MODEL, "d_model": config.d_model,
        "n_layers": config.n_layers, "vocab": vocab, "shards": CHECKPOINT_SHARDS,
        "walls": walls, "bytes_on_disk": sizes,
        "peak_memory_gb": {"device": device_peak_gb, "host_rss": host.peak / 1e9},
        "runs": {name: {k: v for k, v in run.items() if k not in ("ids", "logprobs")}
                 for name, run in runs.items()},
        "first_row_ids": generated_rows[0][:16] if generated_rows else [],
        "n_params": n_params,
        "theory": {"card": {"alphas": card_curves, "tv": card_tv},
                   "cpu": {"alphas": cpu_curves, "tv": cpu_tv},
                   "tolerance": f"alphas rtol {THEORY_ALPHA_RTOL}, tv atol {THEORY_TV_ATOL}"},
        "launches": launches,
        "decode_shapes": [
            {"q": list(q), "trunk": list(t), "tail": list(l), "launches": count}
            for (q, t, l), (count, _) in decode_shapes.items()
        ],
        "gemma2_2b_flash_case": flash_case_row,
        "checks": checks, "ok": all(checks.values()),
    }
    return row, launches, decode_shapes, flash_case_row


#: parallel_path: the data-parallel device mesh.  The plan covers the cards
#: present (dp over cuda:0..3 with four); with one card it is dp=2 over
#: cuda:0 twice.  PARALLEL_DEVICE "cpu" rehearses it on CPU shards.
PARALLEL_DEVICE = "cuda"
PARALLEL_MAX_DP = 4
#: (b): main_path's best-of-N config with every method's budget cut to this.
PARALLEL_TOKENS = 8
#: (c): gemma2-2b at full width, TRAIN_ROWS rows x TRAIN_SEQ tokens per
#: shard, TRAIN_STEPS AdamW steps on one seeded batch at optax's default
#: rate (1e-3 overshot: 12.91, 9.50, 10.96 on the card).
TRAIN_MODEL = "gemma2-2b"
TRAIN_SEED = 13
TRAIN_ROWS = 2
TRAIN_SEQ = 256
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
#: The dp=N first-step gradients against dp=1's on the whole batch: the
#: L2 norm of the difference over the L2 norm of dp=1's, over every leaf
#: (bf16 gradients of two sums in different orders).
TRAIN_GRAD_RTOL = 2e-2
#: (d): ring attention at llama3-8b's head shape.
RING_SHAPE = (1, 8192, 32, 128)
#: One peer copy timed between the first two distinct cards.
PEER_COPY_BYTES = 1 << 28


def _parallel_plan():
    import torch
    from consensus_tpu_torch.parallel.mesh import make_mesh

    if PARALLEL_DEVICE == "cpu":
        return make_mesh(["cpu", "cpu"], tp=1)
    n = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(min(n, PARALLEL_MAX_DP))] if n > 1
               else ["cuda:0", "cuda:0"])
    return make_mesh(devices, tp=1)


def _cross_device_launch_check(index, heads=32, kv=8, hd=128):
    """K1 and K2 launched on tensors of ``cuda:index`` while cuda:0 is the
    current device, each against its plain version (the launch must take
    its own device's context and stream), at ``heads`` / ``kv`` heads of
    ``hd``."""
    import torch
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", index)
    g = torch.Generator(device=device).manual_seed(40 + index)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    torch.cuda.set_device(0)
    q, k, v = randn(2, 256, heads, hd), randn(2, 256, kv, hd), randn(2, 256, kv, hd)
    lens = torch.tensor([256, 100], dtype=torch.int32, device=device)
    sts = torch.zeros(2, dtype=torch.int32, device=device)
    out = fa.flash_attention(q, k, v, lens, sts)
    flash_ok, flash_err, _ = compare(out, fa.flash_attention_reference(q, k, v, lens, sts))
    args = (randn(8, heads, hd), randn(4, 300, kv, hd), randn(4, 300, kv, hd),
            randn(8, 64, kv, hd), randn(8, 64, kv, hd),
            torch.tensor([0, 50, 100, 299], dtype=torch.int32, device=device),
            torch.tensor([300, 250, 200, 1], dtype=torch.int32, device=device) + 10, 10, 2, 4)
    out = da.decode_attention(*args, scale=hd ** -0.5)
    decode_ok, decode_err, _ = compare(
        out, da.decode_attention_reference(*args, scale=hd ** -0.5))
    torch.cuda.synchronize(device)
    return {"device": str(device), "current_device": torch.cuda.current_device(),
            "heads": [heads, kv, hd],
            "flash_ok": flash_ok, "flash_max_abs_err": flash_err,
            "decode_ok": decode_ok, "decode_max_abs_err": decode_err,
            "ok": flash_ok and decode_ok}


def parallel_kernel_cases():
    """One K1 and one K2 case on each card beyond the first (the kernels'
    shared-memory limit is set per device), and the launch of both with
    cuda:0 current on tensors of that card."""
    import torch

    rows = []
    for index in range(1, torch.cuda.device_count()):
        with torch.cuda.device(index):
            flash = flash_case(f"llama3-8b scoring on cuda:{index}", 8, 768, 32, 8, 128,
                               [768, 700, 512, 384, 300, 768, 200, 650], [0] * 8, seed=50 + index)
            decode = decode_case(f"llama3-8b beam on cuda:{index}", 4, 6, 32, 8, 128, 1024, 200,
                                 DECODE_STARTS, 100, seed=60 + index)
        cross = _cross_device_launch_check(index)
        rows.append({"device": f"cuda:{index}", "flash_attention": flash,
                     "decode_attention": decode, "cross_device_launch": cross,
                     "ok": flash["ok"] and decode["ok"] and cross["ok"]})
    return rows


class _RecordedSession:
    """A search session that records its spec, the proposals of every step
    and every (parents, chosen) decision into ``log``; other attributes
    read through to the session."""

    def __init__(self, session, spec, log):
        self._session = session
        self.spec = spec
        self._log = log
        log.update(spec=spec, proposals=[], decisions=[])

    def __getattr__(self, name):
        return getattr(self._session, name)

    def propose(self):
        out = self._session.propose()
        self._log["proposals"].append(out)
        return out

    def advance_and_propose(self, parents, chosen):
        self._log["decisions"].append((list(parents), list(chosen)))
        out = self._session.advance_and_propose(parents, chosen)
        self._log["proposals"].append(out)
        return out

    def close(self):
        return self._session.close()


def _replay_session(backend, log):
    """``backend``'s session for the recorded spec, teacher-forced along the
    recorded decisions -> (session class name, proposals of every step)."""
    session = backend.open_fused_token_search(log["spec"])
    try:
        steps = [session.propose()]
        for parents, chosen in log["decisions"]:
            steps.append(session.advance_and_propose(parents, chosen))
        return type(session).__name__, steps
    finally:
        session.close()


def _proposal_diffs(backend, spec, ref_steps, got_steps):
    """Two sessions' proposals for one seeded spec, step by step: the max
    |difference| of the reference and agent logprobs of the candidates both
    proposed at the same rank, and of the rank-wise perturbed scores
    (reference logprob / temperature + the slot's Gumbel noise, rebuilt
    from the session key).  Top-k order makes the rank-wise scores move no
    more than the logits do, so they bound a near-tie that swaps two
    tokens; ``swapped`` counts the ranks whose ids differ."""
    import torch
    from consensus_tpu_torch.models.sampling import gumbel_noise
    from consensus_tpu_torch.utils import threefry

    key = backend._fold_seed("search", spec.seed)
    vocab = backend.config.vocab_size
    rows = []
    for step, (ref, got) in enumerate(zip(ref_steps, got_steps)):
        noise = None
        if spec.sample:
            step_key = threefry.fold_in(threefry.fold_in(key, 0), step)
            slots = torch.arange(len(ref), dtype=torch.int64, device=key.device)
            noise = gumbel_noise(threefry.fold_in(step_key, slots), vocab).cpu()
        lp_err = score_err = 0.0
        swapped = 0
        for slot, (a_row, b_row) in enumerate(zip(ref, got)):
            for a, b in zip(a_row, b_row):
                if a.token_id == b.token_id:
                    lp_err = max(lp_err, abs(a.ref_logprob - b.ref_logprob), *(
                        abs(x - y) for x, y in zip(a.agent_logprobs, b.agent_logprobs)))
                else:
                    swapped += 1

                def perturbed(c):
                    g = float(noise[slot, c.token_id]) if noise is not None else 0.0
                    return c.ref_logprob / max(float(spec.temperature), 1e-6) + g

                score_err = max(score_err, abs(perturbed(a) - perturbed(b)))
        rows.append({"step": step, "logprob_max_abs_err": lp_err,
                     "perturbed_max_abs_err": score_err, "swapped": swapped})
    return rows


def _beam_departure(ref_steps, got_steps, beam_width):
    """The first step at which the beam method's pruning
    (``BeamSearchGenerator._prune``, EOS strings completing) keeps other
    beams over ``got_steps``' proposals than over ``ref_steps``', both
    along the reference path and each with its own cumulative rewards; None
    if they keep the same beams at every step."""
    from consensus_tpu_torch.methods.beam_search import EOS_TOKENS, BeamSearchGenerator

    n_agents = len(ref_steps[0][0][0].agent_logprobs)
    beams = {name: [("", [0.0] * n_agents, 0)] for name in ("ref", "got")}
    completed = {"ref": [], "got": []}
    for step, pair in enumerate(zip(ref_steps, got_steps)):
        kept = {}
        for name, proposals in zip(("ref", "got"), pair):
            candidates = [(seq + c.token, [a + b for a, b in zip(rewards, c.agent_logprobs)],
                           c, slot)
                          for seq, rewards, slot in beams[name] for c in proposals[slot]]
            kept[name], completed[name] = BeamSearchGenerator._prune(
                candidates, completed[name], beam_width, EOS_TOKENS)
        if ([b[0] for b in kept["ref"]] != [b[0] for b in kept["got"]]
                or [c[0] for c in completed["ref"]] != [c[0] for c in completed["got"]]):
            return step
        for name in kept:
            beams[name] = [(seq, rewards, i) for i, (seq, rewards, _, _) in enumerate(kept[name])]
    return None


def _scripted_session_log(backend, spec, dp):
    """A session of ``backend`` over ``spec`` widened to a multiple of dp
    slots, advanced along scripted decisions whose parents cross the shard
    blocks (slot s takes parent s + step + 1, mod the slots) -> its log."""
    import dataclasses

    n = -(-max(spec.n_slots, dp) // dp) * dp
    wide_spec = dataclasses.replace(spec, n_slots=n, k=max(spec.k, 2))
    log = {}
    session = _RecordedSession(backend.open_fused_token_search(wide_spec), wide_spec, log)
    try:
        out = session.propose()
        for step in range(wide_spec.max_steps - 1):
            parents = [(s + step + 1) % n for s in range(n)]
            out = session.advance_and_propose(
                parents, [out[p][step % wide_spec.k] for p in parents])
    finally:
        session.close()
    return log


def _row_count_floor(backend, spec, m):
    """What the slot count of a step alone moves, on one card: ``backend``'s
    session over ``spec``'s n slots, each slot its own parent taking its
    candidate of rank (step mod k), against a session over the first ``m``
    slots along the same decisions (the same inputs and noise, fewer rows a
    step, as a dp shard's part has) -> the max |difference| of their
    logprobs."""
    import dataclasses

    n = spec.n_slots
    log = {}
    session = _RecordedSession(backend.open_fused_token_search(spec), spec, log)
    try:
        out = session.propose()
        for step in range(spec.max_steps - 1):
            out = session.advance_and_propose(
                list(range(n)), [out[slot][step % spec.k] for slot in range(n)])
    finally:
        session.close()
    narrow = {"spec": dataclasses.replace(spec, n_slots=m),
              "decisions": [(parents[:m], chosen[:m]) for parents, chosen in log["decisions"]]}
    _, steps = _replay_session(backend, narrow)
    diffs = _proposal_diffs(backend, spec, [out[:m] for out in log["proposals"]], steps)
    return max(d["logprob_max_abs_err"] for d in diffs)


def _session_parity(backend, wide, log):
    """Replay ``log`` on ``wide``: its session class and the step-by-step
    diffs against the recorded proposals; ``ok`` when every step holds
    both maxima within ROUTE_ATOL."""
    kind, steps = _replay_session(wide, log)
    diffs = _proposal_diffs(backend, log["spec"], log["proposals"], steps)
    return {"session": kind, "slots": log["spec"].n_slots, "steps": len(steps),
            "logprob_max_abs_err": max(d["logprob_max_abs_err"] for d in diffs),
            "perturbed_max_abs_err": max(d["perturbed_max_abs_err"] for d in diffs),
            "swapped": sum(d["swapped"] for d in diffs),
            "per_step_logprob_max_abs_err": [d["logprob_max_abs_err"] for d in diffs],
            "ok": all(d["logprob_max_abs_err"] <= ROUTE_ATOL
                      and d["perturbed_max_abs_err"] <= ROUTE_ATOL for d in diffs)}, steps


def _parallel_serve(plan, options, scenario, params, on_card):
    """(a): the serve CLI with ``--mesh dp=N`` against the same requests
    through ``create_server(mesh="dp=1,tp=1")`` and the plain engine path in
    process, posted one at a time there so that both see the same cohorts
    and each generate call and search session is the posted request's.
    A statement that differs from dp=1's passes only on its own request's
    evidence: a generate request's recorded dp=1 draws hold one under
    DRAW_MARGIN; a beam request's session, replayed on the dp=N backend
    along the dp=1 decisions, stays within ROUTE_ATOL of dp=1's at every
    step and its pruning departs from dp=1's at some step.  Apart from the
    statements, a session of dp x slots on the dp=N backend (the sharded
    session, its parents crossing shards) is held against the dp=1 session
    along the same decisions."""
    import torch
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.obs.metrics import Registry
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa
    from consensus_tpu_torch.serve import create_server

    payloads = _serve_payloads(scenario, cut=True)
    cli_options = dict(options)
    if plan.distinct_devices < plan.dp:
        cli_options["mesh_devices"] = [str(d) for d in plan.data_devices]
    cli = _serve_subprocess(cli_options, payloads, PARALLEL_DEVICE,
                            extra_args=("--mesh", f"dp={plan.dp},tp=1"), tag="parallel_serve")
    backend = TorchBackend(**options, params=params, device=PARALLEL_DEVICE)
    generated, by_payload, sessions = {}, {}, {}
    mode = {"name": "", "request": None}
    dense_generate, dense_open = backend.generate, backend.open_fused_token_search

    def generate(requests, shards=None):
        results = dense_generate(requests, shards=shards)
        table = generated.setdefault(mode["name"], {})
        mine = by_payload.setdefault(mode["name"], {}).setdefault(mode["request"], [])
        for request, result in zip(requests, results):
            table.setdefault(_request_key(request), []).append((request, tuple(result.token_ids)))
            mine.append((request, tuple(result.token_ids)))
        return results

    def open_fused_token_search(spec):
        log = {}
        sessions.setdefault(mode["name"], {}).setdefault(mode["request"], []).append(log)
        return _RecordedSession(dense_open(spec), spec, log)

    backend.generate, backend.open_fused_token_search = generate, open_fused_token_search
    windows = {}
    try:
        for name, extra in (("plain", {}), ("mesh_dp1", {"mesh": "dp=1,tp=1"})):
            mode["name"] = name
            fa.launches.reset()
            da.launches.reset()
            server = create_server(backend=backend, port=0, registry=Registry(), max_inflight=4,
                                   default_timeout_s=SERVE_REQUEST_S, **extra).start()
            try:
                t0 = time.perf_counter()
                results = []
                for payload in payloads:
                    mode["request"] = payload["request_id"]
                    results.append(_http(server.base_url + "/v1/consensus", payload))
                wall = time.perf_counter() - t0
                _, health, _ = _http(server.base_url + "/healthz")
            finally:
                server.stop()
            windows[name] = {
                "statuses": [status for status, _, _ in results], "wall_s": wall,
                "statements": [json.loads(body).get("statement") for _, body, _ in results],
                "mesh": (json.loads(health).get("engine") or {}).get("mesh"),
                "launches": {"flash_attention": fa.launches.count,
                             "decode_attention": da.launches.count},
                "launches_by_device": {"flash_attention": dict(fa.launches.by_device),
                                       "decode_attention": dict(da.launches.by_device)},
            }
    finally:
        backend.generate, backend.open_fused_token_search = dense_generate, dense_open
    wide = TorchBackend(**options, params=backend.params, mesh=plan)
    statement_rows = []
    for payload, got, want in zip(payloads, cli.get("statements") or [],
                                  windows["mesh_dp1"]["statements"]):
        rid = payload["request_id"]
        row = {"request_id": rid, "method": payload["method"], "equal": got == want}
        logs = sessions.get("mesh_dp1", {}).get(rid, [])
        if logs:
            # One beam session per request: replayed whether or not the
            # statements differ.
            replay, steps = _session_parity(backend, wide, logs[0])
            replay["departs_at_step"] = _beam_departure(
                logs[0]["proposals"], steps, payload["params"]["beam_width"])
            row["replay"] = replay
            row["ok"] = row["equal"] or (replay["ok"] and replay["departs_at_step"] is not None)
        else:
            if not row["equal"]:
                entries = [e for e in by_payload.get("mesh_dp1", {}).get(rid, [])
                           if e[0].seed is not None]
                row["near_tie"] = _trajectory_near_tie(backend, entries)
            row["ok"] = row["equal"] or row.get("near_tie") is not None
        statement_rows.append(row)
    beam = next((logs[0] for logs in sessions.get("mesh_dp1", {}).values() if logs), None)
    sharded = None
    if beam is not None:
        scripted = _scripted_session_log(backend, beam["spec"], plan.dp)
        sharded, _ = _session_parity(backend, wide, scripted)
        sharded["row_count_floor"] = _row_count_floor(
            backend, scripted["spec"], scripted["spec"].n_slots // plan.dp)
    del backend, wide
    if on_card:
        torch.cuda.empty_cache()
    per_shard = (cli.get("healthz", {}).get("mesh") or {}).get("per_shard") or []
    distinct = sorted({str(d) for d in plan.data_devices})
    by_device = cli.get("launches_by_device", {})
    checks = {
        "a_served_every_request": cli.get("statuses") == [200] * len(payloads),
        "a_drained_and_exited_0": cli.get("exit_code") == 0,
        "a_one_shard_per_dp_in_per_shard": len(per_shard) == plan.dp,
        "a_statements_equal_dp1_or_explained": bool(statement_rows) and all(
            r["ok"] for r in statement_rows),
        "a_sharded_session_within_atol_of_whole": (
            sharded is not None and sharded["session"] == "_ShardedSearchSession"
            and sharded["ok"]),
        "a_dp1_mesh_byte_identical_to_plain_engine": (
            windows["mesh_dp1"]["statements"] == windows["plain"]["statements"]
            and generated.get("mesh_dp1") == generated.get("plain")),
        "a_in_process_served": all(w["statuses"] == [200] * len(payloads)
                                   for w in windows.values()),
    }
    if on_card:
        checks["a_flash_launched_on_every_card"] = all(
            by_device.get("flash_attention", {}).get(d, 0) > 0 for d in distinct)
        checks["a_decode_launched_on_every_card"] = all(
            by_device.get("decode_attention", {}).get(d, 0) > 0 for d in distinct)
    launches = {k: cli.get("launches", {}).get(k, 0)
                + sum(w["launches"][k] for w in windows.values()) for k in KERNELS}
    return {"cli": cli, "windows": windows, "statements": statement_rows,
            "sharded_session": sharded, "per_shard": per_shard}, checks, launches


def _plan_name(plan):
    return f"dp{plan.dp}" if plan.tp == 1 else f"dp{plan.dp}_tp{plan.tp}"


def _plan_devices(plan):
    """Every distinct device of the plan's grid, sorted."""
    return sorted({str(d) for row in plan.devices for d in row})


def _parallel_experiment(plans, params, on_card, prefix="b", decode_kernel=False):
    """main_path's best-of-N config, every budget cut to PARALLEL_TOKENS,
    through ``Experiment`` on ``TorchBackend`` over each plan and on the
    one-device backend over the same weights: generate ids equal or first
    differing at a draw of margin under DRAW_MARGIN, the logprobs of every
    score request both ran within ROUTE_ATOL, K1 launched on every card of
    each plan, and with ``decode_kernel``, which routes generation through
    the monolithic loops, K2 on every card over the plans' runs (a dp
    shard whose rows are all bucket padding starts done and decodes
    nothing).  Returns (summary,
    checks, launches, launches by device, the backends' weight bytes per
    card)."""
    import torch
    import yaml
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.experiment import Experiment
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa

    config = yaml.safe_load((ROOT / CONFIG).read_text())
    config["output_dir"] = str(OUT_DIR)
    for method in config["methods_to_run"]:
        if "max_tokens" in (config.get(method) or {}):
            config[method]["max_tokens"] = PARALLEL_TOKENS
    options = {k: v for k, v in config["backend_options"].items() if k not in ("tp", "dp")}
    if decode_kernel:
        options["use_decode_attention"] = True
    runs = {}
    launches = {k: 0 for k in KERNELS}
    by_device = {k: {} for k in KERNELS}
    weight_bytes = {}
    one = TorchBackend(**options, params=params, device=PARALLEL_DEVICE)
    weight_bytes["dp1"] = _weight_bytes_by_device(one.params)
    for name, plan in [("dp1", None)] + [(_plan_name(p), p) for p in plans]:
        backend = one if plan is None else TorchBackend(**options, params=one.params, mesh=plan)
        if plan is not None:
            weight_bytes[name] = _weight_bytes_by_device(backend.params)
        generated, scored = {}, {}
        dense_generate, dense_score = backend.generate, backend.score

        def generate(requests, _g=dense_generate, _t=generated):
            results = _g(requests)
            for request, result in zip(requests, results):
                _t.setdefault(_request_key(request), []).append((request, tuple(result.token_ids)))
            return results

        def score(requests, _s=dense_score, _t=scored):
            results = _s(requests)
            for request, result in zip(requests, results):
                _t[(request.system_prompt, request.context, request.continuation)] = result.logprobs
            return results

        backend.generate, backend.score = generate, score
        fa.launches.reset()
        da.launches.reset()
        t0 = time.perf_counter()
        frame = Experiment(dict(config), backend=backend).run()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, counter in (("flash_attention", fa.launches), ("decode_attention", da.launches)):
            launches[k] += counter.count
            for d, n in counter.by_device.items():
                by_device[k][d] = by_device[k].get(d, 0) + n
        runs[name] = {"wall_s": wall, "generated": generated, "scored": scored,
                      "statements": list(frame["statement"]),
                      "errors": [e for e in frame["error_message"] if e],
                      "launches": {"flash_attention": fa.launches.count,
                                   "decode_attention": da.launches.count},
                      "flash_by_device": dict(fa.launches.by_device),
                      "decode_by_device": dict(da.launches.by_device)}
        backend.generate, backend.score = dense_generate, dense_score
        if plan is not None:
            del backend
            if on_card:
                torch.cuda.empty_cache()
    ref = runs["dp1"]
    checks = {f"{prefix}_rows_error_free": not ref["errors"]}
    compares, score_errs = {}, {}
    for plan in plans:
        name = _plan_name(plan)
        got = runs[name]
        compare = _compare_generations(one, got["generated"], ref["generated"])
        common = set(ref["scored"]) & set(got["scored"])
        score_err = max((abs(a - b) for key in common
                         for a, b in zip(ref["scored"][key], got["scored"][key])), default=None)
        compares[name] = dict(compare, diverged=compare["diverged"][:12],
                              score_requests_compared=len(common))
        score_errs[name] = score_err
        distinct = _plan_devices(plan)
        plan_checks = {
            f"{prefix}_rows_error_free": not got["errors"],
            f"{prefix}_ids_equal_or_diverge_below_margin": (
                compare["only_one_mode"] == 0 and all(d["ok"] for d in compare["diverged"])),
            f"{prefix}_scores_within_atol": score_err is not None and score_err <= ROUTE_ATOL,
        }
        if on_card:
            plan_checks[f"{prefix}_flash_launched_on_every_card"] = all(
                got["flash_by_device"].get(d, 0) > 0 for d in distinct)
        for key, value in plan_checks.items():
            checks[key] = checks.get(key, True) and value
    if on_card and decode_kernel:
        cards = {d for plan in plans for d in _plan_devices(plan)}
        checks[f"{prefix}_decode_launched_on_every_card"] = all(
            any(runs[_plan_name(plan)]["decode_by_device"].get(d, 0) > 0 for plan in plans)
            for d in cards)
    del one
    if on_card:
        torch.cuda.empty_cache()
    summary = {name: {k: v for k, v in run.items() if k not in ("generated", "scored")}
               for name, run in runs.items()}
    if len(plans) == 1:
        name = _plan_name(plans[0])
        summary["generation_compare"] = compares[name]
        summary["score_requests_compared"] = compares[name]["score_requests_compared"]
        summary["max_score_logprob_diff"] = score_errs[name]
    else:
        summary["generation_compare"] = compares
        summary["max_score_logprob_diff"] = score_errs
    return summary, checks, launches, by_device, weight_bytes


def _weight_bytes_by_device(params):
    """Bytes of a parameter tree's tensors per device (every rank's tree of
    a tensor-parallel model)."""
    from consensus_tpu_torch.models.quant import QTensor
    from consensus_tpu_torch.parallel.tensor import TPParams

    trees = params.ranks if isinstance(params, TPParams) else (params,)
    out = {}
    for tree in trees:
        leaves = [leaf for name, value in tree.items()
                  for leaf in ([v for layer in value for v in layer.values()]
                               if name == "layers" else [value])]
        for leaf in leaves:
            for t in ((leaf.q, leaf.scale) if isinstance(leaf, QTensor) else (leaf,)):
                key = str(t.device)
                out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def _grad_rel_err(got, want):
    import torch

    num = sum(float(((g.float() - w.float().to(g.device)) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float((w.float() ** 2).sum()) for w in want)
    return (num / max(den, 1e-30)) ** 0.5


def _split_contraction_grads(params, config, tokens, valid):
    """One device's gradients with layer 0's two row-parallel contractions
    (``wo``, ``w_down``) each taken as two float32 halves, summed, then
    rounded once: the same sums in another order, which is all that a tp=2
    split of a contraction changes there."""
    from consensus_tpu_torch.models import transformer as tf
    from consensus_tpu_torch.parallel.train import shard_grads

    plain = tf._finish_layer
    calls = [0]

    def halves(a, w):
        k = a.shape[-1] // 2
        return (tf._row_parallel(a[..., :k], w[:k])
                + tf._row_parallel(a[..., k:], w[k:])).to(a.dtype)

    def finish(c, lp, x, attn):
        calls[0] += 1
        if calls[0] > 1:
            return plain(c, lp, x, attn)
        attn = halves(attn, lp["wo"])
        if c.use_post_norms:
            attn = tf.rms_norm(attn, lp["post_attn_norm"], c.rms_eps, c.rmsnorm_style)
        x = x + attn
        ffn = halves(tf._gated(c, lp, tf.rms_norm(x, lp["ffn_norm"], c.rms_eps,
                                                  c.rmsnorm_style)), lp["w_down"])
        if c.use_post_norms:
            ffn = tf.rms_norm(ffn, lp["post_ffn_norm"], c.rms_eps, c.rmsnorm_style)
        return x + ffn

    tf._finish_layer = finish
    try:
        return shard_grads(params, config, tokens, valid, None)[1]
    finally:
        tf._finish_layer = plain


def _float32_copy(params):
    """A float32 copy of a parameter tree, its leaves trainable."""
    def leaf(t):
        return t.detach().float().requires_grad_(True)

    return {name: ([{k: leaf(v) for k, v in layer.items()} for layer in value]
                   if name == "layers" else leaf(value))
            for name, value in params.items()}


def _parallel_train(plan, on_card, prefix="c"):
    """``train_step`` on gemma2-2b at full width over the plan: parallel_path
    (c) over dp shards, tensor_parallel_path (d) over tp ranks.  Over dp the
    first step's bf16 gradients are held against one device's.  Over tp
    they are recorded beside what one reordered sum moves them on one
    device (``_split_contraction_grads``): in bf16 that is most of tp's
    difference, so the gradients are held against one device's on float32
    copies of the same weights, where a rank's slice or a replicated leaf
    assembled wrongly stands out."""
    import torch
    from consensus_tpu_torch.models.config import get_model_config
    from consensus_tpu_torch.models.transformer import init_params
    from consensus_tpu_torch.parallel.train import init_train_state, shard_grads, train_step

    config = get_model_config(TRAIN_MODEL)
    device = plan.data_devices[0]
    generator = torch.Generator(device=device)
    generator.manual_seed(TRAIN_SEED)
    t0 = time.perf_counter()
    params = init_params(config, generator, device, torch.bfloat16)
    rows = TRAIN_ROWS * plan.dp
    tokens = torch.randint(0, config.vocab_size, (rows, TRAIN_SEQ), generator=generator,
                           device=device, dtype=torch.int64).to(torch.int32)
    valid = torch.ones((rows, TRAIN_SEQ), dtype=torch.bool, device=device)
    valid[-1, TRAIN_SEQ * 3 // 4:] = False  # one right-padded row
    params, opt_state, optimizer = init_train_state(params, learning_rate=TRAIN_LR)
    init_s = time.perf_counter() - t0
    cards = _plan_devices(plan)
    loss_n, grads_n = shard_grads(params, config, tokens, valid, plan)
    loss_1, grads_1 = shard_grads(params, config, tokens, valid, None)
    grad_err = _grad_rel_err(grads_n, grads_1)
    loss_diff = abs(float(loss_n) - float(loss_1))
    del grads_n
    extra = {}
    if plan.tp > 1:
        extra["grad_rel_l2_err_bf16"] = grad_err
        extra["split_contraction_rel_l2_err_bf16"] = _grad_rel_err(
            _split_contraction_grads(params, config, tokens, valid), grads_1)
        del grads_1
        wide = _float32_copy(params)
        _, grads_n = shard_grads(wide, config, tokens, valid, plan)
        _, grads_1 = shard_grads(wide, config, tokens, valid, None)
        grad_err = _grad_rel_err(grads_n, grads_1)
        extra["grads_compared_in"] = "float32"
        del wide, grads_n
    del grads_1
    if on_card:
        torch.cuda.empty_cache()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state, config, optimizer, tokens, valid,
                                             plan=plan)
        losses.append(float(loss))
        if on_card:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peaks = {d: torch.cuda.max_memory_allocated(d) / 1e9 for d in cards} if on_card else None
    del params, optimizer, opt_state
    if on_card:
        torch.cuda.empty_cache()
    axis = "dp" if plan.tp == 1 else "tp"
    checks = {
        f"{prefix}_losses_finite": all(l == l and abs(l) < float("inf") for l in losses),
        f"{prefix}_loss_falling": all(b < a for a, b in zip(losses, losses[1:])),
        f"{prefix}_{axis}_grads_match_{axis}1": grad_err <= TRAIN_GRAD_RTOL,
    }
    info = {"model": TRAIN_MODEL, "layers": config.n_layers, "vocab": config.vocab_size,
            "rows_per_shard": TRAIN_ROWS, "seq": TRAIN_SEQ, "learning_rate": TRAIN_LR,
            "init_s": init_s, "losses": losses, "step_s": step_s,
            "grad_rel_l2_err": grad_err, "grad_tolerance": TRAIN_GRAD_RTOL,
            f"first_loss_{axis}_vs_{axis}1_diff": loss_diff, **extra,
            "peak_memory_gb_of_the_steps": peaks}
    return info, checks


def _parallel_ring(plan, on_card):
    """(d): ``ring_self_attention`` over the plan's devices as the sequence
    ring, against ``full_attention_reference`` on the first; and one peer
    copy between the first two distinct cards, timed."""
    import torch
    from consensus_tpu_torch.parallel.ring_attention import (
        full_attention_reference, make_sequence_mesh, ring_self_attention)

    ring = make_sequence_mesh(devices=plan.data_devices)
    device = ring[0]
    b, seq, heads, hd = RING_SHAPE if on_card else (1, 64, 4, 16)
    dtype = torch.bfloat16 if on_card else torch.float32
    g = torch.Generator(device=device).manual_seed(70)
    q, k, v = (torch.randn((b, seq, heads, hd), generator=g, device=device).to(dtype)
               for _ in range(3))
    positions = torch.arange(seq, device=device)[None].expand(b, seq).contiguous()
    valid = torch.ones((b, seq), dtype=torch.bool, device=device)
    valid[:, : seq // 16] = False  # a left-padded span
    times = {}

    def timed(name, fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            for d in {str(x) for x in ring}:
                torch.cuda.synchronize(d)
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    ring_self_attention(ring, q, k, v, positions, valid)  # warm-up
    out = timed("ring_ms", lambda: ring_self_attention(ring, q, k, v, positions, valid))
    want = timed("full_ms", lambda: full_attention_reference(q, k, v, positions, valid))
    within, max_err, atol_needed = compare(out, want)
    peer = None
    distinct = list(dict.fromkeys(str(d) for d in ring))
    if on_card and len(distinct) > 1:
        src = torch.empty(PEER_COPY_BYTES, dtype=torch.uint8, device=distinct[0])
        dst = torch.empty(PEER_COPY_BYTES, dtype=torch.uint8, device=distinct[1])
        dst.copy_(src)
        torch.cuda.synchronize(distinct[0])
        torch.cuda.synchronize(distinct[1])
        t0 = time.perf_counter()
        for _ in range(5):
            dst.copy_(src)
        torch.cuda.synchronize(distinct[0])
        torch.cuda.synchronize(distinct[1])
        seconds = (time.perf_counter() - t0) / 5
        peer = {"from": distinct[0], "to": distinct[1], "bytes": PEER_COPY_BYTES,
                "ms": seconds * 1e3, "gb_per_s": PEER_COPY_BYTES / seconds / 1e9}
        del src, dst
    del q, k, v, out, want
    if on_card:
        torch.cuda.empty_cache()
    info = {"shape": [b, seq, heads, hd], "ring": [str(d) for d in ring], **times,
            "max_abs_err": max_err, "atol_needed": atol_needed,
            "tolerance": f"atol {ATOL} + rtol {RTOL}", "peer_copy": peer}
    return info, {"d_ring_matches_full_attention": within}


def parallel_path(params=None):
    """The data-parallel mesh -> (row, launches): (a) the
    serve CLI with ``--mesh dp=N`` on llama3-8b against the dp=1 mesh path
    and the plain engine path in process; (b) ``TorchBackend`` over the plan
    on main_path's best-of-N config against dp=1; (c) ``train_step`` on
    gemma2-2b over the plan, its gradients against dp=1's; (d)
    ``ring_self_attention`` at llama3-8b's head shape against full
    attention.  ``params``: serve_path's llama3-8b weights (built from the
    seed when None)."""
    import yaml

    on_card = PARALLEL_DEVICE == "cuda"
    plan = _parallel_plan()
    config = yaml.safe_load((ROOT / SERVE_CONFIG).read_text())
    options = {k: v for k, v in config["backend_options"].items() if k not in ("tp", "dp")}
    options["pin_generation_budget"] = True
    t0 = time.perf_counter()
    phase_s = {}
    serve_info, serve_checks, serve_launches = _parallel_serve(
        plan, options, config["scenario"], params, on_card)
    phase_s["a"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    experiment_info, experiment_checks, experiment_launches, experiment_by_device, _ = (
        _parallel_experiment([plan], params, on_card))
    phase_s["b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    train_info, train_checks = _parallel_train(plan, on_card)
    phase_s["c"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    ring_info, ring_checks = _parallel_ring(plan, on_card)
    phase_s["d"] = time.perf_counter() - t1
    checks = {**serve_checks, **experiment_checks, **train_checks, **ring_checks}
    launches = {k: serve_launches[k] + experiment_launches[k] for k in KERNELS}
    by_device = {k: dict(experiment_by_device[k]) for k in KERNELS}
    tables = [serve_info["cli"].get("launches_by_device", {})] + [
        w["launches_by_device"] for w in serve_info["windows"].values()]
    for table in tables:
        for k, counts in table.items():
            for d, n in counts.items():
                by_device[k][d] = by_device[k].get(d, 0) + n
    row = {
        "phase": "parallel_path", "plan": [[str(d) for d in r] for r in plan.devices],
        "dp": plan.dp, "distinct_devices": plan.distinct_devices,
        "serve": serve_info, "experiment": experiment_info, "train": train_info,
        "ring": ring_info, "launches": launches, "launches_by_device": by_device,
        "phase_s": phase_s, "wall_s": time.perf_counter() - t0,
        "checks": checks, "ok": all(checks.values()),
    }
    return row, launches


#: tensor_parallel_path: the device of its plans ("cpu" rehearses it with
#: tiny configs), the decode-step timing's rows, steps and trunk.
TP_DEVICE = "cuda"
TP_TIMING_ROWS = (8,)
TP_TIMING_STEPS = 4
TP_PROFILED_STEPS = 1
TP_TIMING_TRUNK = 512
#: With four cards, each card's weight bytes within this share of 1/tp of
#: the tp=1 tree's.
TP_WEIGHT_SHARE_RTOL = 0.05


def _tp_plans():
    """(main plan, more plans for (b)): tp=2 over cuda:0 twice on one card;
    dp=1 x tp=4 and dp=2 x tp=2 with four."""
    import torch
    from consensus_tpu_torch.parallel.mesh import make_mesh

    if TP_DEVICE == "cpu":
        return make_mesh(["cpu", "cpu"], tp=2), []
    n = torch.cuda.device_count()
    if n >= 4:
        cards = [f"cuda:{i}" for i in range(4)]
        return make_mesh(cards, tp=4), [make_mesh(cards, tp=2)]
    return make_mesh(["cuda:0", "cuda:0"], tp=2), []


def tp_kernel_cases(plan):
    """(a): K1 (llama3-8b and gemma2-2b scoring) and K2 (llama3-8b beam) at
    one tp rank's heads on every card of the plan, each against its plain
    version, with kernel / plain / SDPA / bound times; then both kernels at
    those heads on each card's tensors while cuda:0, the lead, is current."""
    import numpy as np
    import torch

    tp = plan.tp
    rng = np.random.default_rng(9)
    rows = []
    for device in _plan_devices(plan):
        index = torch.device(device).index
        tag = f"tp={tp} rank on {device}"
        with torch.cuda.device(index):
            cases = [
                flash_case(f"llama3-8b scoring, {tag}", 8, 768, 32 // tp, 8 // tp, 128,
                           ragged(rng, 8, 768, 192), [0] * 8, seed=90 + index),
                flash_case(f"gemma2-2b scoring, softcap 50, {tag}", 8, 512, 8 // tp, 4 // tp,
                           256, ragged(rng, 8, 512, 128), [0] * 8, seed=94 + index,
                           scale=256 ** -0.5, softcap=50.0, window=4096),
                decode_case(f"llama3-8b beam, {tag}", 4, 6, 32 // tp, 8 // tp, 128, 1024, 200,
                            DECODE_STARTS, 100, seed=98 + index),
            ]
        lead_current = _cross_device_launch_check(index, 32 // tp, 8 // tp)
        rows.append({"device": device, "heads": {"llama3-8b": [32 // tp, 8 // tp, 128],
                                                 "gemma2-2b": [8 // tp, 4 // tp, 256]},
                     "flash_attention": cases[:2], "decode_attention": cases[2:],
                     "lead_current_launch": lead_current,
                     "ok": all(c["ok"] for c in cases) and lead_current["ok"]})
    return rows


def _tp_serve(plan, one, wide, scenario, on_card, payloads=None):
    """(c): serve_path's cut requests through ``create_server(mesh=plan)``
    in process on ``wide`` (the backend over the plan) against the same
    requests through a server on ``one`` (tp=1, the same weights), posted
    one at a time.  A statement that differs from tp=1's passes only on
    its own request's evidence: a generate request's tp=1 draws hold one
    under DRAW_MARGIN; a beam request's session, replayed at tp along tp=1's
    decisions, stays within ROUTE_ATOL of tp=1's at every step and its
    pruning departs from tp=1's at some step.  The replay of the first
    recorded beam session is also the step-by-step session check, where
    ``payloads`` (default: all of serve_path's cut requests) holds a beam
    request.  Each kernel that the requests launch at tp=1 must launch on
    every card of the plan."""
    from consensus_tpu_torch.obs.metrics import Registry
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa
    from consensus_tpu_torch.serve import create_server

    if payloads is None:
        payloads = _serve_payloads(scenario, cut=True)
    by_payload, sessions = {}, {}
    current = {"request": None}
    dense_generate, dense_open = one.generate, one.open_fused_token_search

    def generate(requests, shards=None):
        results = dense_generate(requests, shards=shards)
        mine = by_payload.setdefault(current["request"], [])
        for request, result in zip(requests, results):
            mine.append((request, tuple(result.token_ids)))
        return results

    def open_fused_token_search(spec):
        log = {}
        sessions.setdefault(current["request"], []).append(log)
        return _RecordedSession(dense_open(spec), spec, log)

    windows = {}
    name = _plan_name(plan)
    for label, backend, extra in (("tp1", one, {}), (name, wide, {"mesh": plan})):
        if backend is one:
            one.generate, one.open_fused_token_search = generate, open_fused_token_search
        fa.launches.reset()
        da.launches.reset()
        server = create_server(backend=backend, port=0, registry=Registry(), max_inflight=4,
                               default_timeout_s=SERVE_REQUEST_S, **extra).start()
        try:
            t0 = time.perf_counter()
            results = []
            for payload in payloads:
                current["request"] = payload["request_id"]
                results.append(_http(server.base_url + "/v1/consensus", payload))
            wall = time.perf_counter() - t0
            _, health, _ = _http(server.base_url + "/healthz")
        finally:
            server.stop()
            one.generate, one.open_fused_token_search = dense_generate, dense_open
        windows[label] = {
            "statuses": [status for status, _, _ in results], "wall_s": wall,
            "statements": [json.loads(body).get("statement") for _, body, _ in results],
            "mesh": (json.loads(health).get("engine") or {}).get("mesh"),
            "launches": {"flash_attention": fa.launches.count,
                         "decode_attention": da.launches.count},
            "launches_by_device": {"flash_attention": dict(fa.launches.by_device),
                                   "decode_attention": dict(da.launches.by_device)},
        }
    rows = []
    for payload, got, want in zip(payloads, windows[name]["statements"],
                                  windows["tp1"]["statements"]):
        rid = payload["request_id"]
        row = {"request_id": rid, "method": payload["method"], "equal": got == want}
        logs = sessions.get(rid, [])
        if logs:
            replay, steps = _session_parity(one, wide, logs[0])
            replay["departs_at_step"] = _beam_departure(
                logs[0]["proposals"], steps, payload["params"]["beam_width"])
            row["replay"] = replay
            row["ok"] = row["equal"] or (replay["ok"] and replay["departs_at_step"] is not None)
        else:
            if not row["equal"]:
                entries = [e for e in by_payload.get(rid, []) if e[0].seed is not None]
                row["near_tie"] = _trajectory_near_tie(one, entries)
            row["ok"] = row["equal"] or row.get("near_tie") is not None
        rows.append(row)
    session = next((r["replay"] for r in rows if "replay" in r), None)
    mesh = windows[name]["mesh"] or {}
    checks = {
        "c_served_every_request": all(w["statuses"] == [200] * len(payloads)
                                      for w in windows.values()),
        "c_statements_equal_tp1_or_explained": bool(rows) and all(r["ok"] for r in rows),
        "c_healthz_engine_mesh_reports_tp": mesh.get("tp") == plan.tp and mesh.get("dp") == plan.dp,
    }
    if any(p["method"] == "beam_search" for p in payloads):
        checks["c_session_step_by_step_within_atol_of_tp1"] = (
            session is not None and session["session"] == "TorchTokenSearchSession"
            and session["ok"])
    if on_card:
        by_device = windows[name]["launches_by_device"]
        for k in KERNELS:
            if windows["tp1"]["launches"][k]:
                checks[f"c_{k}_launched_on_every_card"] = all(
                    by_device[k].get(d, 0) > 0 for d in _plan_devices(plan))
    launches = {k: sum(w["launches"][k] for w in windows.values()) for k in KERNELS}
    return {"windows": windows, "statements": rows, "session": session}, checks, launches


def _tp_step_timing(plan, one, wide, on_card, row_counts=TP_TIMING_ROWS):
    """Recorded, not judged: one decode step (``forward_trunk_tail`` over a
    shared TP_TIMING_TRUNK-token trunk, through K2 when the config asks,
    then the head) at tp=1 and over the plan, at each of TP_TIMING_ROWS
    rows: wall ms a step (TP_TIMING_STEPS steps, no profiler), then over
    TP_PROFILED_STEPS more under ``torch.profiler`` (device activity only)
    device-busy ms a step and the share of busy in memory copies (the
    reductions' peer copies; none where a card repeats)."""
    import torch
    from consensus_tpu_torch.cli.profile_search import _kernel_intervals, _union
    from consensus_tpu_torch.models import generate as gen
    from consensus_tpu_torch.models.transformer import (
        forward_trunk_tail, params_dtype, project_logits)
    from consensus_tpu_torch.parallel.tensor import kv_zeros

    cfg = one.config
    cards = _plan_devices(plan)

    def sync():
        if on_card:
            for d in cards:
                torch.cuda.synchronize(d)

    out = []
    for rows in row_counts:
        entry = {"rows": rows, "trunk": TP_TIMING_TRUNK}
        for label, backend in (("tp1", one), (_plan_name(plan), wide)):
            params, device = backend.params, backend.device
            g = torch.Generator(device=device).manual_seed(80 + rows)
            prompt = torch.randint(1, cfg.vocab_size, (1, TP_TIMING_TRUNK), generator=g,
                                   device=device).to(torch.int32)
            tokens = torch.randint(1, cfg.vocab_size, (rows,), generator=g,
                                   device=device).to(torch.int32)
            width = 2 + TP_TIMING_STEPS + TP_PROFILED_STEPS
            with torch.inference_mode():
                _, trunk, last = gen._prefill_shared(
                    params, cfg, prompt, torch.ones_like(prompt, dtype=torch.bool))
                shape = (cfg.n_layers, rows, width, cfg.n_kv_heads, cfg.head_dim)
                tail_k = kv_zeros(params, shape, params_dtype(params), device)
                tail_v = kv_zeros(params, shape, params_dtype(params), device)
                cols = torch.arange(width, dtype=torch.int32, device=device)
                tail_pos = (last + 1 + cols)[None].expand(rows, width).contiguous()
                col = [0]

                def step():
                    pos = (last + 1 + col[0]).to(torch.int32).expand(rows)
                    hidden, _, _ = forward_trunk_tail(
                        params, cfg, tokens, pos, trunk, tail_k, tail_v, tail_pos, col[0],
                        rows, 1)
                    project_logits(params, cfg, hidden)
                    col[0] += 1

                for _ in range(2):
                    step()
                sync()
                t0 = time.perf_counter()
                for _ in range(TP_TIMING_STEPS):
                    step()
                sync()
                wall_ms = (time.perf_counter() - t0) * 1e3 / TP_TIMING_STEPS
                kernels = []
                if on_card:
                    with torch.profiler.profile(
                            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                        for _ in range(TP_PROFILED_STEPS):
                            step()
                        sync()
                    kernels = _kernel_intervals(prof)
            busy = _union([(lo, hi) for _, lo, hi in kernels]) / 1e3 / TP_PROFILED_STEPS
            copies = sum(hi - lo for name, lo, hi in kernels
                         if name.startswith("Memcpy")) / 1e3 / TP_PROFILED_STEPS
            entry[label] = {
                "wall_ms": wall_ms,
                "device_busy_ms": busy if kernels else None,
                "copy_ms": copies if kernels else None,
                "copy_share_of_busy": copies / busy if kernels and busy else None,
            }
            del trunk, tail_k, tail_v
        entry["tp_over_tp1_wall"] = entry[_plan_name(plan)]["wall_ms"] / entry["tp1"]["wall_ms"]
        out.append(entry)
    return out


def tensor_parallel_path(params=None):
    """Tensor parallelism -> (row, launches): (a) K1 and K2 at each tp
    rank's heads on every card against their plain versions, and launched
    with the lead current; (b) main_path's best-of-N config (llama3-8b,
    int8, full width and depth, generation through K2) cut to 8 tokens on
    ``TorchBackend(mesh=plan)`` against tp=1; (c) serve_path's cut requests
    through ``create_server(mesh=plan)`` against tp=1, and a search session
    step by step; (d) ``train_step`` on gemma2-2b at full width over the
    plan against tp=1's gradients; then one decode step's timing at tp
    against tp=1.  ``params``: serve_path's llama3-8b weights (built from
    the seed when None)."""
    import torch
    import yaml
    from consensus_tpu_torch.backends.torch_backend import TorchBackend

    on_card = TP_DEVICE == "cuda"
    plan, more = _tp_plans()
    t0 = time.perf_counter()
    phase_s = {}
    kernels = tp_kernel_cases(plan) if on_card else []
    phase_s["a"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    experiment_info, experiment_checks, experiment_launches, by_device, weight_bytes = (
        _parallel_experiment([plan] + more, params, on_card, decode_kernel=True))
    phase_s["b"] = time.perf_counter() - t1
    tp1_total = sum(weight_bytes["dp1"].values())
    shares = {name: {d: n / tp1_total for d, n in table.items()}
              for name, table in weight_bytes.items() if name != "dp1"}
    t1 = time.perf_counter()
    config = yaml.safe_load((ROOT / SERVE_CONFIG).read_text())
    options = {k: v for k, v in config["backend_options"].items() if k not in ("tp", "dp")}
    options["pin_generation_budget"] = True
    one = TorchBackend(**options, params=params, device=TP_DEVICE)
    wide = TorchBackend(**options, params=one.params, mesh=plan)
    serve_info, serve_checks, serve_launches = _tp_serve(plan, one, wide, config["scenario"],
                                                         on_card)
    phase_s["c"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    timing = _tp_step_timing(plan, one, wide, on_card)
    phase_s["timing"] = time.perf_counter() - t1
    del one, wide
    if on_card:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    train_info, train_checks = _parallel_train(plan, on_card, prefix="d")
    phase_s["d"] = time.perf_counter() - t1
    checks = {"a_kernels_within_tolerance_on_every_card": all(r["ok"] for r in kernels),
              **experiment_checks, **serve_checks, **train_checks}
    if on_card and plan.distinct_devices == plan.n_devices:
        # Four cards: every card of a plan's first row holds one rank.
        tps = {_plan_name(p): p.tp for p in [plan] + more}
        checks["b_weight_bytes_per_card_within_5pct_of_one_over_tp"] = all(
            abs(share * tps[name] - 1.0) <= TP_WEIGHT_SHARE_RTOL
            for name, table in shares.items() for share in table.values())
    if not on_card:
        del checks["a_kernels_within_tolerance_on_every_card"]
    launches = {k: experiment_launches[k] + serve_launches[k] for k in KERNELS}
    for k in KERNELS:
        for d, n in serve_info["windows"][_plan_name(plan)]["launches_by_device"][k].items():
            by_device[k][d] = by_device[k].get(d, 0) + n
    row = {
        "phase": "tensor_parallel_path",
        "plans": [[[str(d) for d in r] for r in p.devices] for p in [plan] + more],
        "dp": plan.dp, "tp": plan.tp, "distinct_devices": plan.distinct_devices,
        "kernels": kernels, "experiment": experiment_info,
        "weight_bytes_per_card": weight_bytes, "weight_share_of_tp1_per_card": shares,
        "serve": serve_info, "step_timing": timing, "train": train_info,
        "launches": launches, "launches_by_device": by_device,
        "phase_s": phase_s, "wall_s": time.perf_counter() - t0,
        "checks": checks, "ok": all(checks.values()),
    }
    return row, launches


#: tensor_parallel_replicated_kv: gemma2-2b (8 q / 4 kv heads) at tp=8, so
#: every rank holds one query head and a copy of the kv head it reads.  The
#: plan is cuda:0 eight times on one card, cuda:0-3 twice each on four;
#: TPR_DEVICE "cpu" rehearses it on CPU ranks, cut by TPR_OVERRIDES (for
#: example ``{"n_layers": 2, "vocab_size": 2048}``).
TPR_DEVICE = "cuda"
TPR_OVERRIDES = {}
TPR_TP = 8
TPR_SEED = CHECKPOINT_SEED
#: (d): the KV cache whose bytes each card holds.
TPR_KV_ROWS = 8
TPR_KV_COLUMNS = 256
#: (b)'s generations run to TPR_TOKENS pinned tokens (PARALLEL_TOKENS, as
#: _parallel_experiment cuts them); (c) posts serve_path's first cut
#: best-of-N request (the engine's paged streams) and its cut beam search
#: (a fused session, replayed step by step); the decode step is timed at
#: TPR_TIMING_ROWS rows.
TPR_TOKENS = PARALLEL_TOKENS
TPR_SERVE_REQUESTS = ("serve-0-best_of_n", "serve-2-beam_search")
TPR_TIMING_ROWS = (8,)
#: The phase's own time budget on one card, reported beside its wall.
TPR_BUDGET_S = 120.0

#: tensor_parallel_split_heads: gemma2-2b at tp=16, so rank t owns half of
#: query head t // 2's columns, holds a copy of that head and of its kv
#: head, and keeps its own half of the head's output.  The plan is cuda:0
#: sixteen times on one card, cuda:0-3 four times each on four; TPS_DEVICE
#: "cpu" rehearses it on CPU ranks, cut by TPS_OVERRIDES.  Its other
#: settings are tensor_parallel_replicated_kv's.
TPS_DEVICE = "cuda"
TPS_OVERRIDES = {}
TPS_TP = 16
TPS_BUDGET_S = 150.0


def _tpr_plan(device=None, tp=None):
    from consensus_tpu_torch.parallel.mesh import make_mesh

    device, tp = device or TPR_DEVICE, tp or TPR_TP
    if device == "cpu":
        return make_mesh(["cpu"] * tp, tp=tp)
    import torch

    cards = 4 if torch.cuda.device_count() >= 4 else 1
    return make_mesh([f"cuda:{i * cards // tp}" for i in range(tp)], tp=tp)


def _tpr_kernel_cases(plan, config):
    """(a): K1 (scoring, B=8, S=384 ragged) and K2 (classic generation rows,
    P=1, R=8, W0=128, Ts=32, write column 31) at one rank's heads of the
    plan (gemma2-2b at tp=8 or 16: 1 q / 1 kv, hd 256, softcap 50) on
    every card of the plan."""
    import numpy as np
    import torch
    from consensus_tpu_torch.parallel.tensor import local_config

    local = local_config(config, plan.tp)
    heads = [local.n_heads, local.n_kv_heads, config.head_dim]
    label = f"{heads[0]} q / {heads[1]} kv heads"
    rng = np.random.default_rng(14)
    rows = []
    for device in _plan_devices(plan):
        index = torch.device(device).index
        tag = f"tp={plan.tp} rank on {device}"
        kw = dict(scale=config.q_scale, softcap=config.attn_softcap, window=config.sliding_window)
        with torch.cuda.device(index):
            cases = [
                flash_case(f"gemma2-2b scoring, {label}, {tag}", 8, 384, *heads,
                           ragged(rng, 8, 384, 96), [0] * 8, seed=140 + index, **kw),
                decode_case(f"gemma2-2b generation, {label}, {tag}", 1, 8, *heads,
                            128, 32, [64, 40, 72, 52, 90, 90, 90, 90], 31, seed=144 + index,
                            **kw),
            ]
        rows.append({"device": device, "heads": heads,
                     "flash_attention": cases[:1], "decode_attention": cases[1:],
                     "ok": all(c["ok"] for c in cases)})
    return rows


def _tpr_kv_bytes(plan, config, wide, on_card=True):
    """(d): each card's bytes of one TPR_KV_ROWS x TPR_KV_COLUMNS cache at
    tp against KV_local x the ranks on the card x the per-head bytes, and
    the most loaded card's against what the backend counts per column."""
    import torch
    from consensus_tpu_torch.models.transformer import make_cache
    from consensus_tpu_torch.parallel.tensor import local_config

    cache = make_cache(config, TPR_KV_ROWS, TPR_KV_COLUMNS, torch.bfloat16, wide.device,
                       params=wide.params)
    per_card = {}
    for block in (cache.k, cache.v):
        for part in block.parts:
            key = str(part.device)
            per_card[key] = per_card.get(key, 0) + part.numel() * part.element_size()
    per_head = 2 * config.n_layers * TPR_KV_ROWS * TPR_KV_COLUMNS * config.head_dim * 2
    kv_local = local_config(config, plan.tp).n_kv_heads
    ranks = {d: sum(str(x) == d for x in plan.devices[0]) for d in _plan_devices(plan)}
    expected = {d: kv_local * n * per_head for d, n in ranks.items()}
    counted = wide._kv_bytes_per_column() * TPR_KV_ROWS * TPR_KV_COLUMNS
    if not on_card:
        expected = {"cpu": sum(expected.values())}
        counted *= plan.tp  # CPU ranks stand for separate devices
    del cache
    info = {"rows": TPR_KV_ROWS, "columns": TPR_KV_COLUMNS, "kv_heads_local": kv_local,
            "ranks_per_card": ranks, "bytes_per_card": per_card, "expected": expected,
            "backend_counts_per_card": counted,
            "kv_heads_per_card": wide._kv_heads_per_card,
            "whole_model_bytes": per_head * config.n_kv_heads,
            "divide_by_tp_figure": per_head * config.n_kv_heads // plan.tp,
            "replication": plan.tp * kv_local // config.n_kv_heads}
    checks = {
        "d_kv_bytes_per_card_eq_local_heads_x_ranks": per_card == expected,
        "d_kv_bytes_eq_backend_accounting": max(per_card.values()) == counted,
    }
    return info, checks


def _head_holders(config, tp):
    """Per head projection (``wq``, ``wk``, ``wv``), the groups of ranks
    that hold the same heads of it: copies that must stay bit-equal."""
    from consensus_tpu_torch.parallel.tensor import kv_heads_of_rank, q_heads_of_rank

    holders = {}
    for key, heads_of in (("wq", q_heads_of_rank), ("wk", kv_heads_of_rank),
                          ("wv", kv_heads_of_rank)):
        groups = {}
        for t in range(tp):
            groups.setdefault(heads_of(config, tp, t), []).append(t)
        holders[key] = [g for g in groups.values() if len(g) > 1]
    return holders


def _tpr_train(plan, config, on_card):
    """(e): ``train_step`` on gemma2-2b over the plan: the first step's
    gradients on float32 copies of the seeded bf16 weights against one
    device's (relative L2, TRAIN_GRAD_RTOL), then one AdamW step of the bf16
    master at tp, after which the ranks that share a head hold bit-equal
    copies of its ``wq`` (split query heads) and ``wk``/``wv`` columns."""
    import torch
    from consensus_tpu_torch.models.transformer import init_params
    from consensus_tpu_torch.parallel.mesh import shard_params
    from consensus_tpu_torch.parallel.train import init_train_state, shard_grads, train_step

    device = plan.data_devices[0]
    generator = torch.Generator(device=device)
    generator.manual_seed(TRAIN_SEED)
    params = init_params(config, generator, device, torch.bfloat16)
    tokens = torch.randint(0, config.vocab_size, (TRAIN_ROWS, TRAIN_SEQ), generator=generator,
                           device=device, dtype=torch.int64).to(torch.int32)
    valid = torch.ones((TRAIN_ROWS, TRAIN_SEQ), dtype=torch.bool, device=device)
    valid[-1, TRAIN_SEQ * 3 // 4:] = False
    t0 = time.perf_counter()
    wide = _float32_copy(params)
    loss_n, grads_n = shard_grads(wide, config, tokens, valid, plan)
    loss_1, grads_1 = shard_grads(wide, config, tokens, valid, None)
    grad_err = _grad_rel_err(grads_n, grads_1)
    loss_diff = abs(float(loss_n) - float(loss_1))
    del wide, grads_n, grads_1
    grads_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
    params, opt_state, optimizer = init_train_state(params, learning_rate=TRAIN_LR)
    t0 = time.perf_counter()
    params, opt_state, loss = train_step(params, opt_state, config, optimizer, tokens, valid,
                                         plan=plan)
    if on_card:
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    with torch.no_grad():
        ranks = shard_params(params, plan, config)[0]
    holders = _head_holders(config, plan.tp)

    def copies_equal(keys):
        return all(
            torch.equal(ranks[group[0]]["layers"][i][key], ranks[t]["layers"][i][key])
            for key in keys for group in holders[key] for t in group[1:]
            for i in range(config.n_layers))

    kv_equal, q_equal = copies_equal(("wk", "wv")), copies_equal(("wq",))
    del params, optimizer, opt_state, ranks
    if on_card:
        torch.cuda.empty_cache()
    info = {"rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "grads_compared_in": "float32",
            "grad_rel_l2_err": grad_err, "grad_tolerance": TRAIN_GRAD_RTOL,
            "first_loss_tp_vs_tp1_diff": loss_diff, "step_loss": float(loss),
            "grads_s": grads_s, "step_s": step_s,
            "ranks_sharing_a_head": holders["wk"],
            "ranks_sharing_a_query_head": holders["wq"]}
    checks = {
        "e_tp_grads_match_tp1": grad_err <= TRAIN_GRAD_RTOL,
        "e_step_loss_finite": loss == loss and abs(float(loss)) < float("inf"),
        "e_shared_head_copies_bit_equal_after_adamw": bool(holders["wk"]) and kv_equal,
    }
    if config.n_heads % plan.tp:
        checks["e_shared_query_head_copies_bit_equal_after_adamw"] = (
            bool(holders["wq"]) and q_equal)
    return info, checks


def tensor_parallel_replicated_kv():
    """Tensor parallelism past the kv heads -> (row, launches): gemma2-2b at
    full width and its real vocab (26 layers, int8 weights, bf16) at tp=8,
    where each rank holds one query head and a copy of the kv head it reads
    (:func:`_tp_head_copies`)."""
    return _tp_head_copies("tensor_parallel_replicated_kv", TPR_DEVICE, TPR_OVERRIDES, TPR_TP,
                           TPR_BUDGET_S)


def tensor_parallel_split_heads():
    """Tensor parallelism that cuts a query head -> (row, launches):
    gemma2-2b at full width and its real vocab at tp=16, where each rank
    owns half of one query head's columns, holds a copy of that head and
    of its kv head, and keeps its own half of the head's output
    (:func:`_tp_head_copies`)."""
    return _tp_head_copies("tensor_parallel_split_heads", TPS_DEVICE, TPS_OVERRIDES, TPS_TP,
                           TPS_BUDGET_S)


def _tp_head_copies(phase, device, overrides, tp, budget_s):
    """One tensor-parallel phase whose ranks hold copies of shared heads
    -> (row, launches).  The seeded weights are written in the port's
    checkpoint format and restored straight into the tp ranks (and whole
    for tp=1).  (a) K1 and K2 at one rank's heads on every card of the
    plan; (b) TPR_TOKENS-token seeded generations through K2 and scored
    cells through K1 at tp against tp=1, with every count zeroed just
    before (b) and read after (c); (c) a cut best-of-N and a cut
    beam-search request through ``create_server(mesh=plan)`` against tp=1;
    (d) each card's KV bytes; then one decode step's timing at tp against
    tp=1 (``_tp_step_timing``, recorded, not judged); (e) the tp train
    step."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import yaml
    from consensus_tpu_torch.backends.base import GenerationRequest, ScoreRequest
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.evaluation import EVAL_SYSTEM_TEMPLATE
    from consensus_tpu_torch.models.config import get_model_config
    from consensus_tpu_torch.models.transformer import init_params
    from consensus_tpu_torch.ops import decode_attention as da
    from consensus_tpu_torch.ops import flash_attention as fa
    from consensus_tpu_torch.parallel.mesh import unshard_params
    from consensus_tpu_torch.parallel.tensor import (
        TPParams,
        kv_heads_of_rank,
        q_columns_of_rank,
        q_heads_of_rank,
    )
    from consensus_tpu_torch.utils.checkpoint import FORMAT, save_params

    on_card = device == "cuda"
    plan = _tpr_plan(device, tp)
    lead = plan.data_devices[0]
    config = get_model_config(CHECKPOINT_MODEL, **overrides)
    t0 = time.perf_counter()
    phase_s = {}
    kernels = _tpr_kernel_cases(plan, config) if on_card else []
    phase_s["a"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    root = pathlib.Path(tempfile.mkdtemp(prefix=f"{phase}_", dir=OUT_DIR))
    try:
        generator = torch.Generator(device=lead)
        generator.manual_seed(TPR_SEED)
        source = init_params(config, generator, lead, torch.bfloat16, int8=True)
        written = save_params(str(root / "params"), source)
        (root / "ingest.json").write_text(json.dumps({
            "format": FORMAT, "model": config.name, "quantization": "int8",
            "dtype": "bfloat16", "source": f"init_params seed {TPR_SEED}"}))
        del source
        phase_s["write"] = time.perf_counter() - t1
        options = dict(model=CHECKPOINT_MODEL, config=config, checkpoint=str(root),
                       quantization="int8", dtype="bfloat16", use_flash_attention=True,
                       use_decode_attention=True, pin_generation_budget=True)
        t1 = time.perf_counter()
        one = TorchBackend(**options, device=lead)
        phase_s["restore_tp1"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        wide = TorchBackend(**options, mesh=plan)
        phase_s[f"restore_tp{plan.tp}"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    hd = config.head_dim

    def holds(heads_of, keys):
        """Every rank holds its heads' columns of ``keys``, as in the file."""
        return all(
            torch.equal(tree["layers"][i][key].q[:, k * hd:(k + 1) * hd],
                        one.params["layers"][i][key].q[:, h * hd:(h + 1) * hd].to(
                            tree["embed"].q.device))
            for t, tree in enumerate(wide.params.ranks)
            for k, h in enumerate(heads_of(config, plan.tp, t))
            for i in range(config.n_layers) for key in keys)

    restored_kv = isinstance(wide.params, TPParams) and wide.params.kv_heads == 1 and holds(
        kv_heads_of_rank, ("wk", "wv"))
    restored_q = isinstance(wide.params, TPParams) and holds(q_heads_of_rank, ("wq",))
    gathered_equal = _params_equal(unshard_params(wide.params.ranks, config, lead), one.params)

    generate = [GenerationRequest(user_prompt=p, max_tokens=TPR_TOKENS, temperature=1.0,
                                  seed=100 + i) for i, p in enumerate(CHECKPOINT_PROMPTS)]
    score = [ScoreRequest(context=EVAL_SYSTEM_TEMPLATE.format(issue=CHECKPOINT_PROMPTS[0],
                                                              opinion=opinion),
                          continuation=statement, role="user")
             for statement in CHECKPOINT_STATEMENTS for opinion in CHECKPOINT_AGENTS.values()]
    tb = time.perf_counter()
    runs = {}
    b_launches = {k: 0 for k in KERNELS}
    b_by_device = {k: {} for k in KERNELS}
    decode_shapes = []
    for name, backend in (("tp1", one), (f"tp{plan.tp}", wide)):
        fa.launches.reset()
        da.launches.reset()
        t1 = time.perf_counter()
        generated = backend.generate(generate)
        if on_card:
            torch.cuda.synchronize()
        generate_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        scored = backend.score(score)
        if on_card:
            torch.cuda.synchronize()
        counters = (("flash_attention", fa.launches), ("decode_attention", da.launches))
        runs[name] = {"generate_s": generate_s, "score_s": time.perf_counter() - t1,
                      "generated": {_request_key(r): [(r, tuple(g.token_ids))]
                                    for r, g in zip(generate, generated)},
                      "logprobs": [list(r.logprobs) for r in scored],
                      "launches": {k: c.count for k, c in counters},
                      "launches_by_device": {k: dict(c.by_device) for k, c in counters},
                      "flash_last_shapes": ([list(x) for x in fa.launches.last_shapes]
                                            if fa.launches.count else None)}
        for k, counter in counters:
            b_launches[k] += counter.count
            for d, n in counter.by_device.items():
                b_by_device[k][d] = b_by_device[k].get(d, 0) + n
        decode_shapes += [{"run": name, "q": list(q), "trunk": list(t), "tail": list(l),
                           "launches": count}
                          for (q, t, l), (count, _) in da.launches.shapes.items()]
    name = f"tp{plan.tp}"
    compare = _compare_generations(one, runs[name]["generated"], runs["tp1"]["generated"])
    score_err = max(abs(a - b) for x, y in zip(runs[name]["logprobs"], runs["tp1"]["logprobs"])
                    for a, b in zip(x, y))
    phase_s["b"] = time.perf_counter() - tb

    t1 = time.perf_counter()
    scenario = yaml.safe_load((ROOT / SERVE_CONFIG).read_text())["scenario"]
    payloads = [p for p in _serve_payloads(scenario, cut=True)
                if p["request_id"] in TPR_SERVE_REQUESTS]
    serve_info, serve_checks, serve_launches = _tp_serve(plan, one, wide, scenario, on_card,
                                                         payloads)
    phase_s["c"] = time.perf_counter() - t1
    launches = {k: b_launches[k] + serve_launches[k] for k in KERNELS}
    by_device = {k: dict(b_by_device[k]) for k in KERNELS}
    for k in KERNELS:
        for d, n in serve_info["windows"][_plan_name(plan)]["launches_by_device"][k].items():
            by_device[k][d] = by_device[k].get(d, 0) + n

    kv_info, kv_checks = _tpr_kv_bytes(plan, config, wide, on_card)
    weight_bytes = {"tp1": _weight_bytes_by_device(one.params),
                    name: _weight_bytes_by_device(wide.params)}
    t1 = time.perf_counter()
    timing = _tp_step_timing(plan, one, wide, on_card, TPR_TIMING_ROWS)
    phase_s["timing"] = time.perf_counter() - t1
    del one, wide
    if on_card:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    train_info, train_checks = _tpr_train(plan, config, on_card)
    phase_s["e"] = time.perf_counter() - t1
    wall = time.perf_counter() - t0

    checks = {
        "a_kernels_within_tolerance_on_every_card": all(r["ok"] for r in kernels),
        "real_vocab_and_width": (config.vocab_size == 256128 and config.d_model == 2304
                                 and (config.n_heads, config.n_kv_heads, hd) == (8, 4, 256)),
        "restored_ranks_hold_their_kv_head_columns": restored_kv,
        "gathered_ranks_eq_whole_tree": gathered_equal,
        "b_ids_equal_or_diverge_below_margin": (
            compare["only_one_mode"] == 0 and all(d["ok"] for d in compare["diverged"])),
        "b_scores_within_atol": score_err <= ROUTE_ATOL,
        "b_logprobs_finite": all(np.isfinite(lp).all() and len(lp) > 0
                                 for run in runs.values() for lp in run["logprobs"]),
        **serve_checks, **kv_checks, **train_checks,
    }
    if config.n_heads % plan.tp:
        checks["restored_ranks_hold_their_query_head_columns"] = restored_q
    if on_card:
        for k in KERNELS:
            # Every rank launches each kernel where tp=1 launches it once.
            checks[f"b_{k}_launched_by_every_rank_on_every_card"] = (
                runs["tp1"]["launches"][k] > 0
                and runs[name]["launches"][k] == plan.tp * runs["tp1"]["launches"][k]
                and all(runs[name]["launches_by_device"][k].get(d, 0) > 0
                        for d in _plan_devices(plan)))
    else:
        del checks["a_kernels_within_tolerance_on_every_card"]
    columns = [q_columns_of_rank(config, plan.tp, t) for t in range(plan.tp)]
    row = {
        "phase": phase, "model": CHECKPOINT_MODEL,
        "n_layers": config.n_layers, "d_model": config.d_model, "vocab": config.vocab_size,
        "heads": [config.n_heads, config.n_kv_heads, hd], "tp": plan.tp,
        "plan": [[str(d) for d in r] for r in plan.devices],
        "q_heads_of_rank": [q_heads_of_rank(config, plan.tp, t) for t in range(plan.tp)],
        "q_columns_of_rank": [None if c is None else [c.start, c.stop] for c in columns],
        "kv_heads_of_rank": [kv_heads_of_rank(config, plan.tp, t) for t in range(plan.tp)],
        "checkpoint_bytes": written, "weight_bytes_by_device": weight_bytes, "kernels": kernels,
        "runs": {k: {key: v[key] for key in ("generate_s", "score_s", "launches",
                                             "launches_by_device", "flash_last_shapes")}
                 for k, v in runs.items()},
        "generation_compare": compare, "max_score_logprob_diff": score_err,
        "decode_shapes": decode_shapes, "serve": serve_info, "kv_bytes": kv_info,
        "step_timing": timing, "train": train_info, "launches": launches, "launches_by_device": by_device,
        "phase_s": phase_s, "wall_s": wall, "budget_s": budget_s,
        "checks": checks, "ok": all(checks.values()),
    }
    return row, launches


def late_phases_alone(names) -> int:
    """``python3 chip_smoke.py sweep_path mcts_path concurrent_path
    serve_path fleet_path checkpoint_path parallel_path
    tensor_parallel_path tensor_parallel_replicated_kv
    tensor_parallel_split_heads`` (any of them):
    those phases alone, for iterating
    on them; concurrent_path runs on mcts_path's backend, and the others
    build their own weights.  Prints their lines, no summary and no ``ok``
    line; exits 1 if a phase failed."""
    unknown = set(names) - {"sweep_path", "mcts_path", "concurrent_path", "serve_path",
                            "fleet_path", "checkpoint_path", "parallel_path",
                            "tensor_parallel_path", "tensor_parallel_replicated_kv",
                            "tensor_parallel_split_heads"}
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")
    rows = []
    if "sweep_path" in names:
        rows.append(sweep_path()[0])
    if {"mcts_path", "concurrent_path"} & set(names):
        mcts = mcts_path()
        rows.append(mcts[0])
        if "concurrent_path" in names:
            rows.append(concurrent_path(mcts[4])[0])
    if {"serve_path", "fleet_path", "parallel_path", "tensor_parallel_path",
            "tensor_parallel_replicated_kv", "tensor_parallel_split_heads"} & set(names):
        from consensus_tpu_torch.ops import build

        # Built here, once: the server subprocesses and this process load it.
        for name in KERNELS:
            build.build(name)
    if "serve_path" in names:
        rows.append(serve_path()[0])
    if "fleet_path" in names:
        rows.append(fleet_path()[0])
    if "checkpoint_path" in names:
        rows.append(checkpoint_path()[0])
    if "parallel_path" in names:
        # The kernels on every card beyond the first, as the kernels phase
        # runs them, then the phase.
        per_card = parallel_kernel_cases()
        rows.append({"phase": "kernels", "per_card": per_card,
                     "ok": all(c["ok"] for c in per_card)})
        rows.append(parallel_path()[0])
    if "tensor_parallel_path" in names:
        rows.append(tensor_parallel_path()[0])
    if "tensor_parallel_replicated_kv" in names:
        rows.append(tensor_parallel_replicated_kv()[0])
    if "tensor_parallel_split_heads" in names:
        rows.append(tensor_parallel_split_heads()[0])
    for row in rows:
        emit(row)
    return 0 if all(row["ok"] for row in rows) else 1


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
    if len(sys.argv) > 1:
        return late_phases_alone(sys.argv[1:])

    def timed_build(name):
        started = time.perf_counter()
        log = build.build(name)
        return log, time.perf_counter() - started

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + len(MUTANTS)) as pool:
        builds = {name: pool.submit(timed_build, name) for name in KERNELS}
        mutant_builds = {
            tag: pool.submit(build_mutant, tag, *spec[:3]) for tag, spec in MUTANTS.items()
        }
        logs = {name: job.result() for name, job in builds.items()}
        mutant_libs = {tag: job.result() for tag, job in mutant_builds.items()}
    ptxas = {name: ptxas_report(log) for name, (log, _) in logs.items()}
    build_row = {
        "phase": "build", "kernels": list(KERNELS), "mutants": list(MUTANTS),
        "seconds": time.perf_counter() - t0,
        "seconds_by_kernel": {name: s for name, (_, s) in logs.items()}, "ptxas": ptxas,
        "hd128_spill_free": all(
            any("ILi128E" in f["function"] for f in functions)
            and all(f.get("spill_bytes") == 0 for f in functions if "ILi128E" in f["function"])
            for functions in ptxas.values()
        ),
        # Every instantiation of K1's kernel (hd 128 / 256 x 1 / 2 consumer
        # warpgroups): registers at entry (setmaxnreg moves them later) and
        # no spills.
        "flash_attention_spill_free": len(ptxas["flash_attention"]) == 4 and all(
            f.get("spill_bytes") == 0 for f in ptxas["flash_attention"]
        ),
        # Every instantiation of K2's kernel (hd 128 / 256 x 1, 2 or 4 row
        # tiles): no spills.
        "decode_attention_spill_free": len(ptxas["decode_attention"]) == 6 and all(
            f.get("spill_bytes") == 0 for f in ptxas["decode_attention"]
        ),
    }
    emit(build_row)

    flash_cases = kernel_cases()
    decode_cases_ = decode_cases()
    mutants = [
        mutant_check(tag, *mutant_libs[tag]) for tag in ("flash_skip_tile", "flash_no_mask")
    ] + [decode_mutant_check(tag, *mutant_libs[tag])
         for tag in ("decode_neighbour_tail", "decode_drop_last_split")]
    per_card = parallel_kernel_cases()
    kernels_ok = all(c["ok"] for c in flash_cases + decode_cases_ + per_card)
    emit({"phase": "kernels", "flash_attention": flash_cases,
          "decode_attention": decode_cases_, "per_card": per_card, "ok": kernels_ok})
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
    fallback_row, fallback_launches, fallback_shapes, next_token_case, params = (
        fallback_session_path()
    )
    emit(fallback_row)
    if next_token_case is None:
        fail("the fallback session path launched no flash-attention kernel in next_token_topk")
    sweep_row, sweep_launches, sweep_shapes = sweep_path(params)
    emit(sweep_row)
    mcts_row, mcts_launches, mcts_shapes, mcts_case, backend = mcts_path()
    emit(mcts_row)
    if mcts_case is None:
        fail("the MCTS path launched no flash-attention kernel under gemma2-2b")
    concurrent_row, concurrent_launches, concurrent_shapes = concurrent_path(backend)
    del backend
    torch.cuda.empty_cache()
    emit(concurrent_row)
    serve_row, serve_launches, serve_shapes = serve_path(params)
    emit(serve_row)
    fleet_row, fleet_launches, fleet_shapes = fleet_path(params)
    emit(fleet_row)
    parallel_row, parallel_launches = parallel_path(params)
    emit(parallel_row)
    tp_row, tp_launches = tensor_parallel_path(params)
    del params
    torch.cuda.empty_cache()
    emit(tp_row)
    tpr_row, tpr_launches = tensor_parallel_replicated_kv()
    torch.cuda.empty_cache()
    emit(tpr_row)
    tps_row, tps_launches = tensor_parallel_split_heads()
    torch.cuda.empty_cache()
    emit(tps_row)
    checkpoint_row, checkpoint_launches, checkpoint_shapes, checkpoint_case = checkpoint_path()
    emit(checkpoint_row)
    if checkpoint_case is None:
        fail("the checkpoint path launched no flash-attention kernel")

    paths = {
        "main_path": launches, "token_search_path": search_launches,
        "reference_defaults_path": reference_row["launches"],
        "shared_trunk_decode_path": generate_launches, "habermas_eval_path": habermas_launches,
        "fallback_session_path": fallback_launches, "sweep_path": sweep_launches,
        "mcts_path": mcts_launches, "concurrent_path": concurrent_launches,
        "serve_path": serve_launches, "fleet_path": fleet_launches,
        "checkpoint_path": checkpoint_launches, "parallel_path": parallel_launches,
        "tensor_parallel_path": tp_launches,
        "tensor_parallel_replicated_kv": tpr_launches,
        "tensor_parallel_split_heads": tps_launches,
    }
    flash_entry, flash_ok = summary_flash(
        {"flash_attention": sum(p["flash_attention"] for p in paths.values())},
        main_shapes, main_spans,
        max([c["max_abs_err"] for c in flash_cases]
            + [gemma_case["max_abs_err"], next_token_case["max_abs_err"],
               mcts_case["max_abs_err"], checkpoint_case["max_abs_err"]]),
    )
    flash_entry["by_path"] = {name: p["flash_attention"] for name, p in paths.items()}
    case_keys = ("shape", "softcap", "window", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_by", "max_abs_err")
    flash_entry["gemma2_9b_evaluation"] = {key: gemma_case[key] for key in case_keys}
    flash_entry["next_token_topk"] = {key: next_token_case[key] for key in case_keys}
    flash_entry["gemma2_2b_evaluation"] = {key: mcts_case[key] for key in case_keys}
    flash_entry["gemma2_2b_checkpoint"] = {key: checkpoint_case[key] for key in case_keys}
    decode_shapes = dict(search_shapes)
    for more in (generate_shapes, fallback_shapes, sweep_shapes, mcts_shapes, concurrent_shapes,
                 serve_shapes, fleet_shapes, checkpoint_shapes):
        for key, (count, args) in more.items():
            decode_shapes[key] = (decode_shapes.get(key, (0, None))[0] + count, args)
    decode_entry, decode_ok = summary_decode(
        {"decode_attention": sum(p["decode_attention"] for p in paths.values())},
        decode_shapes,
        max(c["max_abs_err"] for c in decode_cases_),
    )
    decode_entry["by_path"] = {name: p["decode_attention"] for name, p in paths.items()}
    emit({"kernels": [flash_entry, decode_entry]})
    print(smi, flush=True)
    phases = [main_row, search_row, reference_row, route_row, generate_row, threefry_row,
              greedy_row, habermas_row, fallback_row, sweep_row, mcts_row, concurrent_row,
              serve_row, fleet_row, checkpoint_row, parallel_row, tp_row, tpr_row, tps_row]
    if not (kernels_ok and all(m["ok"] for m in mutants) and all(p["ok"] for p in phases)
            and flash_ok and decode_ok and build_row["flash_attention_spill_free"]
            and build_row["decode_attention_spill_free"]):
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

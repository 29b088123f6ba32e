"""Time a hand-written attention kernel beside variants of itself and beside
another checkout's build of it, in one process on one card.

    python -m consensus_tpu_torch.cli.k1_variants [--kernel flash_attention|decode_attention]
        [--parent DIR] [--variants NAME ...]

``--kernel`` picks the flash-attention kernel (K1, the default) or the
decode-attention kernel (K2).  Each variant is this checkout's
``csrc/<kernel>.cu`` (and its headers) with the text replacements of its
entry in ``VARIANTS``, built with nvcc as the kernel itself is
(``ops/build.py``) into ``_build/variants/``, and launched with the entry's
keyword arguments; ``--parent DIR`` adds DIR's
``consensus_tpu_torch/csrc/<kernel>.cu`` as it stands, built against DIR's
own headers (unpack ``consensus_tpu_torch/csrc`` and, for K2, whose C
interface changed, ``consensus_tpu_torch/ops`` of the parent commit there:
the parent's K2 is launched through DIR's own
``ops/decode_attention.py``).  Every build is held against the plain
version (atol 5e-3 + rtol 1e-2, as ``chip_smoke.py``) and timed as calls
captured in a CUDA graph, at each of the kernel's shapes, on the same
inputs.  For K2 each shape also gives the wrapper's host microseconds per
call (``decode_attention`` called 400 times without a sync, against this
build and against the parent's wrapper and build).  Prints the card's name
and power limit, one JSON line per build (its ptxas warnings and spills),
then one per shape: ms and within-tolerance per build, and the bound (bytes
over 3.35 TB/s against FLOPs over 989 TFLOP/s).  Compare builds only within
one run.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from consensus_tpu_torch.ops import build
from consensus_tpu_torch.ops import decode_attention as da
from consensus_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 5e-3, 1e-2
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
HOST_CALLS = 400

#: kernel -> name -> (text replacements over the kernel's source and
#: headers, keyword arguments of its launch).
VARIANTS = {
    "flash_attention": {
        # The two consumer warpgroups issue their products without taking turns.
        "no_pingpong": ([
            ("      if constexpr (CWG == 2) named_barrier_sync(3 + cw, 256);\n", ""),
            ("      if constexpr (CWG == 2) named_barrier_arrive(4 - cw, 256);\n", ""),
            ("    if (CWG == 2 && cw == 1 && round * G < n_tiles) named_barrier_arrive(3, 256);\n",
             ""),
            ("    if (CWG == 2 && cw == 0 && o_turn > 0) named_barrier_sync(3, 256);\n", ""),
        ], {}),
        # One block per tile at every grid size: no persistent blocks.
        "block_per_tile": ([
            ("  const unsigned grid = (unsigned)(tiles < 4LL * sms ? tiles : sms);",
             "  const unsigned grid = (unsigned)tiles;"),
        ], {}),
    },
    "decode_attention": {
        # One block a group: no split, no merge across blocks.
        "no_split": ([], {"max_splits": 1}),
        # Diagnostic (wrong results): the consumers wait for every tile and
        # compute nothing, which leaves the copies' time.
        "diag_no_products": ([("      if (active) {", "      if (false) {")], {}),
        # Per-block %globaltimer stamps at each phase and the block's SM,
        # read back through consensus_decode_attention_trace (see TRACE_PHASES).
        "diag_trace": ([
            ('#include "sm90_wgmma.cuh"\n',
             '#include "sm90_wgmma.cuh"\n'
             "__device__ unsigned long long k2_trace[4096 * 16];\n"
             "#define K2_STAMP(k) do { if (threadIdx.x == 0) { unsigned long long t_; "
             'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
             "const int b_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); "
             "if (b_ < 4096) k2_trace[b_ * 16 + (k)] = t_; } } while (0)\n"),
            ("  const Span sp = span_of<BK>(a);\n",
             "  const Span sp = span_of<BK>(a);\n  K2_STAMP(0);\n  if (threadIdx.x == 0) {"
             " k2_trace[(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * 16 + 10]"
             " = clock64(); }\n  if (threadIdx.x == 0) {"
             " unsigned s_; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s_));"
             " k2_trace[(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * 16 + 15]"
             " = s_; }\n"),
            ("  __syncthreads();\n  mbar_arrive_cp_async(bar_q);\n",
             "  __syncthreads();\n  K2_STAMP(1);\n  mbar_arrive_cp_async(bar_q);\n"),
            ("    mbar_wait(bar_q, 0);\n", "    mbar_wait(bar_q, 0);\n    K2_STAMP(2);\n"),
            ("      mbar_wait(FULL_K(stage), parity);\n",
             "      mbar_wait(FULL_K(stage), parity);\n      if (it == 0) K2_STAMP(3);\n"),
            ("    // Every consumer is done with the ring", "    K2_STAMP(4);\n"
             "    // Every consumer is done with the ring"),
            ("    named_barrier_sync(1, CTHREADS);\n    // The block's partial of each row over",
             "    named_barrier_sync(1, CTHREADS);\n    K2_STAMP(5);\n"
             "    // The block's partial of each row over"),
            ("  // Every block's sends are in; each block merges its slice locally.\n  cluster_sync();\n",
             "  K2_STAMP(6);\n  cluster_sync();\n  K2_STAMP(7);\n"),
            ("  __syncthreads();\n  // This block's slice", "  __syncthreads();\n  K2_STAMP(8);\n"
             "  // This block's slice"),
            ("    *reinterpret_cast<uint4*>(dst) = packed;\n  }\n}\n",
             "    *reinterpret_cast<uint4*>(dst) = packed;\n  }\n  K2_STAMP(9);\n"
             "  if (threadIdx.x == 0) {"
             " k2_trace[(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * 16 + 11]"
             " = clock64(); }\n}\n"),
            ('}  // extern "C"', "int consensus_decode_attention_trace(void* dst, int n) {\n"
             "  return (int)cudaMemcpyFromSymbol(dst, k2_trace, (size_t)n * 16 * 8);\n}\n\n"
             '}  // extern "C"'),
        ], {}),
    },
}


def _ragged(seed, batch, seq, low):
    """A quarter of the rows full, the rest uniform in [low, seq]."""
    rng = np.random.default_rng(seed)
    return [seq] * (batch // 4) + [int(x) for x in rng.integers(low, seq + 1, batch - batch // 4)]


#: K1: (name, B, S, H, KV, hd, lengths, starts or None for 0, softcap, window)
FLASH_SHAPES = [
    ("llama3-8b B=32 S=768 ragged", 32, 768, 32, 8, 128, _ragged(0, 32, 768, 192), None, None,
     None),
    ("llama3-8b B=32 S=1024 ragged", 32, 1024, 32, 8, 128, _ragged(1, 32, 1024, 256), None,
     None, None),
    ("llama3-8b B=32 S=1024 full", 32, 1024, 32, 8, 128, [1024] * 32, None, None, None),
    ("llama3-8b B=32 S=1024 all length 0", 32, 1024, 32, 8, 128, [0] * 32, None, None, None),
    ("llama3-8b B=8 S=768 left-padded", 8, 768, 32, 8, 128, _ragged(2, 8, 768, 16), "left",
     None, None),
    ("gemma2-9b B=8 S=512 softcap 50", 8, 512, 16, 8, 256, _ragged(3, 8, 512, 128), None, 50.0,
     4096),
    ("gemma2-2b B=8 S=768 softcap 50", 8, 768, 8, 4, 256, _ragged(4, 8, 768, 192), None, 50.0,
     4096),
    ("gemma2-2b B=8 S=1024 full, no softcap", 8, 1024, 8, 4, 256, [1024] * 8, None, None, None),
    ("tp rank, 1 q / 1 kv head, B=8 S=384 softcap 50", 8, 384, 1, 1, 256,
     _ragged(5, 8, 384, 96), None, 50.0, 4096),
    ("llama3-8b tp=2 rank, 16 q / 4 kv heads, B=8 S=768", 8, 768, 16, 4, 128,
     _ragged(6, 8, 768, 192), None, None, None),
]

#: Trunk starts of the llama3-8b beam cases (chip_smoke.py's DECODE_STARTS).
BEAM_STARTS = [200, 560, 604, 590, 615, 600]

#: K2, the paths' shapes: (name, P, R, H, KV, hd, W0, Ts, starts, write_col,
#: softcap, window)
DECODE_SHAPES = [
    ("gemma2-2b classic decode P=1 R=8 W0=1024 Ts=32", 1, 8, 8, 4, 256, 1024, 32, [0] * 8, 31,
     50.0, 4096),
    *[(f"llama3-8b shared trunk P=8 R=1 W0=1024 Ts=256 write_col {wc}", 8, 1, 32, 8, 128, 1024,
       256, [0], wc, None, None) for wc in (0, 128, 255)],
    ("gemma2-2b MCTS trunk advance P=1 R=5 Ts=8", 1, 5, 8, 4, 256, 1024, 8, BEAM_STARTS[:5], 5,
     50.0, 4096),
    ("gemma2-2b checkpoint classic P=1 R=8 W0=128 Ts=32", 1, 8, 8, 4, 256, 128, 32, [0] * 8, 31,
     50.0, 4096),
    ("tp rank, 1 q / 1 kv head, P=1 R=8 W0=128 Ts=32", 1, 8, 1, 1, 256, 128, 32, [0] * 8, 31,
     50.0, None),
    ("llama3-8b beam P=4 R=6 W0=1024 Ts=200 write_col 100", 4, 6, 32, 8, 128, 1024, 200,
     BEAM_STARTS, 100, None, None),
    ("llama3-8b serving cohort P=1 R=16 Ts=64", 1, 16, 32, 8, 128, 1024, 64,
     [0] * 8 + [300] + [0] * 7, 38, None, None),
    ("llama3-8b 16 slots (64 rows a group) write_col 150", 16, 6, 32, 8, 128, 1024, 200,
     BEAM_STARTS, 150, None, None),
    ("llama3-8b empty trunk spans, write_col 0", 1, 6, 32, 8, 128, 1024, 200, [1024] * 6, 0,
     None, None),
]


def _compile(kernel, name, source_text, headers):
    """Write a variant's source and headers to their own directory (the
    source includes its headers from there first) and build it."""
    out = build.BUILD_DIR / "variants" / kernel / name
    out.mkdir(parents=True, exist_ok=True)
    for header, text in headers.items():
        (out / header).write_text(text)
    (out / f"{kernel}.cu").write_text(source_text)
    log = build.compile_library(out / f"{kernel}.cu", out / "lib.so")
    notes = [line.strip() for line in log.splitlines()
             if "Performance Loss" in line or "spill stores" in line or "Used" in line
             or "Compiling entry" in line]
    return out / "lib.so", notes


def _variant_text(kernel, replacements):
    files = [f"{kernel}.cu"] + sorted(h.name for h in build.CSRC_DIR.glob("*.cuh"))
    texts = {f: (build.CSRC_DIR / f).read_text() for f in files}
    for old, new in replacements:
        hits = [f for f, t in texts.items() if old in t]
        if not hits:
            raise ValueError(f"variant text not found in the kernel's sources: {old!r}")
        for f in hits:
            texts[f] = texts[f].replace(old, new)
    return texts.pop(f"{kernel}.cu"), texts


def _graph_ms(fn, reps=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _within(out, plain):
    excess = (out.float() - plain.float()).abs() - RTOL * plain.float().abs()
    return bool((excess <= ATOL).all()) and bool(torch.isfinite(out).all())


def _bound_ms(batch, seq, heads, kv, hd, lengths, window):
    pairs = sum(min(i + 1, window or i + 1) for n in lengths for i in range(n))
    nbytes = batch * seq * heads * hd * 2 + sum(lengths) * (heads + 2 * kv) * hd * 2 + 8 * batch
    return max(nbytes / PEAK_HBM_BYTES, 4 * hd * heads * pairs / PEAK_BF16_FLOPS) * 1e3


def _flash_rows(libs, launch_kwargs, parent_module):
    for name, batch, seq, heads, kv, hd, lengths, starts, softcap, window in FLASH_SHAPES:
        starts = [seq - n for n in lengths] if starts == "left" else [0] * batch
        g = torch.Generator(device="cuda").manual_seed(5)
        q = torch.randn(batch, seq, heads, hd, generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn(batch, seq, kv, hd, generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn(batch, seq, kv, hd, generator=g, device="cuda").to(torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        sts = torch.tensor(starts, dtype=torch.int32, device="cuda")
        scale = hd ** -0.5
        plain = fa.flash_attention_reference(q, k, v, lens, sts, scale, softcap, window).float()
        row = {"shape": name, "bound_ms": _bound_ms(batch, seq, heads, kv, hd, lengths, window)}
        for lib_name, lib in libs.items():
            out = torch.empty_like(q)

            def call(lib=lib, out=out):
                fa.launch_kernel(lib, q, k, v, out, lens, sts, scale, softcap, window, True)

            call()
            torch.cuda.synchronize()
            row[lib_name] = {"ms": _graph_ms(call), "within_tolerance": _within(out, plain)}
        print(json.dumps(row), flush=True)
        del q, k, v, plain
        torch.cuda.empty_cache()


def _decode_bound_ms(n_slots, heads, kv, hd, w0, starts, qpos, write_col, window):
    """Bytes (q and out once, each role's trunk K/V over its kept span once,
    each row's tail K/V over its kept columns) over the HBM rate, against
    4*hd FLOPs per kept (row, head, key) over the bf16 rate."""
    trunk = [max(0, w0 - (s if window is None else max(s, p + s - window + 1)))
             for s, p in zip(starts, qpos)]
    tail = write_col + 1 - (0 if window is None else max(0, write_col - window + 1))
    rows = n_slots * len(starts)
    nbytes = 2 * (2 * rows * heads * hd + 2 * sum(trunk) * kv * hd + 2 * rows * tail * kv * hd)
    nbytes += 8 * len(starts)
    ops = 4 * hd * heads * n_slots * (sum(trunk) + len(starts) * tail)
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_BF16_FLOPS) * 1e3


def _host_us(fn):
    """Host microseconds per call of ``fn``, HOST_CALLS calls without a sync
    (fewer than the launch queue holds, so the host never waits on it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / HOST_CALLS * 1e6


def _decode_rows(libs, launch_kwargs, parent_module):
    for (name, n_slots, n_roles, heads, kv, hd, w0, ts, starts, write_col, softcap,
         window) in DECODE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(27)
        rows = n_slots * n_roles

        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

        q, tk, tv = randn(rows, heads, hd), randn(n_roles, w0, kv, hd), randn(n_roles, w0, kv, hd)
        lk, lv = randn(rows, ts, kv, hd), randn(rows, ts, kv, hd)
        qpos = [w0 - s + write_col for s in starts]
        sts = torch.tensor(starts, dtype=torch.int32, device="cuda")
        qps = torch.tensor(qpos, dtype=torch.int32, device="cuda")
        args = (q, tk, tv, lk, lv, sts, qps, write_col)
        kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
        plain = da.decode_attention_reference(*args, n_slots, n_roles, **kw).float()
        capacity = da._cluster_capacity(libs["this"], 0, hd, da.block_rows(n_slots, heads, kv))
        plan = da.launch_plan(n_slots, n_roles, heads, kv, hd, w0, write_col,
                              torch.cuda.get_device_properties(0).multi_processor_count,
                              capacity=capacity)
        row = {"shape": name, "plan": list(plan), "clusters_held": list(capacity),
               "bound_ms": _decode_bound_ms(n_slots, heads, kv, hd, w0, starts, qpos,
                                            write_col, window)}
        for lib_name, lib in libs.items():
            out = torch.empty_like(q)
            module = parent_module if lib_name == "parent" else da
            extra = launch_kwargs.get(lib_name, {})

            def call(lib=lib, out=out, module=module, extra=extra):
                module.launch_kernel(lib, *args, out, n_slots, n_roles, kw["scale"], softcap,
                                     window, **extra)

            call()
            torch.cuda.synchronize()
            row[lib_name] = {"ms": _graph_ms(call, reps=200),
                             "within_tolerance": _within(out, plain)}
            if lib_name == "diag_trace":
                call()
                torch.cuda.synchronize()
                x, y, z = plan.grid(n_roles, kv)
                row[lib_name]["trace"] = _trace_summary(lib, x * y * z)
            if lib_name in ("this", "parent"):
                # The wrapper as the model calls it, with this build loaded.
                saved = build.load_library
                build.load_library = lambda _name, lib=lib: lib
                try:
                    row[lib_name]["host_us_per_call"] = _host_us(
                        lambda: module.decode_attention(*args, n_slots, n_roles, **kw))
                finally:
                    build.load_library = saved
        print(json.dumps(row), flush=True)
        del q, tk, tv, lk, lv, plain
        torch.cuda.empty_cache()


#: The stamps of the diag_trace variant, in order.
TRACE_PHASES = ("start", "first tiles issued", "Q landed", "first K landed", "key loop done",
                "partials written", "partials merged and sent", "cluster barrier", "weights",
                "slice written")


def _trace_summary(lib, blocks):
    """Per phase: the median and the largest time since the block's
    previous stamp (us); when the blocks started and ended relative to the
    first start; the distinct SMs."""
    buf = (ctypes.c_ulonglong * (blocks * 16))()
    err = lib.consensus_decode_attention_trace(buf, blocks)
    if err:
        return {"error": err}
    rows = [list(buf[b * 16:(b + 1) * 16]) for b in range(blocks)]
    t0 = min(r[0] for r in rows)
    phases = {}
    for k in range(1, len(TRACE_PHASES)):
        d = sorted((r[k] - r[k - 1]) / 1e3 for r in rows)
        phases[TRACE_PHASES[k]] = [d[len(d) // 2], d[-1]]
    starts = sorted((r[0] - t0) / 1e3 for r in rows)
    ends = sorted((r[9] - t0) / 1e3 for r in rows)
    ghz = sorted((r[11] - r[10]) / max(1, r[9] - r[0]) for r in rows)
    return {"blocks": blocks, "sms": len({r[15] for r in rows}), "sm_ghz": ghz[len(ghz) // 2],
            "start_us_median_max": [starts[len(starts) // 2], starts[-1]],
            "end_us_min_median_max": [ends[0], ends[len(ends) // 2], ends[-1]],
            "phase_us_median_max": phases}


def _parent_decode_module(parent: pathlib.Path):
    """The parent checkout's ``ops/decode_attention.py``, loaded under its
    own name: its ``launch_kernel`` speaks its kernel's C interface."""
    path = parent / "consensus_tpu_torch" / "ops" / "decode_attention.py"
    spec = importlib.util.spec_from_file_location("parent_decode_attention", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=sorted(VARIANTS), default="flash_attention")
    parser.add_argument("--parent", help="another checkout whose build of the kernel to time "
                                         "beside this one")
    parser.add_argument("--variants", nargs="*", help="names from VARIANTS (default: all of "
                                                      "the kernel's)")
    args = parser.parse_args(argv)
    variants = VARIANTS[args.kernel]
    names = list(variants) if args.variants is None else args.variants
    unknown = set(names) - set(variants)
    if unknown:
        parser.error(f"unknown variants of {args.kernel}: {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    jobs = {"this": _variant_text(args.kernel, [])}
    launch_kwargs = {}
    for name in names:
        replacements, kwargs = variants[name]
        jobs[name] = _variant_text(args.kernel, replacements)
        launch_kwargs[name] = kwargs
    parent_module = None
    if args.parent:
        parent = pathlib.Path(args.parent)
        csrc = parent / "consensus_tpu_torch" / "csrc"
        jobs["parent"] = ((csrc / f"{args.kernel}.cu").read_text(),
                          {h.name: h.read_text() for h in csrc.glob("*.cuh")})
        if args.kernel == "decode_attention":
            parent_module = _parent_decode_module(parent)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: _compile(args.kernel, kv[0], *kv[1]),
                                        jobs.items())))
    libs = {}
    for name, (path, notes) in built.items():
        print(json.dumps({"build": name, "notes": notes}), flush=True)
        libs[name] = ctypes.CDLL(str(path))
    rows = _flash_rows if args.kernel == "flash_attention" else _decode_rows
    rows(libs, launch_kwargs, parent_module)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

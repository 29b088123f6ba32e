"""Time the flash-attention kernel (K1) beside variants of itself and beside
another checkout's K1, in one process on one card.

    python -m consensus_tpu_torch.cli.k1_variants [--parent DIR] [--variants NAME ...]

Each variant is this checkout's ``csrc/flash_attention.cu`` (and its headers)
with the text replacements of ``VARIANTS``, built with nvcc as the kernel
itself is (``ops/build.py``) into ``_build/variants/``; ``--parent DIR``
adds DIR's ``consensus_tpu_torch/csrc/flash_attention.cu`` as it stands,
built against DIR's own headers.  Every build is held against the plain
version (atol 5e-3 + rtol 1e-2, as ``chip_smoke.py``) and timed as 20
calls captured in a CUDA graph, at each of ``SHAPES``, on the same inputs.
Prints the card's name and power limit, one JSON line per build (its ptxas
warnings and spills), then one per shape: ms and within-tolerance per
build, and the bound (bytes over 3.35 TB/s against causal FLOPs over
989 TFLOP/s).  Compare builds only within one run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from consensus_tpu_torch.ops import build
from consensus_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 5e-3, 1e-2
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
HEADERS = ("sm90_wgmma.cuh", "sm90_mma.cuh")

#: name -> text replacements over the kernel's source and headers.
VARIANTS = {
    # The two consumer warpgroups issue their products without taking turns.
    "no_pingpong": [
        ("      if constexpr (CWG == 2) named_barrier_sync(3 + cw, 256);\n", ""),
        ("      if constexpr (CWG == 2) named_barrier_arrive(4 - cw, 256);\n", ""),
        ("    if (CWG == 2 && cw == 1 && round * G < n_tiles) named_barrier_arrive(3, 256);\n",
         ""),
        ("    if (CWG == 2 && cw == 0 && o_turn > 0) named_barrier_sync(3, 256);\n", ""),
    ],
    # One block per tile at every grid size: no persistent blocks.
    "block_per_tile": [
        ("  const unsigned grid = (unsigned)(tiles < 4LL * sms ? tiles : sms);",
         "  const unsigned grid = (unsigned)tiles;"),
    ],
}


def _ragged(seed, batch, seq, low):
    """A quarter of the rows full, the rest uniform in [low, seq]."""
    rng = np.random.default_rng(seed)
    return [seq] * (batch // 4) + [int(x) for x in rng.integers(low, seq + 1, batch - batch // 4)]


#: (name, B, S, H, KV, hd, lengths, starts or None for 0, softcap, window)
SHAPES = [
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


def _compile(name, source_text, headers):
    """Write a variant's source and headers to their own directory (the
    source includes its headers from there first) and build it."""
    out = build.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for header, text in headers.items():
        (out / header).write_text(text)
    (out / "flash_attention.cu").write_text(source_text)
    log = build.compile_library(out / "flash_attention.cu", out / "lib.so")
    notes = [line.strip() for line in log.splitlines()
             if "Performance Loss" in line or "spill stores" in line]
    return out / "lib.so", notes


def _variant_text(replacements):
    texts = {f: (build.CSRC_DIR / f).read_text() for f in ("flash_attention.cu", *HEADERS)}
    for old, new in replacements:
        hits = [f for f, t in texts.items() if old in t]
        if not hits:
            raise ValueError(f"variant text not found in the kernel's sources: {old!r}")
        for f in hits:
            texts[f] = texts[f].replace(old, new)
    return texts.pop("flash_attention.cu"), texts


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


def _bound_ms(batch, seq, heads, kv, hd, lengths, window):
    pairs = sum(min(i + 1, window or i + 1) for n in lengths for i in range(n))
    nbytes = batch * seq * heads * hd * 2 + sum(lengths) * (heads + 2 * kv) * hd * 2 + 8 * batch
    return max(nbytes / PEAK_HBM_BYTES, 4 * hd * heads * pairs / PEAK_BF16_FLOPS) * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another checkout whose K1 to build beside this one")
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS), choices=list(VARIANTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    jobs = {"this": _variant_text([])}
    jobs.update({name: _variant_text(VARIANTS[name]) for name in args.variants})
    if args.parent:
        csrc = pathlib.Path(args.parent) / "consensus_tpu_torch" / "csrc"
        jobs["parent"] = ((csrc / "flash_attention.cu").read_text(),
                          {h.name: h.read_text() for h in csrc.glob("*.cuh")})
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: _compile(kv[0], *kv[1]), jobs.items())))
    libs = {}
    for name, (path, notes) in built.items():
        print(json.dumps({"build": name, "notes": notes}), flush=True)
        libs[name] = ctypes.CDLL(str(path))

    for name, batch, seq, heads, kv, hd, lengths, starts, softcap, window in SHAPES:
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
            excess = (out.float() - plain).abs() - RTOL * plain.abs()
            within = bool((excess <= ATOL).all()) and bool(torch.isfinite(out).all())
            row[lib_name] = {"ms": _graph_ms(call), "within_tolerance": within}
        print(json.dumps(row), flush=True)
        del q, k, v, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Time the sampled generation paths of several checkouts of this repository
on one GPU, each checkout in its own process, in the order given.

    python -m consensus_tpu_torch.cli.compare_checkouts PARENT_DIR . . PARENT_DIR

Each directory holds a checkout (its ``chip_smoke.py`` and its
``consensus_tpu_torch`` package).  A child process imports that checkout's
code, never this one's, and prints one JSON line per part:

* ``sampler`` -- ms per decode step of the checkout's sampler alone, at
  (rows, vocab) = (8, 268), (8, 128256) and (32, 128256), float32 logits at
  temperature 1: its per-row noise source (threefry keys split once a step,
  or one ``torch.Generator`` per row where the checkout predates threefry)
  plus ``sample_tokens``, 50 eager steps between CUDA events;
* ``main_path`` and ``reference_defaults_path`` -- those phases of the
  checkout's ``chip_smoke.py`` (experiment wall, generate and score
  seconds, generated tokens, its checks), with the sampled and greedy
  decode steps counted by wrapping ``models.generate.sample_tokens``.

Give the order parent, change, change, parent: host time drifts between
processes, and the pairs show by how much.  Exits non-zero if a child fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

SAMPLER_SHAPES = ((8, 268), (8, 128256), (32, 128256))
SAMPLER_STEPS = 50


def _sampler_ms(rows: int, vocab: int) -> float:
    import inspect

    import torch

    from consensus_tpu_torch.models import sampling

    logits = torch.randn(rows, vocab, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    if "keys" in inspect.signature(sampling.sample_tokens).parameters:
        from consensus_tpu_torch.utils import threefry

        state = {"keys": threefry.fold_in(
            threefry.prng_key(0, "cuda"), torch.arange(rows, device="cuda"))}

        def step():
            pairs = threefry.split(state["keys"])
            state["keys"] = pairs[:, 0]
            return sampling.sample_tokens(logits, 1.0, keys=pairs[:, 1])
    else:
        generators = [torch.Generator("cuda").manual_seed(i) for i in range(rows)]

        def step():
            return sampling.sample_tokens(logits, 1.0, generators=generators)

    for _ in range(5):
        step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(SAMPLER_STEPS):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / SAMPLER_STEPS


def _child(tree: pathlib.Path) -> None:
    sys.path[0] = str(tree)  # the checkout's modules, not this file's directory
    import torch

    import chip_smoke
    from consensus_tpu_torch.models import generate as gen

    def emit(payload):
        print(json.dumps(dict(payload, tree=str(tree))), flush=True)

    emit({"part": "sampler", "steps": SAMPLER_STEPS, "ms_per_step": {
        f"{rows}x{vocab}": _sampler_ms(rows, vocab) for rows, vocab in SAMPLER_SHAPES}})

    steps = {"sampled": 0, "greedy": 0}
    sample_tokens = gen.sample_tokens

    def counted(logits, *args, **kwargs):
        temperature = kwargs.get("temperature", args[0] if args else 1.0)
        sampled = bool((torch.as_tensor(temperature, dtype=torch.float32) > 0).any())
        steps["sampled" if sampled else "greedy"] += 1
        return sample_tokens(logits, *args, **kwargs)

    gen.sample_tokens = counted
    keys = ("experiment_s", "generate_s", "score_s", "tokens", "init_s", "checks", "ok")
    for name in ("main_path", "reference_defaults_path"):
        steps.update(sampled=0, greedy=0)
        row = getattr(chip_smoke, name)()[0]
        emit(dict({key: row.get(key) for key in keys}, part=name, decode_steps=dict(steps)))
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkouts", nargs="+", type=pathlib.Path)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        _child(args.checkouts[0].resolve())
        return 0
    failed = 0
    for tree in args.checkouts:
        tree = tree.resolve()
        if not (tree / "chip_smoke.py").is_file():
            parser.error(f"{tree} holds no chip_smoke.py")
        code = subprocess.call(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--child", str(tree)],
            cwd=tree,
        )
        failed += code != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

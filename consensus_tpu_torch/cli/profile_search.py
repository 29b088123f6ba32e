"""Profile the fused token-search steps on the GPU: where a step's time goes.

    python -m consensus_tpu_torch.cli.profile_search \
        [-c consensus_tpu_torch/configs/llama3_8b_token_search.yaml] [--steps 8]

Builds the backend of the config (llama3-8b at full width, random weights),
then drives the two sessions its methods open, on the config's scenario:

* ``beam`` -- a ``beam_width``-slot session stepped as beam search steps it
  (egalitarian pruning, parents reorder, one ``advance_and_propose`` each);
* ``lookahead`` -- a trunk session; one step is a full ``branching_factor``
  x ``max_depth`` tree (``propose_suffixes`` per level) plus the trunk
  advance, as finite lookahead emits one token.

After a few warm-up steps, ``--steps`` steps of each run under
``torch.profiler`` (CPU + CUDA).  One JSON line per session: host wall per
step, device busy time per step (the union of kernel intervals), the
device's idle share of the wall, kernel launches per step, and device time
by kernel name, largest first.  Terminators are ignored, so every step does
the full work.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import torch
import yaml

from consensus_tpu_torch.backends.session import SearchSpec
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.methods.beam_search import BeamSearchGenerator
from consensus_tpu_torch.methods.finite_lookahead import FiniteLookaheadGenerator
from consensus_tpu_torch.methods.prompts import agent_prompt, reference_prompt


def _spec(config, variant: str, n_slots: int, k: int, max_steps: int) -> SearchSpec:
    scenario = config["scenario"]
    issue, opinions = scenario["issue"], scenario["agent_opinions"]
    system, user = reference_prompt(issue, opinions, variant=variant)
    return SearchSpec(
        ref_system=system, ref_user=user,
        agent_prompts=tuple(agent_prompt(issue, o, variant=variant) for o in opinions.values()),
        n_slots=n_slots, k=k, seed=int(config.get("seed", 0)), max_steps=max_steps,
    )


class BeamLoop:
    """Beam-search steps over one session (``methods/beam_search.py``)."""

    def __init__(self, session, width: int):
        self.session, self.width = session, width
        self.beams = [("", [0.0] * (session.n_roles - 1), 0)]
        self.proposals = session.propose()

    def step(self) -> None:
        candidates = [
            (seq + c.token, [a + b for a, b in zip(rewards, c.agent_logprobs)], c, slot)
            for seq, rewards, slot in self.beams
            for c in self.proposals[slot]
        ]
        ranked, _ = BeamSearchGenerator._prune(candidates, [], self.width, frozenset())
        parents, chosen, self.beams = [], [], []
        for i in range(self.width):
            seq, rewards, cand, parent = ranked[min(i, len(ranked) - 1)]
            parents.append(parent)
            chosen.append(cand)
            if i < len(ranked):
                self.beams.append((seq, rewards, i))
        self.proposals = self.session.advance_and_propose(parents, chosen)


class LookaheadLoop:
    """Finite-lookahead token steps over one trunk session."""

    def __init__(self, session, branching: int, depth: int):
        self.session, self.branching, self.depth = session, branching, depth
        self.root = session.propose()[0]
        self.emitted = 0

    def step(self) -> None:
        path, _ = FiniteLookaheadGenerator._best_path(
            self.session, self.root, self.branching, self.depth, self.emitted, frozenset()
        )
        self.emitted += 1
        self.root = self.session.advance_and_propose([0], [path[0]])[0]


def _kernel_intervals(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device kernel the profiler saw."""
    out = []
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            out.append((event.name, event.time_range.start, event.time_range.end))
    return out


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def profile_steps(name: str, loop, steps: int, warmup: int) -> Dict:
    for _ in range(warmup):
        loop.step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loop.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_intervals(prof)
    by_name: Dict[str, float] = {}
    for kname, lo, hi in kernels:
        key = kname if len(kname) <= 90 else kname[:87] + "..."
        by_name[key] = by_name.get(key, 0.0) + (hi - lo) / 1e3
    busy_ms = _union([(lo, hi) for _, lo, hi in kernels]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "session": name,
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps if kernels else None,
        "device_idle_share": 1.0 - busy_ms / wall_ms if kernels else None,
        "kernels_per_step": len(kernels) / steps,
        "decode_attention_ms_per_step": sum(
            ms for k, ms in by_name.items() if "decode_attention_kernel" in k
        ) / steps,
        "top_kernels": [
            {"name": k, "ms_per_step": ms / steps, "share_of_busy": ms / busy_ms if busy_ms else None}
            for k, ms in top
        ],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-c", "--config",
                        default="consensus_tpu_torch/configs/llama3_8b_token_search.yaml")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--warmup", type=int, default=3)
    args = parser.parse_args(argv)

    config = yaml.safe_load(open(args.config))
    backend = TorchBackend(**config["backend_options"])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "model": backend.config.name}),
          flush=True)
    beam = config["beam_search"]
    lookahead = config["finite_lookahead"]
    # Sessions as wide as the methods open them: the tails hold max_tokens.
    with torch.no_grad():
        session = backend.open_fused_token_search(
            _spec(config, "beam_search", beam["beam_width"], beam["beam_width"], beam["max_tokens"])
        )
        try:
            print(json.dumps(profile_steps(
                "beam", BeamLoop(session, beam["beam_width"]), args.steps, args.warmup
            )), flush=True)
        finally:
            session.close()
        session = backend.open_fused_token_search(
            _spec(config, "finite_lookahead", 1, lookahead["branching_factor"],
                  lookahead["max_tokens"])
        )
        try:
            print(json.dumps(profile_steps(
                "lookahead",
                LookaheadLoop(session, lookahead["branching_factor"], lookahead["max_depth"]),
                args.steps, args.warmup,
            )), flush=True)
        finally:
            session.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

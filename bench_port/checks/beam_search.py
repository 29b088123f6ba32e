"""The checks of ``beam_search`` statements.

Exact, on every statement (``mismatches``): the session's prompts are the
frozen templates' for its scenario; the statement before brushup is the one
a replay of beam search over the session's own proposals picks, with every
advance's parents and tokens as the replay asks; the brushup pass's prompt
and its output, cleaned.

Numbers against the reference, on a sample of fused sessions drawn from the
seed that always holds the one with the longest prompt:

* ``lp_gap``: along the final lineage of slot 0 of the session, every
  proposal's reference-policy log-probability (with the logit bias) and
  every agent's log-probability of it, against the reference's at the same
  prefix; the widest absolute difference.  The search session's prefill
  and its advances through K2.
* ``prefix_sessions``: how many statements took the full-prefix session
  (read, with no limit).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_port.harness.check import calls, prompt_ids, sample
from bench_port.reference import text
from bench_port.reference.model import Job, run
from bench_port.reference.select import replay_beam_search


def mismatches(st, scenario, cfg) -> int:
    issue, opinions = scenario["issue"], scenario["agent_opinions"]
    if len(st.log.sessions) != 1:
        return 1
    session = st.log.sessions[0]
    spec = session.spec
    system, user = text.reference_prompt(issue, opinions, "beam_search")
    agents = tuple(text.agent_prompt(issue, o, "beam_search") for o in opinions.values())
    bad = int((spec.ref_system, spec.ref_user) != (system, user)) + int(tuple(spec.agent_prompts) != agents)
    picked, replay_bad = replay_beam_search(
        session.steps, len(agents), int(cfg["beam_width"]), int(cfg["max_tokens"]),
        pinned=bool(cfg.get("pin_budget")),
    )
    bad += replay_bad + int(picked != st.pre_brushup)
    if cfg.get("brushup"):
        gens = calls(st, "generate")
        if len(gens) != 1:
            return bad + 1
        (request,), (result,) = gens[0]
        bad += request.user_prompt != text.brushup_user(st.pre_brushup)
        bad += request.system_prompt != text.BRUSHUP_SYSTEM
        cleaned = text.clean_statement(result.text) if result.ok else ""
        bad += st.text != (cleaned or st.pre_brushup)
    return int(bad)


def _lineage(session) -> Tuple[List[int], List[list]]:
    """Slot 0's final token ids, and at each step the proposals made for
    the slot that then held its prefix."""
    steps = session.steps
    slots = [0]
    for parents, _, _ in reversed(steps[1:]):
        slots.append(parents[slots[-1]])
    slots.reverse()  # slots[t]: the slot holding the prefix at step t
    tokens = [steps[t][1][slots[t]] for t in range(1, len(steps))]
    return tokens, [steps[t][2][slots[t]] for t in range(len(steps))]


def _session_jobs(session, max_context: int, vocab_size: int) -> Tuple[List[Job], List[list], torch.Tensor]:
    spec = session.spec
    tokens, proposals = _lineage(session)
    max_prefix = max_context - spec.max_steps
    prompts = [(spec.ref_user, spec.ref_system)] + [(u, s) for s, u in spec.agent_prompts]
    jobs = []
    for user, system in prompts:
        prompt = prompt_ids(user, system, chat=False)[-max_prefix:]
        jobs.append(Job(prefix=prompt + tokens, rows=(len(prompt) - 1, len(prompt) + len(tokens))))
    bias = torch.zeros(vocab_size, dtype=torch.float32)
    for word in spec.bias_against_tokens:
        for token_id in text.token_ids_containing(word):
            bias[token_id] += spec.bias_value
    return jobs, proposals, bias


def _session_logprobs(logits: List[torch.Tensor], proposals: List[list], bias: torch.Tensor) -> np.ndarray:
    """(steps, k, roles) reference log-probabilities of the proposed ids."""
    ids = torch.tensor([[c.token_id for c in step] for step in proposals])
    out = []
    for role, rows in enumerate(logits):
        if role == 0:
            rows = rows + bias.to(rows.device)
        lp = torch.log_softmax(rows, dim=-1).cpu()
        out.append(torch.gather(lp, 1, ids))
    return torch.stack(out, dim=-1).numpy()


def compare(statements, sizes, cfg, flat, seed, ref_w, ctl_w) -> Tuple[Dict, Dict]:
    fused = [s for s in statements if s.log.sessions and s.log.sessions[0].kind == "fused"]
    chosen = sample(fused, sizes["sessions"], seed, lambda s: len(s.log.sessions[0].spec.ref_user), 3)
    built = [
        _session_jobs(s.log.sessions[0], cfg["backend"]["max_context"], flat["vocab_size"])
        for s in chosen
    ]
    jobs = [j for b in built for j in b[0]]
    ref = run(flat, ref_w, jobs) if jobs else []
    ctl = run(flat, ctl_w, jobs) if ctl_w is not None and jobs else []
    gaps, ctl_gaps, at = [], [], 0
    for session_jobs, proposals, bias in built:
        n = len(session_jobs)
        prog = np.asarray(
            [[[c.ref_logprob, *c.agent_logprobs] for c in step] for step in proposals]
        )
        mine = _session_logprobs([r.prefix for r in ref[at : at + n]], proposals, bias)
        gaps.append(float(np.abs(prog - mine).max()))
        if ctl_w is not None:
            theirs = _session_logprobs([r.prefix for r in ctl[at : at + n]], proposals, bias)
            ctl_gaps.append(float(np.abs(theirs - mine).max()))
        at += n
    readings = {
        "lp_gap": max(gaps) if gaps else None,
        "prefix_sessions": sum(1 for s in statements if s.log.sessions and s.log.sessions[0].kind != "fused"),
    }
    return readings, {"lp_gap": max(ctl_gaps, default=None)}

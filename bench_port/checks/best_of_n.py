"""The checks of ``best_of_n`` statements.

Exact, on every statement (``mismatches``): the prompts the method sent are
the frozen templates' for its scenario; the candidates it scored are its
generations, cleaned; the statement it returned is the egalitarian choice
over the utilities it was given.

Numbers against the reference, each on a sample of statements drawn from
the seed that always holds the one with the longest prompt:

* ``gen_gap``: the greedy statements' generated tokens, teacher-forced
  through the reference over their prompt; the widest gap by which a
  generated token's logit lies below the reference's best at that
  position.  Prefill, decode over the shared trunk through K2, the int8
  weights.
* ``sampled_xent``: every draft of the sampled statements, teacher-forced
  the same way; the mean over their tokens of the token's reference
  negative log-probability (at the statement's temperature) less the
  reference's entropy at that position: about 0 for tokens drawn from the
  reference's own distribution, the excess of the cross-entropy where they
  are drawn from another.  The control reads its expectation under the
  int4 distribution.  The sampled rows' decode and the sampler.
* ``util_mean_gap``: every utility of the (candidates x agents) matrix,
  mean continuation log-probability, against the reference's; the mean
  absolute difference over the sample's utilities.  The fused score
  matrix, its prefill, K1.  ``util_gap``, the widest of those differences,
  is read beside it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port.harness.check import calls, prompt_ids, sample
from bench_port.reference import text
from bench_port.reference.model import Job, run
from bench_port.reference.select import egalitarian_choice


def mismatches(st, scenario, cfg) -> int:
    issue, opinions = scenario["issue"], scenario["agent_opinions"]
    gens, mats = calls(st, "generate"), calls(st, "score_matrix")
    if len(gens) != 1 or len(mats) != 1:
        return 1
    system, user = text.reference_prompt(issue, opinions, "best_of_n")
    requests, results = gens[0]
    bad = sum(r.system_prompt != system or r.user_prompt != user or not r.chat for r in requests)
    candidates = tuple(
        c for c in (text.clean_statement(r.text) for r in results if r.ok) if c
    )
    (matrix_request,), (matrix,) = mats[0]
    agents = tuple(text.agent_prompt(issue, o, "best_of_n") for o in opinions.values())
    bad += matrix_request.candidates != candidates
    bad += tuple((a.system_prompt, a.context) for a in matrix_request.agents) != agents
    choice = egalitarian_choice(np.asarray(matrix.utilities).reshape(len(candidates), len(agents)))
    bad += st.text != candidates[choice]
    return int(bad)


def _prompt_length(st) -> int:
    return len(st.log.calls[0][1][0].user_prompt)


def _gen_job(st) -> Tuple[Job, List[int]]:
    (requests, results), = calls(st, "generate")
    request, result = requests[0], results[0]
    prompt = prompt_ids(request.user_prompt, request.system_prompt, request.chat)
    ids = list(result.token_ids)
    return Job(prefix=prompt + ids, rows=(len(prompt) - 1, len(prompt) - 1 + len(ids))), ids


def _draft_job(st) -> Tuple[Job, List[List[int]]]:
    """The statement's prompt with each of its drafts as a branch."""
    (requests, results), = calls(st, "generate")
    request = requests[0]
    drafts = [list(r.token_ids) for r in results if r.token_ids]
    return Job(prefix=prompt_ids(request.user_prompt, request.system_prompt, request.chat),
               branches=drafts), drafts


def _matrix_jobs(st) -> Tuple[List[Job], np.ndarray, List[List[int]]]:
    (matrix_request,), (matrix,) = calls(st, "score_matrix")[0]
    conts = [text.encode(c) for c in matrix_request.candidates]
    jobs = [
        Job(prefix=prompt_ids(a.context, a.system_prompt, a.chat), branches=[c for c in conts if c])
        for a in matrix_request.agents
    ]
    utilities = np.asarray(matrix.utilities, dtype=np.float64).reshape(len(conts), len(jobs))
    return jobs, utilities, conts


def _gen_gap(ref: torch.Tensor, ids: List[int], chosen: Optional[torch.Tensor] = None) -> float:
    """Widest gap below the best reference logit of the tokens ``ids`` (or,
    for the control, of the tokens it would put first)."""
    picked = torch.tensor(ids, device=ref.device) if chosen is None else chosen
    rows = torch.arange(ref.shape[0], device=ref.device)
    return float((ref.max(dim=-1).values - ref[rows, picked]).max())


def _xent_excess(
    ref: torch.Tensor, ids: List[int], temperature: float, other: Optional[torch.Tensor] = None
) -> Tuple[float, int]:
    """(sum over positions, count) of the reference's negative
    log-probability of ``ids`` less its entropy, at ``temperature``; with
    ``other`` (the control's logits), of the cross-entropy of the control's
    distribution against the reference's, in expectation."""
    lp = torch.log_softmax(ref / temperature, dim=-1)
    entropy = -(lp.exp() * lp).sum(dim=-1)
    if other is None:
        nll = -lp[torch.arange(len(ids), device=lp.device), torch.tensor(ids, device=lp.device)]
    else:
        nll = -(torch.softmax(other / temperature, dim=-1) * lp).sum(dim=-1)
    return float((nll - entropy).sum()), len(ids)


def _utilities(logits: List[torch.Tensor], conts: List[List[int]], default: float) -> np.ndarray:
    out, branch = [], 0
    for ids in conts:
        if not ids:
            out.append(default)
            continue
        lp = torch.log_softmax(logits[branch], dim=-1)
        out.append(float(lp[torch.arange(len(ids)), torch.tensor(ids, device=lp.device)].mean()))
        branch += 1
    return np.asarray(out)


def compare(statements, sizes, cfg, flat, seed, ref_w, ctl_w) -> Tuple[Dict, Dict]:
    greedy = [s for s in statements if float(s.config.get("temperature", 1.0)) <= 0.0]
    sampled = [s for s in statements if float(s.config.get("temperature", 1.0)) > 0.0]
    gen = sample(greedy, sizes["generations"], seed, _prompt_length, 1)
    mats = sample(statements, sizes["matrices"], seed, _prompt_length, 2)
    drafts = sample(sampled, sizes["sampled"], seed, _prompt_length, 4)
    gen_jobs = [_gen_job(s) for s in gen]
    draft_jobs = [_draft_job(s) for s in drafts]
    mat_jobs = [_matrix_jobs(s) for s in mats]
    jobs = [j for j, _ in gen_jobs] + [j for j, _ in draft_jobs] + [j for m in mat_jobs for j in m[0]]
    ref = run(flat, ref_w, jobs)
    ctl = run(flat, ctl_w, jobs) if ctl_w is not None else None
    readings: Dict[str, Optional[float]] = {}
    controls: Dict[str, Optional[float]] = {}

    gaps, ctl_gaps = [], []
    for i, (_, ids) in enumerate(gen_jobs):
        gaps.append(_gen_gap(ref[i].prefix, ids))
        if ctl is not None:
            ctl_gaps.append(_gen_gap(ref[i].prefix, ids, ctl[i].prefix.argmax(dim=-1)))
    readings["gen_gap"] = max(gaps) if gaps else None
    controls["gen_gap"] = max(ctl_gaps, default=None)

    at = len(gen_jobs)
    total, ctl_total, count = 0.0, 0.0, 0
    for k, ((_, ids_list), st) in enumerate(zip(draft_jobs, drafts)):
        temperature = float(st.config.get("temperature", 1.0))
        for b, ids in enumerate(ids_list):
            s, n = _xent_excess(ref[at + k].branches[b], ids, temperature)
            total, count = total + s, count + n
            if ctl is not None:
                ctl_total += _xent_excess(ref[at + k].branches[b], ids, temperature, ctl[at + k].branches[b])[0]
    readings["sampled_xent"] = total / count if count else None
    controls["sampled_xent"] = ctl_total / count if count and ctl is not None else None

    at += len(draft_jobs)
    diffs, ctl_diffs = [], []
    for agent_jobs, prog, conts in mat_jobs:
        for a in range(len(agent_jobs)):
            mine = _utilities(ref[at + a].branches, conts, -10.0)
            diffs.extend(np.abs(prog[:, a] - mine))
            if ctl is not None:
                theirs = _utilities(ctl[at + a].branches, conts, -10.0)
                ctl_diffs.extend(np.abs(theirs - mine))
        at += len(agent_jobs)
    for name, fn in (("util_mean_gap", np.mean), ("util_gap", np.max)):
        readings[name] = float(fn(diffs)) if diffs else None
        controls[name] = float(fn(ctl_diffs)) if ctl_diffs else None
    return readings, controls

"""Deterministic, seeded scenario generator with adversarial profiles (a
copy of ``consensus_tpu/data/scenarios/generator.py``, pure Python).

The paper's welfare numbers — and every serving bench built on top of
them — were measured on the 5 AAMAS survey scenarios with 4-5 agents
each.  That is too small to separate the welfare rules (egalitarian vs
utilitarian vs log-Nash) and too repetitive to be an honest prefix-cache
workload.  This module generates synthetic deliberation scenarios from
templated issues × sampled opinion profiles × agent counts 2-500, in
**adversarial profile families** designed to pull the rules apart:

* ``polarized``     — two opposed blocs, each bloc sharing one opinion
  text verbatim.  Utilitarian welfare weights the majority bloc by its
  size; egalitarian welfare is held hostage by the minority — the
  textbook winner-flip profile.
* ``holdout``       — n-1 agents share a consensus opinion, one agent
  dissents.  Egalitarian welfare IS the holdout's utility.
* ``sybil``         — one opinion duplicated verbatim across a sybil
  cluster plus a few organic agents.  Utilitarian welfare is captured
  by multiplicity; egalitarian is indifferent to it (and score-row
  dedup collapses the clones on the device).
* ``contradictory`` — self-contradicting / incoherent opinions, the
  garbage-in stress case for utility sanitisation.
* ``paraphrase``    — clusters of near-duplicate paraphrases sharing a
  long common prefix with divergent tails: the *realistic*
  prefix-sharing case (vs ``fixed:K`` whole-prompt repetition).
* ``mixed``         — independent pro/con/hedge opinions, the control.

Everything is a pure function of ``(seed, version, family, index)``
through :func:`_rng` (blake2b → ``random.Random``), so the same
:class:`CorpusSpec` regenerates byte-identical records on any platform.
No wall clock, no global RNG.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Any, Dict, List, Tuple

SCENARIO_SCHEMA = "consensus_tpu.scenario.v2"

#: Generation algorithm revision.  Bump whenever the templates or the
#: sampling logic change — the manifest records it, and `--check` treats
#: a mismatch as "this corpus cannot be regenerated by this code".
GENERATOR_VERSION = 1

FAMILIES: Tuple[str, ...] = (
    "contradictory",
    "holdout",
    "mixed",
    "paraphrase",
    "polarized",
    "sybil",
)

#: Smallest agent count at which each family's structure is non-degenerate
#: (sybil needs a clone pair plus an organic agent; paraphrase needs two
#: clusters of two).
_FAMILY_MIN_AGENTS = {
    "contradictory": 2,
    "holdout": 2,
    "mixed": 2,
    "paraphrase": 4,
    "polarized": 2,
    "sybil": 3,
}

# --------------------------------------------------------------------------
# Issue templates: (question, pro clause, con clause).  The clauses slot
# into the opinion templates below, so every opinion is on-topic.

_TOPICS: Tuple[Tuple[str, str, str], ...] = (
    ("Should a person's genetic code be treated as private information?",
     "our genetic code belongs to us alone and sharing it must require "
     "explicit consent",
     "open genetic databases accelerate medical research that saves lives"),
    ("Should cities convert central car lanes into protected cycle lanes?",
     "safe cycling cuts congestion and pollution for everyone",
     "deliveries and disabled access depend on those car lanes"),
    ("Should social media platforms require verified identities?",
     "accountability would collapse the abuse and bot economy",
     "anonymity protects whistleblowers and vulnerable people"),
    ("Should a universal basic income replace means-tested benefits?",
     "a guaranteed floor removes poverty traps and demeaning paperwork",
     "untargeted payments cost more and help the poorest less"),
    ("Should gene-edited crops be approved for general cultivation?",
     "precise editing gives drought resistance we urgently need",
     "ecosystem effects are unknown and approval is irreversible in "
     "practice"),
    ("Should voting be made compulsory in national elections?",
     "full turnout makes the result legitimate for everyone",
     "a forced ballot is not consent and punishes the disengaged"),
    ("Should AI systems be allowed to make emergency triage decisions?",
     "consistent criteria applied instantly will save more patients",
     "accountability for a life-and-death call cannot rest with software"),
    ("Should public transport be free at the point of use?",
     "fare-free transit is the fastest working lever on car dependence",
     "free riders do not fund maintenance, and service quality is what "
     "actually attracts riders"),
    ("Should employers be allowed to monitor remote workers' screens?",
     "teams that measure output fairly need visibility into work",
     "surveillance destroys the trust remote work depends on"),
    ("Should schools replace written exams with project-based assessment?",
     "projects measure the sustained thinking real work requires",
     "exams are the only assessment that is blind to family resources"),
)

_PRO_TEMPLATES: Tuple[str, ...] = (
    "I strongly support this: {pro}.",
    "Yes. For me the decisive point is that {pro}.",
    "On balance I am in favour, mainly because {pro}.",
    "I think we should — {pro}, and that outweighs the costs.",
    "Count me as a firm yes; {pro}, even if the rollout takes care.",
    "Supportive here. The argument that convinces me is that {pro}.",
)

_CON_TEMPLATES: Tuple[str, ...] = (
    "I am against this: {con}.",
    "No. The thing people keep ignoring is that {con}.",
    "On balance I am opposed, mainly because {con}.",
    "I do not think we should — {con}, and no safeguard fixes that.",
    "Count me as a firm no; {con}, whatever the upside is claimed to be.",
    "Opposed here. The argument that settles it for me is that {con}.",
)

_HEDGE_TEMPLATES: Tuple[str, ...] = (
    "I can see both sides: {pro}, but equally {con}. It comes down to "
    "the safeguards.",
    "Genuinely torn. {pro} — yet {con}. I would want a trial period "
    "first.",
    "It depends on implementation: {pro}, although {con}.",
)

_FLOURISHES: Tuple[str, ...] = (
    "",
    " Speaking from personal experience here.",
    " I work adjacent to this area, for context.",
    " My view on this has shifted over the years.",
    " I answered a survey on this once and have thought about it since.",
    " Happy to be convinced otherwise, but that is where I stand today.",
)

#: Tail variants for the paraphrase family: the cluster shares the whole
#: leading opinion (a long common prefix — the realistic KV-sharing case)
#: and diverges only in these closers.
_PARAPHRASE_TAILS: Tuple[str, ...] = (
    " In short: yes from me.",
    " So overall I support it.",
    " Which is why I come down in favour.",
    " That is the heart of it for me.",
    " On reflection that settles it.",
    " I do not see a stronger counterargument.",
)

_NONSEQUITURS: Tuple[str, ...] = (
    "Also, unrelatedly, the meeting room was too cold.",
    "In any case the form did not have a box for this.",
    "Separately, I believe the moon landing photos are overexposed.",
    "That said, my answer mostly depends on the weather.",
)


def _rng(seed: int, version: str, family: str, index: int) -> random.Random:
    """A ``random.Random`` keyed by the full scenario coordinate.

    blake2b gives a platform-independent key; CPython's Mersenne Twister
    is specified and stable, so every draw downstream is reproducible."""
    key = f"{seed}|{version}|{family}|{index}".encode("utf-8")
    digest = hashlib.blake2b(key, digest_size=8).digest()
    return random.Random(int.from_bytes(digest, "big"))


def _agent_names(n: int) -> List[str]:
    return [f"Agent {i + 1}" for i in range(n)]


def _pro(rng: random.Random, pro: str) -> str:
    return rng.choice(_PRO_TEMPLATES).format(pro=pro) + rng.choice(_FLOURISHES)


def _con(rng: random.Random, con: str) -> str:
    return rng.choice(_CON_TEMPLATES).format(con=con) + rng.choice(_FLOURISHES)


def _hedge(rng: random.Random, pro: str, con: str) -> str:
    return rng.choice(_HEDGE_TEMPLATES).format(pro=pro, con=con)


# --------------------------------------------------------------------------
# Family builders: (rng, pro, con, n) -> (opinions, profile).


def _build_mixed(rng, pro, con, n):
    opinions = {}
    stances = {"pro": 0, "con": 0, "hedge": 0}
    for name in _agent_names(n):
        stance = rng.choice(("pro", "pro", "con", "con", "hedge"))
        stances[stance] += 1
        if stance == "pro":
            opinions[name] = _pro(rng, pro)
        elif stance == "con":
            opinions[name] = _con(rng, con)
        else:
            opinions[name] = _hedge(rng, pro, con)
    return opinions, {"stances": stances}


def _build_polarized(rng, pro, con, n):
    # Majority bloc 55-80% of the panel, both blocs non-empty.
    majority = max(1, min(n - 1, round(n * rng.uniform(0.55, 0.80))))
    minority = n - majority
    pro_text = _pro(rng, pro) + " Our whole group agrees on this."
    con_text = _con(rng, con) + " Our whole group agrees on this."
    names = _agent_names(n)
    opinions = {}
    for i, name in enumerate(names):
        opinions[name] = pro_text if i < majority else con_text
    return opinions, {"bloc_sizes": [majority, minority]}


def _build_holdout(rng, pro, con, n):
    consensus = _pro(rng, pro) + " I believe nearly everyone here agrees."
    holdout_name = f"Agent {rng.randrange(n) + 1}"
    opinions = {}
    for name in _agent_names(n):
        if name == holdout_name:
            opinions[name] = (
                _con(rng, con)
                + " I know I am the only one saying this, and I will not "
                  "sign a statement that papers over it."
            )
        else:
            opinions[name] = consensus
    return opinions, {"holdouts": 1, "holdout_agent": holdout_name,
                      "bloc_sizes": [n - 1, 1]}


def _build_sybil(rng, pro, con, n):
    # Clone cluster of 2..n-1 agents (always leaves >= 1 organic agent).
    multiplicity = rng.randint(2, n - 1)
    clone = (
        rng.choice(_PRO_TEMPLATES).format(pro=pro)
        + " Posting this on behalf of our community group."
    )
    names = _agent_names(n)
    clone_slots = sorted(rng.sample(range(n), multiplicity))
    opinions = {}
    for i, name in enumerate(names):
        if i in clone_slots:
            opinions[name] = clone
        else:
            opinions[name] = (
                _con(rng, con) if rng.random() < 0.6 else _hedge(rng, pro, con)
            )
    return opinions, {"sybil_multiplicity": multiplicity,
                      "organic": n - multiplicity}


def _build_contradictory(rng, pro, con, n):
    opinions = {}
    for name in _agent_names(n):
        opinions[name] = " ".join((
            rng.choice(_PRO_TEMPLATES).format(pro=pro),
            rng.choice(_CON_TEMPLATES).format(con=con),
            rng.choice(_NONSEQUITURS),
        ))
    return opinions, {"incoherent": n}


def _build_paraphrase(rng, pro, con, n):
    # 2..4 clusters; each cluster shares a full base opinion (long common
    # prefix) and members diverge only in a short closing tail.
    n_clusters = rng.randint(2, min(4, n // 2))
    sizes = [1] * n_clusters
    for _ in range(n - n_clusters):
        sizes[rng.randrange(n_clusters)] += 1
    names = iter(_agent_names(n))
    opinions = {}
    for cluster in range(n_clusters):
        base = _pro(rng, pro) if cluster % 2 == 0 else _con(rng, con)
        tails = list(_PARAPHRASE_TAILS)
        rng.shuffle(tails)
        for member in range(sizes[cluster]):
            tail = tails[member % len(tails)]
            if member >= len(tails):
                tail += f" (echoing cluster voice {member})"
            opinions[next(names)] = base + tail
    return opinions, {"paraphrase_clusters": sizes}


_BUILDERS = {
    "contradictory": _build_contradictory,
    "holdout": _build_holdout,
    "mixed": _build_mixed,
    "paraphrase": _build_paraphrase,
    "polarized": _build_polarized,
    "sybil": _build_sybil,
}


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """Everything that determines a corpus, and nothing else.

    Two equal specs regenerate byte-identical JSONL; the manifest embeds
    the spec so ``gen_corpus --check`` can re-derive the corpus from the
    manifest alone."""

    version: str = "v2"
    seed: int = 20260807
    per_family: int = 8
    families: Tuple[str, ...] = FAMILIES
    #: Agent counts cycled per family index (Fibonacci-ish ladder keeps
    #: small panels common while still exercising the chunked regime).
    agent_ladder: Tuple[int, ...] = (2, 3, 5, 8, 13, 21, 34, 64)
    #: Append the 500-agent polarized headline scenario (id
    #: ``polarized-500``) — the scale demo the engine serves end-to-end.
    include_big: bool = True
    big_agents: int = 500

    def __post_init__(self) -> None:
        unknown = sorted(set(self.families) - set(FAMILIES))
        if unknown:
            raise ValueError(f"unknown families {unknown}; "
                             f"want a subset of {FAMILIES}")
        if self.per_family < 1:
            raise ValueError("per_family must be >= 1")
        if not self.agent_ladder or min(self.agent_ladder) < 2:
            raise ValueError("agent_ladder entries must be >= 2")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "seed": self.seed,
            "per_family": self.per_family,
            "families": list(self.families),
            "agent_ladder": list(self.agent_ladder),
            "include_big": self.include_big,
            "big_agents": self.big_agents,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "CorpusSpec":
        return cls(
            version=str(data["version"]),
            seed=int(data["seed"]),
            per_family=int(data["per_family"]),
            families=tuple(data["families"]),
            agent_ladder=tuple(data["agent_ladder"]),
            include_big=bool(data["include_big"]),
            big_agents=int(data["big_agents"]),
        )


def generate_scenario(
    spec: CorpusSpec, family: str, index: int, n_agents: int = None,
    scenario_id: str = None,
) -> Dict[str, Any]:
    """One scenario record, fully determined by (spec, family, index)."""
    if family not in _BUILDERS:
        raise ValueError(f"unknown family {family!r}")
    rng = _rng(spec.seed, spec.version, family, index)
    if n_agents is None:
        ladder = spec.agent_ladder
        n_agents = ladder[index % len(ladder)]
    n_agents = max(_FAMILY_MIN_AGENTS[family], int(n_agents))
    issue, pro, con = _TOPICS[rng.randrange(len(_TOPICS))]
    opinions, profile = _BUILDERS[family](rng, pro, con, n_agents)
    return {
        "schema": SCENARIO_SCHEMA,
        "id": scenario_id or f"{family}-{index:04d}",
        "family": family,
        "version": spec.version,
        "issue": issue,
        "n_agents": n_agents,
        "agent_opinions": opinions,
        "profile": profile,
    }


def generate_scenarios(spec: CorpusSpec) -> List[Dict[str, Any]]:
    """The full corpus, in a canonical order (family-sorted, index
    ascending, the big headline scenario last)."""
    records = [
        generate_scenario(spec, family, index)
        for family in sorted(spec.families)
        for index in range(spec.per_family)
    ]
    if spec.include_big:
        records.append(generate_scenario(
            spec, "polarized", spec.per_family + 1000,
            n_agents=spec.big_agents,
            scenario_id=f"polarized-{spec.big_agents}",
        ))
    return records

"""Scenario corpus subsystem (the port of ``consensus_tpu/data/scenarios``).

Deterministic generator for adversarial opinion profiles
(:mod:`.generator`), versioned JSONL + manifest corpus I/O
(:mod:`.corpus`), scenario-ref resolution (:mod:`.registry`), and the
fairness welfare-gap tables the regression suite pins
(:mod:`.fairness`)."""

from consensus_tpu_torch.data.scenarios.corpus import (
    Corpus,
    CorpusIntegrityError,
    load_corpus,
    parse_family_mix,
    regenerate_check,
    write_corpus,
)
from consensus_tpu_torch.data.scenarios.generator import (
    FAMILIES,
    GENERATOR_VERSION,
    SCENARIO_SCHEMA,
    CorpusSpec,
    generate_scenario,
    generate_scenarios,
)
from consensus_tpu_torch.data.scenarios.registry import (
    clear_corpus_cache,
    corpus_root,
    get_corpus,
    maybe_resolve_scenario,
    resolve_scenario_ref,
)

__all__ = [
    "Corpus",
    "CorpusIntegrityError",
    "CorpusSpec",
    "FAMILIES",
    "GENERATOR_VERSION",
    "SCENARIO_SCHEMA",
    "clear_corpus_cache",
    "corpus_root",
    "generate_scenario",
    "generate_scenarios",
    "get_corpus",
    "load_corpus",
    "maybe_resolve_scenario",
    "parse_family_mix",
    "regenerate_check",
    "resolve_scenario_ref",
    "write_corpus",
]

"""Scenario references: one string names a scenario anywhere in the repo
(the port of ``consensus_tpu/data/scenarios/registry.py``).

An ``Experiment`` config's ``scenario`` (and so every ``run_sweep`` config)
accepts the same ref grammar as the JAX package's instead of inlining
issue + opinion text:

* ``aamas:<k>``           — the paper's appendix survey scenarios (1-5).
* ``main_body:<k>``       — the paper's main-body scenarios (1-3), the
  ``scenario`` of ``configs/main_body/scenario_<k>.yaml``.
* ``corpus:<name>``       — the first (id-sorted) scenario of a corpus.
* ``corpus:<name>:<id>``  — a specific scenario, e.g.
  ``corpus:v2:polarized-500``.

``<name>`` resolves against the repo's ``data/`` tree (``v2`` →
``data/scenarios_v2``) or is taken as a literal directory path, so tests
and CI can point refs at freshly generated throwaway corpora.  Loaded
corpora are cached per resolved path (they are immutable, content-hashed
artifacts)."""

from __future__ import annotations

import pathlib
import threading
from typing import Any, Dict, Optional, Union

from consensus_tpu_torch.data.scenarios.corpus import Corpus, load_corpus

#: Repo root (…/consensus_tpu_torch/data/scenarios/registry.py -> parents[3]).
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

_CACHE: Dict[pathlib.Path, Corpus] = {}
_CACHE_LOCK = threading.Lock()


def corpus_root(name: Union[str, pathlib.Path]) -> pathlib.Path:
    """Resolve a corpus name/path to its directory (must exist)."""
    candidates = [
        pathlib.Path(name),
        _REPO_ROOT / "data" / f"scenarios_{name}",
        _REPO_ROOT / "data" / str(name),
    ]
    for candidate in candidates:
        if candidate.is_dir():
            return candidate.resolve()
    raise FileNotFoundError(
        f"no corpus named {name!r}; tried "
        + ", ".join(str(c) for c in candidates)
    )


def get_corpus(name: Union[str, pathlib.Path]) -> Corpus:
    """Load a corpus by name or path, cached by resolved directory."""
    root = corpus_root(name)
    with _CACHE_LOCK:
        corpus = _CACHE.get(root)
        if corpus is None:
            corpus = load_corpus(root)
            _CACHE[root] = corpus
        return corpus


def clear_corpus_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()


def resolve_scenario_ref(ref: str) -> Dict[str, Any]:
    """A scenario ref -> ``{"issue", "agent_opinions", ...}`` dict.

    Corpus scenarios keep their ``id`` / ``family`` / ``profile`` keys so
    callers can stamp provenance; AAMAS scenarios gain a synthetic id."""
    if not isinstance(ref, str) or not ref.strip():
        raise ValueError(f"scenario ref must be a non-empty string, got {ref!r}")
    kind, _, rest = ref.strip().partition(":")
    if kind in ("aamas", "main_body"):
        from consensus_tpu_torch.data.aamas_scenarios import MAIN_BODY, SCENARIOS

        table = SCENARIOS if kind == "aamas" else MAIN_BODY
        try:
            key = int(rest)
            scenario = table[key]
        except (ValueError, KeyError):
            raise ValueError(
                f"scenario ref {ref!r}: want {kind}:<k> with k in "
                f"{sorted(table)}"
            ) from None
        # A main-body entry is a whole config excerpt: its issue and
        # opinions sit under "scenario" (the JAX registry reads them at the
        # top level and raises KeyError for every main_body ref).
        scenario = scenario.get("scenario", scenario)
        return {
            "id": f"{kind}-{key}",
            "family": kind,
            "issue": scenario["issue"],
            "agent_opinions": dict(scenario["agent_opinions"]),
            "n_agents": len(scenario["agent_opinions"]),
        }
    if kind == "corpus":
        name, _, scenario_id = rest.partition(":")
        if not name:
            raise ValueError(
                f"scenario ref {ref!r}: want corpus:<name>[:<id>]")
        corpus = get_corpus(name)
        if scenario_id:
            record = corpus.get(scenario_id)
        else:
            record = min(corpus.scenarios, key=lambda s: s["id"])
        return dict(record)
    raise ValueError(
        f"scenario ref {ref!r}: want aamas:<k>, main_body:<k>, or "
        f"corpus:<name>[:<id>]"
    )


def maybe_resolve_scenario(
    scenario: Union[str, Dict[str, Any], None]
) -> Optional[Dict[str, Any]]:
    """Config-layer helper: a string is a ref; a dict with a ``ref`` key
    resolves the ref then lets the remaining keys override (so a config
    can pin ``issue`` wording over a corpus scenario); any other dict
    passes through untouched."""
    if scenario is None:
        return None
    if isinstance(scenario, str):
        return resolve_scenario_ref(scenario)
    if isinstance(scenario, dict) and "ref" in scenario:
        resolved = resolve_scenario_ref(scenario["ref"])
        overrides = {k: v for k, v in scenario.items() if k != "ref"}
        resolved.update(overrides)
        return resolved
    return dict(scenario) if isinstance(scenario, dict) else scenario

"""Versioned on-disk scenario corpus: JSONL + content-hashed manifest (a
copy of ``consensus_tpu/data/scenarios/corpus.py``).

Layout of a corpus directory (``data/scenarios_v2/`` in the repo):

* ``scenarios.jsonl`` — one canonical-JSON scenario record per line
  (sorted keys, compact separators, ASCII-escaped), in the generator's
  canonical order.  Canonical serialisation is what makes "same seed +
  version → byte-identical regeneration" a file-level property rather
  than a semantic one.
* ``manifest.json``   — the :class:`~.generator.CorpusSpec` that produced
  the file, a ``sha256:`` content hash of the JSONL bytes, and per-family
  profile statistics (bloc sizes, sybil multiplicity, holdout counts)
  recomputed by the determinism tests.

:func:`load_corpus` verifies the hash on load by default, so a corrupted
or hand-edited corpus fails loudly instead of silently skewing welfare
goldens or bench numbers.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import random
from typing import Any, Dict, List, Optional, Tuple, Union

from consensus_tpu_torch.data.scenarios.generator import (
    GENERATOR_VERSION,
    SCENARIO_SCHEMA,
    CorpusSpec,
    generate_scenarios,
)

MANIFEST_SCHEMA = "consensus_tpu.scenario_corpus.v1"

SCENARIOS_FILENAME = "scenarios.jsonl"
MANIFEST_FILENAME = "manifest.json"


def scenario_line(record: Dict[str, Any]) -> str:
    """Canonical one-line JSON for a scenario record."""
    return json.dumps(
        record, sort_keys=True, ensure_ascii=True, separators=(",", ":")
    )


def scenarios_blob(records: List[Dict[str, Any]]) -> bytes:
    return "".join(scenario_line(r) + "\n" for r in records).encode("ascii")


def content_hash(blob: bytes) -> str:
    return "sha256:" + hashlib.sha256(blob).hexdigest()


def family_stats(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, int]]:
    """Per-family aggregates the manifest pins and the tests recompute."""
    stats: Dict[str, Dict[str, int]] = {}
    for record in records:
        fam = stats.setdefault(record["family"], {
            "count": 0, "agents_total": 0, "bloc_sizes_total": 0,
            "majority_bloc_total": 0, "holdouts_total": 0,
            "sybil_multiplicity_total": 0, "paraphrase_clusters_total": 0,
        })
        profile = record.get("profile", {})
        fam["count"] += 1
        fam["agents_total"] += int(record["n_agents"])
        blocs = profile.get("bloc_sizes")
        if blocs:
            fam["bloc_sizes_total"] += sum(int(b) for b in blocs)
            fam["majority_bloc_total"] += max(int(b) for b in blocs)
        fam["holdouts_total"] += int(profile.get("holdouts", 0))
        fam["sybil_multiplicity_total"] += int(
            profile.get("sybil_multiplicity", 0))
        clusters = profile.get("paraphrase_clusters")
        if clusters:
            fam["paraphrase_clusters_total"] += len(clusters)
    return stats


def build_manifest(
    spec: CorpusSpec, records: List[Dict[str, Any]], blob: bytes
) -> Dict[str, Any]:
    agents = [int(r["n_agents"]) for r in records]
    return {
        "schema": MANIFEST_SCHEMA,
        "version": spec.version,
        "generator_version": GENERATOR_VERSION,
        "spec": spec.to_dict(),
        "n_scenarios": len(records),
        "content_hash": content_hash(blob),
        "families": family_stats(records),
        "agents": {
            "min": min(agents) if agents else 0,
            "max": max(agents) if agents else 0,
            "total": sum(agents),
        },
    }


def write_corpus(
    out_dir: Union[str, pathlib.Path], spec: CorpusSpec
) -> Dict[str, Any]:
    """Generate ``spec`` into ``out_dir`` (atomic writes); -> manifest."""
    from consensus_tpu_torch.utils.io_atomic import atomic_write_bytes

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    records = generate_scenarios(spec)
    blob = scenarios_blob(records)
    manifest = build_manifest(spec, records, blob)
    atomic_write_bytes(out / SCENARIOS_FILENAME, blob)
    atomic_write_bytes(
        out / MANIFEST_FILENAME,
        (json.dumps(manifest, sort_keys=True, indent=2) + "\n").encode(
            "ascii"),
    )
    return manifest


class CorpusIntegrityError(ValueError):
    """The on-disk corpus does not match its manifest."""


class Corpus:
    """A loaded scenario corpus: records + manifest + deterministic
    request-sequence sampling for the load generator."""

    def __init__(
        self,
        root: pathlib.Path,
        manifest: Dict[str, Any],
        scenarios: List[Dict[str, Any]],
    ):
        self.root = root
        self.manifest = manifest
        self.scenarios = scenarios
        self.by_id: Dict[str, Dict[str, Any]] = {
            s["id"]: s for s in scenarios
        }
        self.by_family: Dict[str, List[Dict[str, Any]]] = {}
        for s in scenarios:
            self.by_family.setdefault(s["family"], []).append(s)

    @property
    def version(self) -> str:
        return str(self.manifest.get("version", ""))

    @property
    def name(self) -> str:
        return self.root.name

    def get(self, scenario_id: str) -> Dict[str, Any]:
        try:
            return self.by_id[scenario_id]
        except KeyError:
            raise KeyError(
                f"scenario {scenario_id!r} not in corpus {self.name} "
                f"({len(self.by_id)} scenarios)"
            ) from None

    def sample_sequence(
        self,
        count: int,
        mix: Optional[Union[str, Dict[str, float]]] = None,
        base_seed: int = 0,
    ) -> List[Dict[str, Any]]:
        """``count`` scenario records, deterministically assigned.

        ``mix=None`` round-robins the whole corpus in id order (every
        scenario gets load; no family over-weighted).  A mix —
        ``"polarized=2,sybil=1"`` or ``{"polarized": 2, "sybil": 1}`` —
        draws a family per request with those weights (seeded by
        ``base_seed``) and round-robins *within* the family, so the same
        (corpus, mix, count, base_seed) always produces the same
        per-request assignment.
        """
        ordered = sorted(self.scenarios, key=lambda s: s["id"])
        if not ordered:
            raise ValueError(f"corpus {self.name} is empty")
        if mix is None:
            return [ordered[i % len(ordered)] for i in range(count)]
        weights = parse_family_mix(mix)
        unknown = sorted(set(weights) - set(self.by_family))
        if unknown:
            raise ValueError(
                f"mix families {unknown} not in corpus {self.name}; "
                f"have {sorted(self.by_family)}"
            )
        families = sorted(weights)
        rng = random.Random(base_seed)
        cursors = {fam: 0 for fam in families}
        out = []
        for _ in range(count):
            fam = rng.choices(
                families, weights=[weights[f] for f in families], k=1)[0]
            pool = sorted(self.by_family[fam], key=lambda s: s["id"])
            out.append(pool[cursors[fam] % len(pool)])
            cursors[fam] += 1
        return out

    def verify(self) -> None:
        """Recompute the content hash + per-family stats against the
        manifest; raise :class:`CorpusIntegrityError` on any mismatch."""
        blob = scenarios_blob(self.scenarios)
        expect = self.manifest.get("content_hash")
        actual = content_hash(blob)
        if actual != expect:
            raise CorpusIntegrityError(
                f"{self.name}: content hash mismatch "
                f"(manifest {expect}, file {actual})"
            )
        if family_stats(self.scenarios) != self.manifest.get("families"):
            raise CorpusIntegrityError(
                f"{self.name}: per-family stats do not match the manifest"
            )
        if len(self.scenarios) != self.manifest.get("n_scenarios"):
            raise CorpusIntegrityError(
                f"{self.name}: scenario count != manifest n_scenarios"
            )


def parse_family_mix(
    mix: Union[str, Dict[str, float]]
) -> Dict[str, float]:
    """``"polarized=2,sybil=1"`` -> ``{"polarized": 2.0, "sybil": 1.0}``."""
    if isinstance(mix, dict):
        weights = {str(k): float(v) for k, v in mix.items()}
    else:
        weights = {}
        for item in str(mix).split(","):
            item = item.strip()
            if not item:
                continue
            fam, sep, weight = item.partition("=")
            if not sep:
                raise ValueError(
                    f"family mix item must be FAMILY=WEIGHT, got {item!r}")
            weights[fam.strip()] = float(weight)
    if not weights:
        raise ValueError(f"empty family mix {mix!r}")
    bad = sorted(k for k, v in weights.items() if v <= 0)
    if bad:
        raise ValueError(f"family mix weights must be positive: {bad}")
    return weights


def load_corpus(
    path: Union[str, pathlib.Path], verify: bool = True
) -> Corpus:
    """Load (and by default integrity-check) a corpus directory."""
    root = pathlib.Path(path)
    manifest_path = root / MANIFEST_FILENAME
    jsonl_path = root / SCENARIOS_FILENAME
    if not manifest_path.is_file() or not jsonl_path.is_file():
        raise FileNotFoundError(
            f"{root} is not a corpus directory (need {MANIFEST_FILENAME} "
            f"and {SCENARIOS_FILENAME})"
        )
    manifest = json.loads(manifest_path.read_text())
    if manifest.get("schema") != MANIFEST_SCHEMA:
        raise CorpusIntegrityError(
            f"{root}: manifest schema {manifest.get('schema')!r} != "
            f"{MANIFEST_SCHEMA!r}"
        )
    scenarios: List[Dict[str, Any]] = []
    for lineno, line in enumerate(
        jsonl_path.read_text().splitlines(), start=1
    ):
        if not line.strip():
            continue
        record = json.loads(line)
        if record.get("schema") != SCENARIO_SCHEMA:
            raise CorpusIntegrityError(
                f"{jsonl_path}:{lineno}: scenario schema "
                f"{record.get('schema')!r} != {SCENARIO_SCHEMA!r}"
            )
        scenarios.append(record)
    corpus = Corpus(root, manifest, scenarios)
    if verify:
        corpus.verify()
    return corpus


def regenerate_check(
    path: Union[str, pathlib.Path]
) -> Tuple[bool, str]:
    """Regenerate the corpus at ``path`` from its own manifest spec and
    byte-compare — the determinism proof ``gen_corpus --check`` runs in
    CI.  -> (ok, human-readable detail)."""
    root = pathlib.Path(path)
    corpus = load_corpus(root)
    gen_version = corpus.manifest.get("generator_version")
    if gen_version != GENERATOR_VERSION:
        return False, (
            f"generator_version {gen_version} != code {GENERATOR_VERSION}; "
            "this corpus cannot be regenerated by this code"
        )
    spec = CorpusSpec.from_dict(corpus.manifest["spec"])
    blob = scenarios_blob(generate_scenarios(spec))
    disk = (root / SCENARIOS_FILENAME).read_bytes()
    if blob != disk:
        return False, (
            f"regenerated JSONL differs from disk "
            f"({content_hash(blob)} vs {content_hash(disk)})"
        )
    return True, (
        f"{root}: byte-identical regeneration, {len(corpus.scenarios)} "
        f"scenarios, {corpus.manifest['content_hash']}"
    )

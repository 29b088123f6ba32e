"""Generate / validate a scenario corpus (PyTorch port of
``consensus_tpu/cli/gen_corpus.py``, over the port's ``data/scenarios``).

Examples::

    # Prove the repo's committed corpus regenerates byte-identically from
    # its own manifest (the determinism gate):
    python -m consensus_tpu_torch.cli.gen_corpus --check data/scenarios_v2

    # A tiny throwaway corpus for smoke tests:
    python -m consensus_tpu_torch.cli.gen_corpus --out /tmp/ci_corpus \\
        --per-family 2 --max-agents 8 --no-big --seed 7

``--out`` refuses the repo's committed corpora (``data/scenarios_*``):
they belong to the JAX package, which writes them; the port only checks
them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from consensus_tpu_torch.data.scenarios import (
    FAMILIES,
    CorpusSpec,
    load_corpus,
    regenerate_check,
    write_corpus,
)


#: The repo's data directory, which holds the committed corpora.
_DATA_DIR = pathlib.Path(__file__).resolve().parents[2] / "data"


def _is_committed_corpus(out: str) -> bool:
    target = pathlib.Path(out).resolve()
    return target.parent == _DATA_DIR.resolve() and target.name.startswith("scenarios_")


def build_spec(args: argparse.Namespace) -> CorpusSpec:
    ladder = tuple(
        n for n in CorpusSpec().agent_ladder if n <= args.max_agents
    ) or (args.max_agents,)
    return CorpusSpec(
        version=args.version,
        seed=args.seed,
        per_family=args.per_family,
        families=tuple(sorted(args.families)),
        agent_ladder=ladder,
        include_big=args.big,
        big_agents=args.big_agents,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, metavar="DIR",
                        help="write the corpus (scenarios.jsonl + "
                             "manifest.json) into DIR")
    parser.add_argument("--check", default=None, metavar="DIR",
                        help="load DIR, verify manifest hash + schema, "
                             "and prove byte-identical regeneration from "
                             "the manifest's own spec (exit 1 on any "
                             "mismatch)")
    parser.add_argument("--version", default="v2")
    parser.add_argument("--seed", type=int, default=CorpusSpec().seed)
    parser.add_argument("--per-family", type=int,
                        default=CorpusSpec().per_family)
    parser.add_argument("--families", nargs="+", default=list(FAMILIES),
                        choices=list(FAMILIES), metavar="FAMILY",
                        help=f"subset of {', '.join(FAMILIES)}")
    parser.add_argument("--max-agents", type=int, default=64,
                        help="truncate the agent-count ladder here "
                             "(the 500-agent headline scenario is "
                             "separate; see --no-big)")
    parser.add_argument("--big", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="include the big polarized headline scenario "
                             "(--no-big for tiny CI corpora)")
    parser.add_argument("--big-agents", type=int,
                        default=CorpusSpec().big_agents)
    args = parser.parse_args(argv)
    if bool(args.out) == bool(args.check):
        parser.error("exactly one of --out / --check is required")

    if args.out and _is_committed_corpus(args.out):
        parser.error(f"--out {args.out} is a committed corpus of the repo; "
                     "check it with --check, write elsewhere")

    if args.check:
        ok, detail = regenerate_check(args.check)
        print(detail)
        if not ok:
            return 1
        # regenerate_check verified the JSONL bytes; verify() (hash +
        # stats + count) ran inside load_corpus.  Round-trip the schema
        # explicitly so --check is the one-stop CI validation.
        corpus = load_corpus(args.check)
        print(f"schema round-trip OK: {len(corpus.scenarios)} scenarios, "
              f"families {sorted(corpus.by_family)}")
        return 0

    manifest = write_corpus(args.out, build_spec(args))
    print(json.dumps(
        {k: manifest[k] for k in
         ("version", "n_scenarios", "content_hash", "agents")},
        indent=2, sort_keys=True,
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's small tools against the JAX package's: ``utils/diff.py``,
``utils/mfu.py``, ``cli/gen_corpus.py`` and ``cli/parity_report.py``.

Every comparison is exact: the tools are host Python over the same inputs.
``mfu`` differs in one number only, the default peak (the H100 SXM's dense
bf16 989.4 TFLOP/s against the TPU v5e's 197).  ``gen_corpus --check``
regenerates the repo's committed ``data/scenarios_v2`` byte for byte and a
tiny corpus written by both packages is byte-equal; ``parity_report
--backend fake`` writes the JAX report, timings aside.
"""

import json
import pathlib

import pytest

from consensus_tpu.backends.base import GenerationResult as JaxGenerationResult
from consensus_tpu.cli import gen_corpus as jax_gen_corpus
from consensus_tpu.cli import parity_report as jax_parity_report
from consensus_tpu.models.config import get_model_config as jax_model_config
from consensus_tpu.utils import diff as jax_diff
from consensus_tpu.utils import mfu as jax_mfu
from consensus_tpu_torch.backends.base import GenerationResult
from consensus_tpu_torch.cli import gen_corpus, parity_report
from consensus_tpu_torch.models.config import get_model_config
from consensus_tpu_torch.utils import diff, mfu

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "data" / "scenarios_v2"

SEQUENCES = [
    ((1, 2, 3), (1, 2, 3)),
    ((1, 2, 3), (1, 9, 3)),
    ((1, 2), (1, 2, 3, 4)),
    ((), (5,)),
    (list("abcdefghij"), list("abcdefgXij")),
    (tuple(range(20)), tuple(range(10)) + (99,) + tuple(range(11, 20))),
]
STATEMENTS = [
    (["The city should build lanes.", "Same"], ["The city should build lanes.", "Same"]),
    (["The city should build lanes."], ["The town should build lanes."]),
    (["a b c", "x"], ["a b c"]),
    (["  leading   spaces kept", ""], ["  leading spaces kept", "now text"]),
]


@pytest.mark.parametrize("a, b", SEQUENCES)
@pytest.mark.parametrize("context", [0, 1, 3])
def test_token_diff_equals_jax(a, b, context):
    assert diff.first_divergence(a, b) == jax_diff.first_divergence(a, b)
    assert diff.token_diff_message(a, b, "port", "jax", context) == jax_diff.token_diff_message(
        a, b, "port", "jax", context)


@pytest.mark.parametrize("a, b", STATEMENTS)
def test_statement_report_equals_jax(a, b):
    assert diff.statement_parity_report(a, b, "x", "y") == jax_diff.statement_parity_report(
        a, b, "x", "y")


@pytest.mark.parametrize("a, b", STATEMENTS)
def test_generation_report_equals_jax(a, b):
    def results(cls, texts, ids):
        return [cls(text=t, token_ids=tuple(i)) for t, i in zip(texts, ids)]

    ids_a = [[ord(c) for c in t] for t in a]
    ids_b = [[ord(c) for c in t] for t in b]
    for with_ids in (True, False):
        ia = ids_a if with_ids else [[] for _ in a]
        ib = ids_b if with_ids else [[] for _ in b]
        got = diff.generation_parity_report(results(GenerationResult, a, ia),
                                            results(GenerationResult, b, ib))
        expect = jax_diff.generation_parity_report(results(JaxGenerationResult, a, ia),
                                                   results(JaxGenerationResult, b, ib))
        assert got == expect


@pytest.mark.parametrize("model", ["tiny-gemma2", "tiny-llama3", "gemma2-2b", "gemma2-9b",
                                   "llama3-8b"])
def test_mfu_equals_jax_but_the_peak(model):
    n = mfu.param_count(get_model_config(model))
    assert n == jax_mfu.param_count(jax_model_config(model)) > 0
    for tokens, wall in ((128, 1.5), (1, 0.0), (4096, 12.25)):
        tflops = mfu.useful_tflops_per_sec(n, tokens, wall)
        assert tflops == jax_mfu.useful_tflops_per_sec(n, tokens, wall)
        for devices in (1, 4):
            assert mfu.pct_of_peak(tflops, peak=197.0, n_devices=devices) == jax_mfu.pct_of_peak(
                tflops, n_devices=devices)
    assert mfu.H100_SXM_BF16_PEAK_TFLOPS == 989.4
    assert mfu.pct_of_peak(989.4) == 100.0 and mfu.pct_of_peak(989.4, n_devices=4) == 25.0


def test_gen_corpus_checks_the_committed_corpus(capsys):
    before = {p.name: p.read_bytes() for p in CORPUS.iterdir()}
    assert gen_corpus.main(["--check", str(CORPUS)]) == 0
    out = capsys.readouterr().out
    assert "byte-identical regeneration" in out and "schema round-trip OK" in out
    assert {p.name: p.read_bytes() for p in CORPUS.iterdir()} == before


def test_gen_corpus_never_writes_the_committed_corpus(capsys):
    before = {p.name: p.read_bytes() for p in CORPUS.iterdir()}
    with pytest.raises(SystemExit) as exit_:
        gen_corpus.main(["--out", str(CORPUS), "--per-family", "1"])
    assert exit_.value.code == 2
    assert "committed corpus" in capsys.readouterr().err
    assert {p.name: p.read_bytes() for p in CORPUS.iterdir()} == before


@pytest.mark.parametrize("args", [
    ["--per-family", "2", "--max-agents", "8", "--no-big", "--seed", "7"],
    ["--per-family", "1", "--max-agents", "4", "--no-big", "--families", "polarized", "sybil"],
])
def test_gen_corpus_tiny_corpus_equals_jax(tmp_path, capsys, args):
    assert gen_corpus.main(["--out", str(tmp_path / "port"), *args]) == 0
    port_out = capsys.readouterr().out
    assert jax_gen_corpus.main(["--out", str(tmp_path / "jax"), *args]) == 0
    assert capsys.readouterr().out == port_out
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "manifest.json", "scenarios.jsonl"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert gen_corpus.main(["--check", str(tmp_path / "port")]) == 0


def test_baseline_copy_is_byte_equal():
    ours = ROOT / "consensus_tpu_torch" / "data" / "aamas_baseline.json"
    theirs = ROOT / "consensus_tpu" / "data" / "aamas_baseline.json"
    assert ours.read_bytes() == theirs.read_bytes()
    assert parity_report.load_baseline() == jax_parity_report.load_baseline()


def _report(module, out, capsys, *extra):
    assert module.main(["--backend", "fake", "--output", str(out), *extra]) == 0
    markdown = capsys.readouterr().out
    report = json.loads(next(out.glob("parity_report_*.json")).read_text())
    for cell in report["cells"]:
        cell.pop("scoring_time_s")
    return report, markdown


@pytest.mark.parametrize("extra", [[], ["--scenario", "1", "3", "--sweep", "beam_search"]])
def test_parity_report_fake_equals_jax(tmp_path, capsys, extra):
    port, port_md = _report(parity_report, tmp_path / "port", capsys, *extra)
    ref, ref_md = _report(jax_parity_report, tmp_path / "jax", capsys, *extra)
    assert port == ref
    assert port["n_cells"] > 0 and port["weights"] == "fake"
    table = [line for line in port_md.splitlines() if line.startswith("|")]
    assert table == [line for line in ref_md.splitlines() if line.startswith("|")]


@pytest.mark.parametrize("backend", ["torch", "tpu"])
def test_parity_report_builds_the_resident_backend(monkeypatch, backend):
    """``--backend torch`` (``tpu`` its alias) builds ``TorchBackend`` with
    ``--checkpoint``, ``--tokenizer``, ``--device`` and ``--model``."""
    built = {}

    class Stop(Exception):
        pass

    def fake_backend(**kwargs):
        built.update(kwargs)
        raise Stop

    monkeypatch.setattr("consensus_tpu_torch.backends.torch_backend.TorchBackend", fake_backend)
    with pytest.raises(Stop):
        parity_report.main(["--backend", backend, "--model", "tiny-llama3", "--checkpoint",
                            "ckpt", "--tokenizer", "tok", "--device", "cpu"])
    assert built == {"model": "tiny-llama3", "checkpoint": "ckpt", "tokenizer": "tok",
                     "max_context": 2048, "device": "cpu"}

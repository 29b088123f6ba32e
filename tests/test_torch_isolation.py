"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "consensus_tpu_torch"


def _modules():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_import_leaves_jax_out_of_sys_modules():
    # A fresh interpreter: this test process already imported jax (conftest).
    code = (
        "import importlib, sys\n"
        f"names = {_modules()!r}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'consensus_tpu' or m.startswith('consensus_tpu.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax\b|jaxlib\b|consensus_tpu(?:\.|\s|$))", re.MULTILINE
)


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_sources_import_nothing_of_jax(path):
    assert not _FORBIDDEN.findall(path.read_text()), path


def test_parallel_package_is_covered():
    """The data-parallel mesh modules are among those imported above."""
    names = _modules()
    for name in ("consensus_tpu_torch.parallel", "consensus_tpu_torch.parallel.mesh",
                 "consensus_tpu_torch.parallel.ring_attention",
                 "consensus_tpu_torch.parallel.train", "consensus_tpu_torch.cli.bench_mesh"):
        assert name in names

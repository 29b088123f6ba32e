"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.  The build happens at first use,
from the sources in this checkout only, into ``consensus_tpu_torch/_build/``
(listed in ``.gitignore``); the library's file name carries a hash of its
source, of every shared header ``csrc/*.cuh`` and of the flags, so an edited
source or header never loads a stale build.  Sources include their headers
through ``-I csrc``, so a copy compiled elsewhere (``chip_smoke.py``'s
mutant builds) finds them too.  Nothing is compiled when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
)

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(str(pathlib.Path(root) / "bin" / "nvcc"))
    for path in candidates:
        if path and pathlib.Path(path).exists():
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use"
    )


def nvcc_args(source: pathlib.Path, target: pathlib.Path) -> list:
    """nvcc's arguments (after the program) to build ``source`` into
    ``target``."""
    return [*NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(target), str(source)]


def compile_library(source: pathlib.Path, target: pathlib.Path) -> str:
    """nvcc ``source`` into the shared library ``target``; returns what
    nvcc and ptxas printed (registers, shared memory, spills).  Raises with
    that output if the build fails."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *nvcc_args(source, tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exited {proc.returncode} on {source}:\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.blake2b(digest_size=8)
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns nvcc's output ("" when nothing was compiled)."""
    target = library_path(name)
    if target.exists():
        return ""
    return compile_library(CSRC_DIR / f"{name}.cu", target)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libraries[name] = lib
        return lib

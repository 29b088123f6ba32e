"""Evaluation embedder: dedicated encoder when available, LM-pool fallback
(PyTorch port of ``consensus_tpu/embedding.py``).

The original method embeds statements and opinions with a DEDICATED
encoder (``BAAI/bge-large-en-v1.5``), while the default here is the
generation LM's masked mean-pooled final hidden states
(``TorchBackend.embed``, as ``TPUBackend.embed``).  The two are different
embedding spaces, so cosine-family welfare under the LM-pool fallback is
not comparable with the encoder's numbers.

With a local sentence-transformers model directory, pass it as
``embedding_model_path`` in the evaluation config (or the ``EVAL_EMBEDDER``
environment variable) and evaluation runs it instead.  The package is
imported only then; without it, or without the directory, this raises as
the JAX package does.
"""

from __future__ import annotations

import os
import pathlib
from typing import Optional, Protocol, Sequence

import numpy as np


class Embedder(Protocol):
    name: str

    def embed(self, texts: Sequence[str]) -> np.ndarray: ...


class LMPoolEmbedder:
    """Backend-provided embeddings (masked mean-pool, unit-norm)."""

    def __init__(self, backend):
        self._backend = backend
        self.name = f"lm-pool:{getattr(backend, 'model_name', backend.name)}"

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        return self._backend.embed(list(texts))


class SentenceTransformerEmbedder:
    """A local sentence-transformers model (reference semantics when the
    model is bge-large-en-v1.5)."""

    def __init__(self, path: str, device: str = "cpu"):
        from sentence_transformers import SentenceTransformer

        self._model = SentenceTransformer(str(path), device=device)
        self.name = f"sentence-transformers:{pathlib.Path(path).name}"

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        vectors = self._model.encode(
            list(texts), normalize_embeddings=True, convert_to_numpy=True
        )
        return np.asarray(vectors, dtype=np.float32)


def get_embedder(spec: Optional[str], backend) -> Embedder:
    """``None``/"lm" -> LM-pool over the backend; a directory path -> local
    sentence-transformers model.  ``EVAL_EMBEDDER`` env overrides None."""
    if spec is None:
        spec = os.environ.get("EVAL_EMBEDDER") or None
    if spec is None or spec == "lm":
        return LMPoolEmbedder(backend)
    if not pathlib.Path(spec).is_dir():
        raise ValueError(
            f"embedding model path {spec!r} is not a directory (expected a "
            "local sentence-transformers model dir, e.g. bge-large-en-v1.5)"
        )
    return SentenceTransformerEmbedder(spec)

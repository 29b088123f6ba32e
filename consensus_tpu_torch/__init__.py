"""PyTorch / CUDA port of ``consensus_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``consensus_tpu`` stays the reference; this package mirrors
its layout (``models/``, ``ops/``, ``backends/``, ``methods/``, ``cli/``)
and imports nothing of it, nor JAX.  Its hand-written CUDA kernels live in
``csrc/`` and are built with ``nvcc`` at first use (``ops/build.py``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

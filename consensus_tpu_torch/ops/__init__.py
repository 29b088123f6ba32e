"""Kernels (``flash_attention``, built from ``csrc/``) and welfare rules."""

"""Model runtime: configs, int8 quantization, transformer, sampling,
generation, tokenizers and the JAX-weight converter."""

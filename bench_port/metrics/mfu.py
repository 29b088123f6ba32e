"""mfu: useful model FLOP/s over the card's bf16 peak, in %.

Layer: Model (``models/transformer.py``, ``generate.py``, ``stepper.py``,
``quant.py``, ``sampling.py``).  Useful FLOPs = 2 x parameters x (generated
+ scored tokens, ``TorchBackend.token_counts`` diffed over the window); the
time is the whole window.  A copy of ``consensus_tpu_torch/utils/mfu.py``'s
arithmetic: prompt prefill, padding, attention and host time all count as
lost, so it is a lower bound of the step's share of the peak.  Against
989.4 TFLOP/s, the dense bf16 peak of an H100 SXM (NVIDIA's data sheet);
the card's power limit is printed beside each run.  Moves
``statements_per_s``.
"""

PEAK_FLOPS = 989.4e12


def param_count(model) -> int:
    """Logical parameters of a configuration (quantization-agnostic)."""
    attn = model["d_model"] * model["n_heads"] * model["head_dim"] * 2
    attn += model["d_model"] * model["n_kv_heads"] * model["head_dim"] * 2
    ffn = 3 * model["d_model"] * model["ffn_hidden"]
    norms = (4 if model["use_post_norms"] else 2) * model["d_model"]
    total = model["n_layers"] * (attn + ffn + norms) + model["vocab_size"] * model["d_model"]
    total += model["d_model"]
    if not model["tie_lm_head"]:
        total += model["vocab_size"] * model["d_model"]
    return int(total)


def read(window):
    tokens = window.token_counts.get("generated", 0) + window.token_counts.get("scored", 0)
    if not tokens or window.seconds <= 0:
        return None
    flops = 2.0 * param_count(window.config["model"]) * tokens
    return 100.0 * flops / window.seconds / PEAK_FLOPS

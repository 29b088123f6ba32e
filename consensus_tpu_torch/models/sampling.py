"""Token sampling: temperature / top-k / top-p / logit bias / repetition
penalty, batched (PyTorch port of ``consensus_tpu/models/sampling.py``).

A draw is ``argmax(logits / temperature + gumbel)``, the form
``jax.random.categorical`` takes.  The Gumbel noise comes from one
``torch.Generator`` per row -- a row's draw then depends only on its own
generator, whatever else shares the batch -- or from an explicit ``noise``
tensor, so tests can hand the JAX and the torch sampler the same numbers.
The generators do not reproduce JAX's threefry bits (ROADMAP queue A3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < threshold, -torch.inf)


def _top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cumulative = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # Keep tokens until the cumulative probability exceeds p (always the first).
    keep = torch.roll(cumulative < p, 1, dims=-1)
    keep[..., 0] = True
    threshold = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, torch.inf))
    threshold = threshold.amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < threshold, -torch.inf)


def apply_repetition_penalty(
    logits: torch.Tensor,  # (B, V) float32
    presence: torch.Tensor,  # (B, V) bool
    penalty: torch.Tensor | float,  # (B,) or scalar, 1.0 = no-op
) -> torch.Tensor:
    """HF-style repetition penalty: seen tokens' positive logits divide by
    the penalty, negative ones multiply by it."""
    penalty = torch.as_tensor(penalty, dtype=torch.float32, device=logits.device)
    if penalty.dim() == 1:
        penalty = penalty[:, None]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def gumbel_noise(
    shape: Sequence[int],
    generators: Sequence[torch.Generator],
    device: torch.device | str,
) -> torch.Tensor:
    """(B, V) standard Gumbel noise, row ``i`` drawn from ``generators[i]``."""
    rows, vocab = shape
    if len(generators) != rows:
        raise ValueError(f"{len(generators)} generators for {rows} rows")
    tiny = torch.finfo(torch.float32).tiny
    uniform = torch.stack(
        [
            torch.rand(vocab, generator=g, device=device, dtype=torch.float32)
            for g in generators
        ]
    ).clamp_(min=tiny)
    return -torch.log(-torch.log(uniform))


def sample_tokens(
    logits: torch.Tensor,  # (B, V)
    temperature: float | torch.Tensor = 1.0,  # scalar or (B,)
    top_k: int = 0,
    top_p: float = 1.0,
    logit_bias: Optional[torch.Tensor] = None,  # (V,) or (B, V) additive
    presence: Optional[torch.Tensor] = None,  # (B, V) bool seen-token mask
    rep_penalty: Optional[torch.Tensor] = None,  # (B,)
    generators: Optional[Sequence[torch.Generator]] = None,
    noise: Optional[torch.Tensor] = None,  # (B, V) Gumbel noise
) -> torch.Tensor:
    """One token id per row (int32); temperature <= 0 means greedy argmax.

    Noise is drawn (from ``generators``) only when some row samples; a batch
    that is greedy throughout needs neither ``generators`` nor ``noise``."""
    logits = logits.to(torch.float32)
    if presence is not None and rep_penalty is not None:
        logits = apply_repetition_penalty(logits, presence, rep_penalty)
    if logit_bias is not None:
        logits = logits + logit_bias

    greedy = torch.argmax(logits, dim=-1)
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    if temp.dim() == 1:
        temp = temp[:, None]
    use_greedy = (temp <= 0.0).reshape(-1)
    if bool(use_greedy.all()):
        return greedy.to(torch.int32)

    filtered = _top_p_filter(_top_k_filter(logits, top_k), top_p)
    scaled = filtered / torch.clamp(temp, min=1e-6)
    if noise is None:
        if generators is None:
            raise ValueError("sampling at temperature > 0 needs generators or noise")
        noise = gumbel_noise(scaled.shape, generators, logits.device)
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(use_greedy, greedy, sampled).to(torch.int32)

"""The row buckets' prefill-logit bytes count the query heads one card holds.

A tp rank holds ``local_config(config, tp).n_heads`` query heads; where tp
cuts a head, every rank that owns part of it holds a whole copy.  A card
that holds several ranks of a group (tp over one card repeated) holds the
heads of each.  ``TorchBackend``'s row buckets for a monolithic decode
(``_generate_rows_allowed``), a segmented one (``_segmented_rows_allowed``)
and the shared-context scoring chunk (``_shared_score_rows_cap``) count
those heads' fp32 logits.  At gemma2-2b tp=16 on one card that is 16
heads, twice the model's 8; where tp divides the heads (llama3-8b tp=2 and
tp=4, gemma2-2b tp=8) it is the model's count, and nothing moves.

The backend's row-bucket state is built alone (no weights): a bf16 dtype,
the per-card head counts of the group, and a fixed device budget."""

import pytest
import torch

from consensus_tpu_torch.backends import torch_backend as tb
from consensus_tpu_torch.backends.torch_backend import TorchBackend
from consensus_tpu_torch.models.config import get_model_config

BUDGET = 40 * 1024**3
PROMPT, MAX_NEW, SEG = 4096, 256, 128


def _sized(model, group):
    backend = TorchBackend.__new__(TorchBackend)
    backend.config = get_model_config(model)
    backend.params = {"embed": torch.empty(0, dtype=torch.bfloat16)}
    backend._kv_heads_per_card = tb._kv_heads_per_card(backend.config, group)
    backend._q_heads_per_card = tb._q_heads_per_card(backend.config, group)
    backend._shards = None
    backend._device_budget = BUDGET
    backend._session_budget = tb._session_budget_for(BUDGET)
    backend._card_share = 1
    backend.kv_quant = False
    backend.max_batch_rows = 32
    return backend


def _one_card(tp):
    return [torch.device("cuda", 0)] * tp


def _row_bytes(backend, method, *args):
    """The per-row bytes ``method`` hands to ``_rows_for``."""
    seen = []
    backend._rows_for = lambda row_bytes: seen.append(row_bytes) or 1
    method(backend, *args)
    del backend._rows_for
    return seen[0]


# (model, tp, query heads one card holds / the model's n_heads)
CASES = [
    ("gemma2-2b", 16, 2),
    ("gemma2-2b", 8, 1),
    ("llama3-8b", 2, 1),
    ("llama3-8b", 4, 1),
]


@pytest.mark.parametrize("model, tp, factor", CASES)
def test_query_heads_per_card(model, tp, factor):
    config = get_model_config(model)
    assert tb._q_heads_per_card(config, _one_card(tp)) == factor * config.n_heads
    # On tp separate cards each holds one rank's heads.
    spread = [torch.device("cuda", i) for i in range(tp)]
    assert tb._q_heads_per_card(config, spread) == tb.local_config(config, tp).n_heads


@pytest.mark.parametrize("model, tp, factor", CASES)
@pytest.mark.parametrize("kind", ["monolithic", "segmented"])
def test_prefill_logit_bytes_and_rows_follow_the_heads_a_card_holds(model, tp, factor, kind):
    """The prefill logits' bytes per row are ``factor`` x the count by the
    model's ``n_heads`` (2 x at gemma2-2b tp=16 on one card, else 1 x), and
    the rows allowed are the bucket of the KV bytes plus those logits."""
    backend = _sized(model, _one_card(tp))
    n_heads = backend.config.n_heads
    if kind == "monolithic":
        method, args = TorchBackend._generate_rows_allowed, (PROMPT, MAX_NEW)
        kv_row = (PROMPT + MAX_NEW) * backend._kv_bytes_per_column()
        by_model_heads = 2 * n_heads * PROMPT * (PROMPT + MAX_NEW) * 4
    else:
        method, args = TorchBackend._segmented_rows_allowed, (PROMPT, MAX_NEW, SEG)
        kv_row = (PROMPT + MAX_NEW + 2 * SEG) * backend._kv_bytes_per_column()
        by_model_heads = 2 * n_heads * PROMPT * PROMPT * 4
    assert _row_bytes(backend, method, *args) - kv_row == factor * by_model_heads
    rows = method(backend, *args)
    assert rows == backend._rows_for(kv_row + factor * by_model_heads)
    if factor == 1:
        assert rows == backend._rows_for(kv_row + by_model_heads)
    else:
        assert rows < backend._rows_for(kv_row + by_model_heads)


@pytest.mark.parametrize("model, tp, factor", CASES)
def test_shared_score_chunk_follows_the_heads_a_card_holds(model, tp, factor):
    """A context window where 128 rows of the model's ``n_heads`` fit the
    2 GB suffix-logit cap exactly: at gemma2-2b tp=16 on one card the chunk
    halves to 64 rows, elsewhere it stays at 128."""
    backend = _sized(model, _one_card(tp))
    width = 64
    backend.max_context = tb._SHARED_SCORE_ATTN_BYTES_CAP // (
        128 * backend.config.n_heads * width * 4
    ) - width
    rows, attn_bytes = backend._shared_score_rows_cap(width)
    assert rows == 128 // factor
    assert attn_bytes == rows * factor * backend.config.n_heads * width * (
        backend.max_context + width) * 4 <= tb._SHARED_SCORE_ATTN_BYTES_CAP

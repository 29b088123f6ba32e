"""The port's n-gram draft proposer against the JAX package's, on the cases
of ``tests/test_speculative.py``'s ``TestNGramProposer``: the same observed
histories give the same drafts, which are also pinned literally."""

import pytest

from consensus_tpu.backends.speculative import NGramProposer as JaxNGramProposer
from consensus_tpu_torch.backends.speculative import NGramProposer

#: (max_order, observed histories, (context, k, expected draft) queries)
CASES = {
    "replays_observed_pattern": (3, [[1, 2, 3, 4, 1, 2, 3]], [([1, 2, 3], 4, [4, 1, 2, 3])]),
    "latest_occurrence_wins": (2, [[5, 6, 7], [5, 6, 9]], [([5, 6], 1, [9])]),
    "longest_order_preferred": (
        3, [[1, 2, 3, 8], [9, 2, 3, 4]], [([1, 2, 3], 1, [8]), ([7, 2, 3], 1, [4])],
    ),
    "unseen_context_repeats_last_token": (
        3, [[1, 2]], [([40, 41], 3, [41, 41, 41]), ([], 2, [0, 0])],
    ),
    "deterministic_across_instances": (
        3, [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]], [([5, 3, 5], 6, None)],
    ),
    "zero_and_negative_k": (1, [[4, 4, 5]], [([4], 0, []), ([4], -2, [])]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_proposer_matches_jax(case):
    max_order, histories, queries = CASES[case]
    port, ref, twin = NGramProposer(max_order), JaxNGramProposer(max_order), NGramProposer(max_order)
    for history in histories:
        port.observe(history)
        ref.observe(history)
        twin.observe(history)
    for context, k, expected in queries:
        got = port.draft(context, k)
        assert got == ref.draft(context, k) == twin.draft(context, k)
        if expected is not None:
            assert got == expected

"""Social-choice helpers of the Habermas Machine: response parsing and
Schulze aggregation (copies of ``consensus_tpu/social_choice``)."""

from consensus_tpu_torch.social_choice.schulze import (  # noqa: F401
    aggregate_schulze,
    compute_pairwise_defeats,
    compute_strongest_paths,
    is_untied,
    normalize_ranking,
    rank_from_path_strengths,
    schulze_social_ranking,
    untie_with_ballot,
    validate_rankings,
)
from consensus_tpu_torch.social_choice.parsing import (  # noqa: F401
    check_arrow_format,
    check_response_format,
    extract_arrow_ranking,
    extract_statement,
    parse_arrow_ranking,
    process_ranking_response,
)

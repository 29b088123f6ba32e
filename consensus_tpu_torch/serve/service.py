"""Online consensus service: one validated request → one statement + scores
(PyTorch port of ``consensus_tpu/serve/service.py``).

The offline harness (``experiment.py``) turns a YAML config into a grid of
(seed × method × param) runs; this module is the same L4 surface folded
down to a single request so the scheduler can drive it concurrently.  A
:class:`ConsensusRequest` carries exactly what one ``Experiment`` run row
carries — issue, agent opinions, method name, per-method params, seed —
and :meth:`ConsensusService.run` produces the statement through the same
``get_method_generator`` factory, so a served statement is byte-identical
to the same (method, params, seed) run through ``Experiment`` (per-request
threefry keys make it independent of batch composition; pinned in
tests/test_torch_serve.py).

Validation reuses the config surface of ``experiment.py`` rather than
inventing a parallel schema: method names resolve through
``GENERATOR_MAP``, and params are rejected when
``Experiment.expand_param_grid`` would expand them into MORE than one run
config — list-valued params are a sweep axis, not a request.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from consensus_tpu_torch.backends.base import Backend, RequestCancelled
from consensus_tpu_torch.methods import GENERATOR_MAP, get_method_generator
from consensus_tpu_torch.methods.anytime import BudgetClock

#: Params that must be scalars of these types when present.
_PARAM_SCALARS = (str, int, float, bool)

#: Welfare metric keys surfaced in the response (subset of the evaluation
#: columns; names match evaluation.py / the reference's CSV schema).
_WELFARE_KEYS = (
    "egalitarian_welfare_cosine",
    "utilitarian_welfare_cosine",
    "log_nash_welfare_cosine",
    "egalitarian_welfare_avg_prob",
    "utilitarian_welfare_avg_prob",
    "log_nash_welfare_avg_prob",
    "egalitarian_welfare_perplexity",
    "utilitarian_welfare_perplexity",
    "log_nash_welfare_perplexity",
)


class RequestValidationError(ValueError):
    """The request payload is malformed; ``errors`` lists every problem."""

    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = list(errors)


@dataclasses.dataclass(frozen=True)
class ConsensusRequest:
    """One consensus-statement request (the unit the scheduler queues)."""

    issue: str
    agent_opinions: Dict[str, str]
    method: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 42
    #: Compute per-agent utilities + welfare for the response (two extra
    #: backend batches: one embed, one score — they merge through the same
    #: BatchingBackend as everything else).
    evaluate: bool = True
    #: Client-requested deadline in seconds (None → server default).
    timeout_s: Optional[float] = None
    request_id: str = ""
    #: Attach the span tree + critical-path debug block to the response.
    trace: bool = False


def parse_request(payload: Any) -> ConsensusRequest:
    """Validate a decoded JSON payload into a :class:`ConsensusRequest`.

    Collects EVERY problem before raising so a client gets one round trip
    of feedback, not a fix-resubmit loop per field.
    """
    errors: List[str] = []
    if not isinstance(payload, dict):
        raise RequestValidationError(
            [f"request body must be a JSON object, got {type(payload).__name__}"]
        )

    # A scenario ref replaces inline issue/opinions: the request names a
    # registry scenario (``aamas:3``, ``corpus:v2:polarized-500``) and the
    # server resolves it — same text every client, no 75 KB payloads for
    # the 500-agent scenarios.
    scenario_ref = payload.get("scenario")
    if scenario_ref is not None:
        if "issue" in payload or "agent_opinions" in payload:
            errors.append("'scenario' replaces 'issue'/'agent_opinions'; "
                          "send one or the other")
        if not isinstance(scenario_ref, str) or not scenario_ref.strip():
            errors.append("'scenario' must be a ref string like "
                          "'aamas:3' or 'corpus:v2:polarized-500'")
            scenario_ref = None

    if scenario_ref is not None:
        from consensus_tpu_torch.data.scenarios.registry import resolve_scenario_ref

        try:
            resolved = resolve_scenario_ref(scenario_ref)
            issue = resolved["issue"]
            opinions = dict(resolved["agent_opinions"])
        except (ValueError, KeyError, FileNotFoundError) as exc:
            errors.append(f"'scenario': {exc}")
            issue, opinions = "", {}
    else:
        issue = payload.get("issue")
        if not isinstance(issue, str) or not issue.strip():
            errors.append("'issue' must be a non-empty string")

        opinions = payload.get("agent_opinions")
        if not isinstance(opinions, dict) or not opinions:
            errors.append("'agent_opinions' must be a non-empty object of "
                          "{agent name: opinion text}")
            opinions = {}
        else:
            for name, text in opinions.items():
                if not isinstance(text, str) or not text.strip():
                    errors.append(f"opinion for agent {name!r} must be a "
                                  "non-empty string")

    method = payload.get("method")
    if not isinstance(method, str) or method not in GENERATOR_MAP:
        errors.append(
            f"'method' must be one of {sorted(GENERATOR_MAP)}, got {method!r}"
        )

    params = payload.get("params", {})
    if params is None:
        params = {}
    if not isinstance(params, dict):
        errors.append("'params' must be an object of per-method parameters")
        params = {}
    else:
        # Reuse the experiment config surface: list-valued params expand to
        # a Cartesian sweep there — a single online request must stay a
        # single run config.
        from consensus_tpu_torch.experiment import Experiment

        if len(Experiment.expand_param_grid(dict(params))) != 1:
            listed = sorted(k for k, v in params.items() if isinstance(v, list))
            errors.append(
                f"list-valued params {listed} define a sweep grid; submit "
                "one request per grid point (or use run_sweep offline)"
            )
        for key, value in params.items():
            if key == "seed":
                errors.append("'params.seed' conflicts with top-level 'seed'")
            elif value is not None and not isinstance(
                value, _PARAM_SCALARS + (list,)
            ):
                errors.append(
                    f"param {key!r} must be a scalar, got "
                    f"{type(value).__name__}"
                )

    seed = payload.get("seed", 42)
    if isinstance(seed, bool) or not isinstance(seed, int):
        errors.append(f"'seed' must be an integer, got {seed!r}")
        seed = 42

    evaluate = payload.get("evaluate", True)
    if not isinstance(evaluate, bool):
        errors.append("'evaluate' must be a boolean")
        evaluate = True

    timeout_s = payload.get("timeout_s")
    if timeout_s is not None:
        if isinstance(timeout_s, bool) or not isinstance(timeout_s, (int, float)):
            errors.append("'timeout_s' must be a number of seconds")
            timeout_s = None
        elif timeout_s <= 0:
            errors.append("'timeout_s' must be positive")
            timeout_s = None

    request_id = payload.get("request_id", "")
    if not isinstance(request_id, str):
        errors.append("'request_id' must be a string")
        request_id = ""

    trace = payload.get("trace", False)
    if not isinstance(trace, bool):
        errors.append("'trace' must be a boolean")
        trace = False

    unknown = sorted(
        set(payload)
        - {"issue", "agent_opinions", "scenario", "method", "params", "seed",
           "evaluate", "timeout_s", "request_id", "trace"}
    )
    if unknown:
        errors.append(f"unknown fields: {unknown}")

    if errors:
        raise RequestValidationError(errors)
    return ConsensusRequest(
        issue=issue.strip(),
        agent_opinions={str(k): str(v) for k, v in opinions.items()},
        method=method,
        params=dict(params),
        seed=int(seed),
        evaluate=evaluate,
        timeout_s=float(timeout_s) if timeout_s is not None else None,
        request_id=request_id,
        trace=trace,
    )


class ConsensusService:
    """Run one validated request through the decoder (and optionally the
    evaluator), against whichever backend the scheduler hands us — the
    per-worker handle is the shared BatchingBackend, so concurrent
    requests' generate/score/embed calls merge into wide device batches."""

    def __init__(
        self,
        backend: Backend,
        generation_model: str = "",
    ):
        self.backend = backend
        self.generation_model = generation_model

    def run(
        self,
        request: ConsensusRequest,
        backend: Optional[Backend] = None,
        budget_clock: Optional[BudgetClock] = None,
    ) -> Dict[str, Any]:
        """One request → one response dict.

        ``budget_clock`` (scheduler-injected) bounds the method's search:
        on expiry the method returns its best-so-far statement and the
        response is tagged ``degraded=true`` with ``budget_spent``
        accounting; absent a clock the method runs its full configured
        budget and the response is byte-identical to pre-anytime builds."""
        engine = backend if backend is not None else self.backend
        run_config = dict(request.params)
        run_config["seed"] = request.seed
        start = time.perf_counter()
        generator = get_method_generator(
            request.method, engine, run_config, self.generation_model
        )
        if budget_clock is not None:
            generator.budget_clock = budget_clock
        try:
            statement = generator.generate_statement(
                request.issue, request.agent_opinions
            )
        except RequestCancelled:
            # The batching layer dropped one of this request's device calls
            # (ticket cancelled before dispatch).  If a wave already
            # completed, salvage its checkpoint instead of wasting the work;
            # with nothing banked, _degrade raises BudgetExpired and the
            # scheduler reports the timeout.
            if generator.anytime is None:
                raise
            if budget_clock is not None:
                budget_clock.expired()  # latch the "cancelled" reason
            statement = generator._degrade()
        response: Dict[str, Any] = {
            "request_id": request.request_id,
            "method": request.method,
            "seed": request.seed,
            "statement": statement,
        }
        if generator.degraded:
            response["degraded"] = True
            response["degraded_reason"] = generator.degraded_reason
            response["budget_spent"] = dict(generator.budget_spent)
        if generator.pre_brushup_statement is not None and request.params.get(
            "brushup", False
        ):
            response["pre_brushup_statement"] = generator.pre_brushup_statement
        # Evaluation is skipped when the budget died mid-search (spending
        # MORE device time after the deadline defeats the early exit);
        # budget_scaled runs completed with headroom, so they still score.
        if request.evaluate and generator.degraded_reason not in (
            "deadline", "cancelled"
        ):
            try:
                response.update(self._evaluate(request, statement, engine))
            except RequestCancelled:
                response.setdefault("degraded", True)
                response.setdefault("degraded_reason", "cancelled")
                response["evaluation_skipped"] = "cancelled mid-evaluation"
        response["generation_time_s"] = round(time.perf_counter() - start, 3)
        return response

    def _evaluate(
        self, request: ConsensusRequest, statement: str, engine: Backend
    ) -> Dict[str, Any]:
        """Per-agent utilities + welfare, batched through ``engine`` so the
        evaluation calls co-merge with other in-flight requests."""
        from consensus_tpu_torch.embedding import LMPoolEmbedder
        from consensus_tpu_torch.evaluation import StatementEvaluator

        evaluator = StatementEvaluator(
            engine, embedder=LMPoolEmbedder(engine)
        )
        metrics = evaluator.evaluate_statement(
            statement, request.issue, request.agent_opinions
        )
        utilities = {
            name: {
                "cosine_similarity": metrics[f"cosine_similarity_{name}"],
                "avg_logprob": metrics[f"avg_logprob_{name}"],
                "perplexity": metrics[f"perplexity_{name}"],
            }
            for name in request.agent_opinions
        }
        welfare = {key: metrics[key] for key in _WELFARE_KEYS if key in metrics}
        return {"utilities": utilities, "welfare": welfare}

"""The port's API backends (``backends/api.py``) against the JAX package's.

Neither package has a client here (no ``together`` / ``openai``), so every
protocol call returns the reference's error sentinels: they must equal the
JAX backend's, field for field.  Then one stub client, injected on both
sides, answers chat / raw completions, echo'd-prompt logprobs and
embeddings: results and the keyword arguments each side sent must be equal.
The token-bucket limiter is timed against its rate (bounds stated per
case, with slack for a loaded host).
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

from consensus_tpu.backends import api as jax_api
from consensus_tpu.backends import base as jax_base
from consensus_tpu.backends import get_backend as jax_get_backend
from consensus_tpu_torch.backends import api, base, get_backend


def _requests(mod):
    return {
        "generate": [
            mod.GenerationRequest(user_prompt="Say hi", system_prompt="Be brief.", max_tokens=5,
                                  temperature=0.7, seed=3, stop=("\n",)),
            mod.GenerationRequest(user_prompt="raw text", chat=False, max_tokens=2, seed=None),
        ],
        "score": [
            mod.ScoreRequest(context="Issue: ", continuation="bikes", system_prompt="judge"),
            mod.ScoreRequest(context="ctx ", continuation="a long continuation"),
        ],
        "next_token_logprobs": [
            mod.NextTokenRequest(user_prompt="The", k=3, seed=1),
            mod.NextTokenRequest(user_prompt="A", k=2, system_prompt="s", chat=True),
        ],
    }


def _plain(value):
    if isinstance(value, np.ndarray):
        return ("array", value.dtype.str, value.shape, value.tolist())
    if isinstance(value, list):
        return [_plain(v) for v in value]
    if dataclasses.is_dataclass(value):
        return (type(value).__name__, _plain(dataclasses.asdict(value)))
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _calls(backend, mod):
    out = {name: _plain(getattr(backend, name)(reqs)) for name, reqs in _requests(mod).items()}
    out["embed"] = _plain(backend.embed(["one", "two", "three"]))
    return out


@pytest.mark.parametrize("cls", ["APIBackend", "OpenAIBackend"])
def test_sentinels_equal_jax(cls):
    port = getattr(api, cls)()
    ref = getattr(jax_api, cls)()
    assert port._client is None and ref._client is None
    got, expect = _calls(port, base), _calls(ref, jax_base)
    assert got == expect
    assert port.name == ref.name
    assert got["generate"][0][1]["finish_reason"] == "error"


@pytest.mark.parametrize("name, options", [
    ("api", {"model": "meta-llama/Llama-3.1-8B", "rate_limit": 2.0, "embed_dim": 16}),
    ("openai", {"model": "o3", "json_mode": False}),
])
def test_get_backend_builds_it(name, options):
    port = get_backend(name, **options)
    ref = jax_get_backend(name, **options)
    assert type(port).__name__ == type(ref).__name__
    assert vars(port).keys() == vars(ref).keys()
    for key in ("model", "embedding_model", "embed_dim", "requested_model", "json_mode"):
        assert getattr(port, key, None) == getattr(ref, key, None)
    assert port.rate_limiter.rate == ref.rate_limiter.rate


class StubClient:
    """The client surface both backends call, answering deterministically
    and recording every call's keyword arguments."""

    def __init__(self):
        self.calls = []
        ns = types.SimpleNamespace
        self.chat = ns(completions=ns(create=self._chat))
        self.completions = ns(create=self._completion)
        self.embeddings = ns(create=self._embedding)

    def _chat(self, **kwargs):
        self.calls.append(("chat", kwargs))
        text = "JSON ok" if "response_format" in kwargs else f"reply to {kwargs['messages'][-1]['content']}"
        return types.SimpleNamespace(choices=[types.SimpleNamespace(
            message=types.SimpleNamespace(content=text))])

    def _completion(self, **kwargs):
        self.calls.append(("completion", kwargs))
        if kwargs.get("echo"):
            prompt = kwargs["prompt"]
            tokens = [prompt[i:i + 3] for i in range(0, len(prompt), 3)]
            logprobs = [None] + [-0.25 * (i % 5) for i in range(1, len(tokens))]
            return types.SimpleNamespace(prompt=[types.SimpleNamespace(
                logprobs=types.SimpleNamespace(tokens=tokens, token_logprobs=logprobs))])
        seed = kwargs.get("seed") or 0
        return types.SimpleNamespace(choices=[types.SimpleNamespace(text=" tok%d" % (seed % 2))])

    def _embedding(self, **kwargs):
        self.calls.append(("embedding", kwargs))
        text = kwargs["input"]
        vec = [float(len(text)), float(sum(map(ord, text)) % 7), 1.0, -2.0]
        return types.SimpleNamespace(data=[types.SimpleNamespace(embedding=vec)])


@pytest.mark.parametrize("cls", ["APIBackend", "OpenAIBackend"])
def test_stub_client_on_both_sides(cls):
    port = getattr(api, cls)(rate_limit=1000.0)
    ref = getattr(jax_api, cls)(rate_limit=1000.0)
    port._client, ref._client = StubClient(), StubClient()
    got, expect = _calls(port, base), _calls(ref, jax_base)
    assert got == expect
    assert port._client.calls == ref._client.calls and port._client.calls
    if cls == "OpenAIBackend":
        json_request = base.GenerationRequest(user_prompt="Answer in JSON.", seed=None)
        jax_json_request = jax_base.GenerationRequest(user_prompt="Answer in JSON.", seed=None)
        assert _plain(port.generate([json_request])) == _plain(ref.generate([jax_json_request]))
        sent = port._client.calls[-1][1]
        assert sent["response_format"] == {"type": "json_object"}
        assert sent["seed"] == api.JUDGE_SEED == jax_api.JUDGE_SEED
        assert sent["model"] == "gpt-4.1"


def test_stub_failure_becomes_error_result():
    class Failing(StubClient):
        def _chat(self, **kwargs):
            raise RuntimeError("boom")

    port, ref = api.APIBackend(rate_limit=1000.0), jax_api.APIBackend(rate_limit=1000.0)
    port._client, ref._client = Failing(), Failing()
    request = _requests(base)["generate"][:1]
    got = port.generate(request)
    assert _plain(got) == _plain(ref.generate(_requests(jax_base)["generate"][:1]))
    assert got[0].text == "[ERROR: boom]" and not got[0].ok


@pytest.mark.parametrize("rate, calls, low, high", [
    (20.0, 20, 0.0, 0.15),   # the bucket starts full: 20 tokens at once
    (20.0, 25, 0.2, 0.6),    # 5 more at 20/s: 0.25 s
    (50.0, 60, 0.15, 0.5),   # 10 more at 50/s: 0.2 s
])
def test_rate_limiter_timing(rate, calls, low, high):
    for limiter in (api.RateLimiter(rate), jax_api.RateLimiter(rate)):
        start = time.monotonic()
        for _ in range(calls):
            limiter.wait_for_token()
        elapsed = time.monotonic() - start
        assert low <= elapsed <= high, (type(limiter).__module__, elapsed)


def test_rate_limiter_is_shared_by_threads():
    limiter = api.RateLimiter(40.0)
    start = time.monotonic()
    threads = [threading.Thread(target=lambda: [limiter.wait_for_token() for _ in range(15)])
               for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    # 60 tokens: 40 at once, 20 more at 40/s.
    assert 0.4 <= time.monotonic() - start <= 1.2

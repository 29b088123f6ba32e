"""Tokenizers for the on-device runtime.

Two implementations behind one small interface:

* :class:`ByteTokenizer` — dependency-free UTF-8 byte tokenizer with
  dedicated ids for the special strings the reference treats as single
  tokens (``<|eot_id|>``, ``<end_of_turn>``, ... — beam_search.py:26-35,
  src/utils.py:630-678).  Used by tests and random-weight benchmarks.
* :class:`HFTokenizer` — wraps a locally available ``transformers``
  tokenizer (no network fetch; zero-egress environment) for real Gemma/Llama
  checkpoints.

Chat templating lives here because the token-identity behaviours the
reference relies on (EOS string sets, substring-matched logit-bias token
sets, SURVEY §7.3) must be grounded in each tokenizer's vocabulary.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Protocol, Sequence, Tuple

SPECIAL_TOKENS = (
    "<pad>",
    "<bos>",
    "<eos>",
    "<|eot_id|>",
    "<|end_of_text|>",
    "<end_of_turn>",
    "<start_of_turn>",
    "[SYS]",
    "[/SYS]",
    "[USER]",
    "[/USER]",
    "[ASSISTANT]",
)


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    bos_id: int
    eos_ids: Tuple[int, ...]

    def encode(self, text: str, add_bos: bool = False) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def token_str(self, token_id: int) -> str: ...

    def chat_prompt(self, user: str, system: Optional[str] = None) -> str: ...

    def raw_prompt(self, user: str, system: Optional[str] = None) -> str: ...

    def user_turn_prefix(self, system: Optional[str] = None) -> str: ...

    def token_ids_containing(self, text: str) -> List[int]: ...


class ByteTokenizer:
    """UTF-8 bytes + special-string tokens. vocab = 256 bytes + specials.

    Layout: ids [0, len(SPECIAL_TOKENS)) are specials (pad=0, bos=1, eos=2),
    ids [n_special, n_special+256) are raw bytes.
    """

    def __init__(self):
        self.specials = list(SPECIAL_TOKENS)
        self.n_special = len(self.specials)
        self.vocab_size = self.n_special + 256
        self.pad_id = 0
        self.bos_id = 1
        self._special_to_id = {s: i for i, s in enumerate(self.specials)}
        # EOS set mirrors the reference's Llama-3/Gemma EOS strings.
        self.eos_ids = tuple(
            self._special_to_id[s]
            for s in ("<eos>", "<|eot_id|>", "<|end_of_text|>", "<end_of_turn>")
        )
        # Sorted longest-first for greedy matching.
        self._match_order = sorted(
            (s for s in self.specials if s != "<pad>"), key=len, reverse=True
        )

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        i = 0
        while i < len(text):
            matched = False
            for special in self._match_order:
                if text.startswith(special, i):
                    ids.append(self._special_to_id[special])
                    i += len(special)
                    matched = True
                    break
            if not matched:
                ids.extend(self.n_special + b for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        parts: List[bytes] = []
        for token_id in ids:
            token_id = int(token_id)
            if token_id < self.n_special:
                if token_id in (self.pad_id, self.bos_id):
                    continue
                parts.append(self.specials[token_id].encode("utf-8"))
            elif token_id < self.vocab_size:
                parts.append(bytes([token_id - self.n_special]))
        return b"".join(parts).decode("utf-8", "replace")

    def token_str(self, token_id: int) -> str:
        token_id = int(token_id)
        if token_id < self.n_special:
            return self.specials[token_id]
        if token_id < self.vocab_size:
            return bytes([token_id - self.n_special]).decode("utf-8", "replace")
        return ""

    def chat_prompt(self, user: str, system: Optional[str] = None) -> str:
        if system:
            return f"[SYS]{system}[/SYS]\n[USER]{user}[/USER]\n[ASSISTANT]"
        return f"[USER]{user}[/USER]\n[ASSISTANT]"

    def raw_prompt(self, user: str, system: Optional[str] = None) -> str:
        # Reference raw-completions concatenation (src/utils.py:168-174).
        return f"{system}\n\n{user}" if system else user

    def user_turn_prefix(self, system: Optional[str] = None) -> str:
        """Chat template up to (and inside) the user-turn opening — for
        scoring a continuation as user-turn content (ScoreRequest
        role="user"; reference evaluation semantics src/evaluation.py:182)."""
        if system:
            return f"[SYS]{system}[/SYS]\n[USER]"
        return "[USER]"

    def token_ids_containing(self, text: str) -> List[int]:
        """Substring-matched token ids (reference src/utils.py:122-134)."""
        ids = [
            i for i, s in enumerate(self.specials) if text in s and i != self.pad_id
        ]
        for b in range(256):
            if text in bytes([b]).decode("utf-8", "ignore"):
                ids.append(self.n_special + b)
        return ids


class HFTokenizer:
    """Wrap a local HuggingFace tokenizer (Gemma-2 / Llama-3 checkpoints)."""

    def __init__(self, path: str, family: str = "gemma"):
        from transformers import AutoTokenizer  # local files only; no egress

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.family = family
        self.vocab_size = len(self._tok)
        self.pad_id = self._tok.pad_token_id or 0
        self.bos_id = self._tok.bos_token_id or 0
        eos_strings = (
            ["<eos>", "<end_of_turn>"] if family == "gemma" else ["<|eot_id|>", "<|end_of_text|>"]
        )
        ids = []
        if self._tok.eos_token_id is not None:
            ids.append(self._tok.eos_token_id)
        for s in eos_strings:
            token_id = self._tok.convert_tokens_to_ids(s)
            if token_id is not None and token_id >= 0:
                ids.append(token_id)
        self.eos_ids = tuple(dict.fromkeys(ids))

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if int(i) != self.pad_id]
        return self._tok.decode(ids, skip_special_tokens=True)

    def token_str(self, token_id: int) -> str:
        return self._tok.decode([int(token_id)])

    # The Llama-3.1 chat template (the reference's main-body generation
    # model is Meta-Llama-3.1-8B-Instruct-Turbo, whose server-side template
    # Together applies on every call) ALWAYS emits a system header carrying
    # knowledge-cutoff/date lines — even when no system message is given.
    # The date is pinned to the template's own default so prompts are
    # reproducible run to run.
    _LLAMA31_DATE_BLOCK = (
        "Cutting Knowledge Date: December 2023\nToday Date: 26 Jul 2024\n\n"
    )

    def _llama_system_block(self, system: Optional[str]) -> str:
        return (
            "<|start_header_id|>system<|end_header_id|>\n\n"
            + self._LLAMA31_DATE_BLOCK
            + (system or "")
            + "<|eot_id|>"
        )

    def chat_prompt(self, user: str, system: Optional[str] = None) -> str:
        if self.family == "gemma":
            # Gemma has no system role; fold system into the user turn.
            content = f"{system}\n\n{user}" if system else user
            return f"<start_of_turn>user\n{content}<end_of_turn>\n<start_of_turn>model\n"
        return (
            "<|begin_of_text|>"
            + self._llama_system_block(system)
            + f"<|start_header_id|>user<|end_header_id|>\n\n{user}<|eot_id|>"
            + "<|start_header_id|>assistant<|end_header_id|>\n\n"
        )

    def raw_prompt(self, user: str, system: Optional[str] = None) -> str:
        return f"{system}\n\n{user}" if system else user

    def user_turn_prefix(self, system: Optional[str] = None) -> str:
        if self.family == "gemma":
            # No system role: the system text leads the user turn.
            lead = f"{system}\n\n" if system else ""
            return f"<start_of_turn>user\n{lead}"
        return (
            "<|begin_of_text|>"
            + self._llama_system_block(system)
            + "<|start_header_id|>user<|end_header_id|>\n\n"
        )

    @functools.lru_cache(maxsize=512)
    def token_ids_containing(self, text: str) -> List[int]:
        vocab = self._tok.get_vocab()
        return [i for s, i in vocab.items() if text in self._tok.convert_tokens_to_string([s])]


def get_tokenizer(spec: Optional[str] = None, family: str = "gemma") -> Tokenizer:
    """``None``/"byte" -> ByteTokenizer; otherwise a local HF tokenizer path."""
    if spec is None or spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec, family=family)

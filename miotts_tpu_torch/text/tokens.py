"""Speech-token bridge: `<|s_N|>` text <-> MioCodec code ids.

Behavioral port of `upstream src/token-parser.cpp:5-28` (tolerant scan
for `<|s_N|>` fragments), plus a vocab-derived token-id -> code-id table so sampled LLM tokens map to codec
codes with an int array lookup on device, keeping the string round-trip only
for --skip-llm replay and debugging.
"""

from __future__ import annotations

import re

import numpy as np

_SPEECH_RE = re.compile(r"<\|s_(\d+)\|>")


def parse_speech_tokens(text: str) -> list[int]:
    """Extract codec codes from `<|s_N|>` fragments, tolerant of malformed
    text in between (reference `token-parser.cpp:10-25`)."""
    return [int(m) for m in _SPEECH_RE.findall(text)]


def format_speech_tokens(codes) -> str:
    """Inverse of parse_speech_tokens (used by tools/tests and --skip-llm
    fixtures)."""
    return "".join(f"<|s_{int(c)}|>" for c in codes)


def build_token_code_table(vocab_tokens: list[str]) -> np.ndarray:
    """Map every LLM token id to its codec code id, or -1.

    Returns int32 [n_vocab]; entry v is N when vocab_tokens[v] == "<|s_N|>",
    else -1.  Uploaded once to the device so the sampled-token -> code mapping
    is a gather, with no host detokenize round-trip in the decode loop.
    """
    table = np.full(len(vocab_tokens), -1, dtype=np.int32)
    for i, tok in enumerate(vocab_tokens):
        m = _SPEECH_RE.fullmatch(tok)
        if m:
            table[i] = int(m.group(1))
    return table

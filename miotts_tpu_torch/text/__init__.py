"""Text frontend: normalization, tokenization, speech-token bridge, prompt."""

from .normalize import normalize_tts_text, should_normalize_ja
from .prompt import build_prompt
from .tokens import (
    build_token_code_table, format_speech_tokens, parse_speech_tokens,
)

__all__ = [
    "normalize_tts_text", "should_normalize_ja", "build_prompt",
    "parse_speech_tokens", "format_speech_tokens", "build_token_code_table",
]

"""Prompt template for the MioTTS LLM.

Contract from `upstream src/test-to-speech.cpp:90-92`: the synthesis
prompt is the normalized text wrapped in the chat-markup frame below; the
model then emits `<|s_N|>` speech tokens until EOS or `<|im_end|>`.
"""

from __future__ import annotations


def build_prompt(text: str) -> str:
    return f"<|startoftext|><|im_start|>user\n{text}<|im_end|>\n<|im_start|>assistant\n"

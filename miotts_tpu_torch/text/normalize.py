"""TTS text normalization (Japanese-gated), behavioral port of the reference.

Contract from `upstream src/text-normalize.cpp:108-157`:
  * Normalization only applies when >= 10% of non-whitespace codepoints are
    Japanese (Hiragana / Katakana / CJK Unified / CJK Ext A)
    (`text-normalize.cpp:78-97`).
  * Whitespace/control artifacts removed: tab, "[n]", ASCII space, full-width
    space (`:115-118`).
  * Punctuation variants: ？→?  ！→!  〜/～→ー (`:121-124`).
  * Symbol folding: ♥→♡, ●/◯/〇→○ (`:126-129`).
  * Ellipsis collapse: ……… (3+ U+2026) → …… (`:131-133`).
  * One wrapper-bracket pair stripped per kind when the string is fully
    enclosed: 「」『』（）【】() (`:135-147`).
  * Trailing 。 and 、 stripped repeatedly (`:149-155`).

Python operates on codepoints natively, so no UTF-8 decoder is needed.
"""

from __future__ import annotations


def _is_japanese_char(cp: int) -> bool:
    return (
        0x3040 <= cp <= 0x309F   # Hiragana
        or 0x30A0 <= cp <= 0x30FF  # Katakana
        or 0x4E00 <= cp <= 0x9FFF  # CJK Unified Ideographs
        or 0x3400 <= cp <= 0x4DBF  # CJK Extension A
    )


def should_normalize_ja(text: str) -> bool:
    total = 0
    ja = 0
    for ch in text:
        if ch in (" ", "\t", "\n", "\r"):
            continue
        total += 1
        if _is_japanese_char(ord(ch)):
            ja += 1
    if total == 0:
        return False
    return ja / total >= 0.1


_WRAPPERS = [("「", "」"), ("『", "』"), ("（", "）"), ("【", "】"), ("(", ")")]


def normalize_tts_text(text: str) -> str:
    if not should_normalize_ja(text):
        return text

    out = text
    for frm in ("\t", "[n]", " ", "　"):
        out = out.replace(frm, "")

    out = (out.replace("？", "?").replace("！", "!")
              .replace("〜", "ー").replace("～", "ー"))
    out = (out.replace("♥", "♡").replace("●", "○")
              .replace("◯", "○").replace("〇", "○"))

    while "………" in out:
        out = out.replace("………", "……")

    for left, right in _WRAPPERS:
        if (out.startswith(left) and out.endswith(right)
                and len(out) > len(left) + len(right)):
            out = out[len(left):len(out) - len(right)]

    while out.endswith("。") or out.endswith("、"):
        out = out[:-1]

    return out

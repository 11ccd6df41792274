"""Byte-level BPE tokenizer built from GGUF vocab metadata.

Replacement for the llama.cpp tokenizer surface consumed by the
reference (`upstream src/test-to-speech.cpp:118,155,453,490`
llama_tokenize; `:173,584` llama_token_to_piece; `:150,485` llama_vocab_eos).
Reads `tokenizer.ggml.*` KVs (tokens, merges, token_type, special ids) and
implements GPT-2-style byte-level BPE with pre-tokenizer regexes and literal
special-token matching (parse_special=true semantics).
"""

from __future__ import annotations

import re
import sys
import unicodedata
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

# llama.cpp token type enum (tokenizer.ggml.token_type)
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6

# Pre-tokenizer regexes, keyed by tokenizer.ggml.pre.  The GPT-2 default and
# the Qwen2/LLaMA-3 pattern cover the model families MioTTS ships.  They are
# written with the `regex` package's \p{L} / \p{N} classes; the stdlib `re`
# has neither, so `_compile_pre` rewrites them into explicit code-point range
# classes built from unicodedata categories L* and N* (`\d` would only be Nd).
_PRE_REGEX = {
    "default": r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+",
    "gpt-2": r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+",
    "qwen2": r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    "llama3": r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    "llama-bpe": r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
}


@lru_cache(maxsize=1)
def _category_ranges() -> dict[str, str]:
    """{"L": ranges, "N": ranges}: the code points of Unicode general
    categories L* and N* as the body of an `re` character class (escaped
    \\U ranges, so the text can go inside [...] or [^...])."""
    spans: dict[str, list[list[int]]] = {"L": [], "N": []}
    for cp in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(cp))[0]
        if cat in spans:
            s = spans[cat]
            if s and s[-1][1] == cp - 1:
                s[-1][1] = cp
            else:
                s.append([cp, cp])
    return {cat: "".join(f"\\U{a:08x}-\\U{b:08x}" for a, b in s)
            for cat, s in spans.items()}


@lru_cache(maxsize=None)
def _compile_pre(pattern: str) -> re.Pattern:
    """Compile a \\p{L}/\\p{N} pre-tokenizer pattern with the stdlib `re`:
    a class item inside [...] is replaced by its ranges, a bare \\p{X}
    by [ranges]."""
    cls = _category_ranges()
    out, in_class, i = [], False, 0
    while i < len(pattern):
        if pattern.startswith("\\p{", i):
            body = cls[pattern[i + 3]]
            out.append(body if in_class else f"[{body}]")
            i += 5
            continue
        ch = pattern[i]
        if ch == "\\":
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not in_class:
            in_class = True
        elif ch == "]" and in_class:
            in_class = False
        out.append(ch)
        i += 1
    return re.compile("".join(out))


@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2 byte -> printable-unicode map (bijective over 0..255)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1))
          + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def _unicode_to_byte() -> dict[str, int]:
    return {c: b for b, c in _byte_to_unicode().items()}


@dataclass
class Tokenizer:
    tokens: list[str]
    token_types: list[int]
    merges: list[str] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)   # sentencepiece only
    model: str = "gpt2"          # "gpt2" (byte-level BPE) | "llama" (SPM)
    pre: str = "default"
    bos_id: int = -1
    eos_id: int = -1
    unk_id: int = -1
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True   # SPM: prepend "▁" to the first fragment

    def __post_init__(self):
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self.merge_ranks = {}
        for rank, m in enumerate(self.merges):
            a, _, b = m.partition(" ")
            self.merge_ranks[(a, b)] = rank
        # Specials (control + user-defined) are matched literally before BPE.
        self.special_tokens = {
            t: i for i, t in enumerate(self.tokens)
            if i < len(self.token_types)
            and self.token_types[i] in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED)
        }
        if self.special_tokens:
            parts = sorted(self.special_tokens, key=len, reverse=True)
            self._special_re = re.compile("|".join(re.escape(p) for p in parts))
        else:
            self._special_re = None
        self._pre_re = _compile_pre(_PRE_REGEX.get(self.pre, _PRE_REGEX["default"]))
        self._b2u = _byte_to_unicode()
        self._u2b = _unicode_to_byte()

    # -- construction ----------------------------------------------------
    @classmethod
    def from_gguf(cls, reader) -> "Tokenizer":
        kv = reader.kv
        tokens = list(kv["tokenizer.ggml.tokens"])
        types = [int(t) for t in kv.get("tokenizer.ggml.token_type", [TOKEN_TYPE_NORMAL] * len(tokens))]
        return cls(
            tokens=tokens,
            token_types=types,
            merges=list(kv.get("tokenizer.ggml.merges", [])),
            scores=[float(s) for s in kv.get("tokenizer.ggml.scores", [])],
            model=str(kv.get("tokenizer.ggml.model", "gpt2")),
            pre=str(kv.get("tokenizer.ggml.pre", "default")),
            bos_id=int(kv.get("tokenizer.ggml.bos_token_id", -1)),
            eos_id=int(kv.get("tokenizer.ggml.eos_token_id", -1)),
            unk_id=int(kv.get("tokenizer.ggml.unknown_token_id", -1)),
            add_bos=bool(kv.get("tokenizer.ggml.add_bos_token", False)),
            add_eos=bool(kv.get("tokenizer.ggml.add_eos_token", False)),
            add_space_prefix=bool(kv.get("tokenizer.ggml.add_space_prefix", True)),
        )

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)

    # -- BPE core --------------------------------------------------------
    def _bpe(self, piece: str) -> list[int]:
        """Apply BPE merges to one byte-level-encoded pre-token."""
        word = list(piece)
        if not word:
            return []
        while len(word) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(word) - 1):
                r = self.merge_ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            word[best_i:best_i + 2] = [word[best_i] + word[best_i + 1]]
        out: list[int] = []
        for w in word:
            tid = self.token_to_id.get(w)
            if tid is not None:
                out.append(tid)
            else:
                # Fall back to per-byte tokens.
                for ch in w:
                    b = self._u2b.get(ch)
                    sub = self.token_to_id.get(ch if b is None else self._b2u[b])
                    if sub is not None:
                        out.append(sub)
        return out

    # -- SPM (sentencepiece, llama-arch GGUFs) ---------------------------
    def _spm_encode(self, text: str, first: bool) -> list[int]:
        """llama.cpp llm_tokenizer_spm: whitespace -> U+2581, optional space
        prefix, then greedy best-score bigram merging over the vocab with
        <0xNN> byte fallback.

        The dummy prefix is UNCONDITIONAL (sentencepiece add_dummy_prefix
        semantics): text already starting with a space still gets one more,
        e.g. " x" -> "▁▁x"."""
        if first and self.add_space_prefix and text:
            text = " " + text
        text = text.replace(" ", "▁")
        if not text:
            return []
        syms = list(text)
        while len(syms) > 1:
            best_score, best_i = None, -1
            for i in range(len(syms) - 1):
                tid = self.token_to_id.get(syms[i] + syms[i + 1])
                if tid is None or tid >= len(self.scores):
                    continue
                sc = self.scores[tid]
                if best_score is None or sc > best_score:
                    best_score, best_i = sc, i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        out: list[int] = []
        for s in syms:
            tid = self.token_to_id.get(s)
            if tid is not None:
                out.append(tid)
                continue
            fell_back = False
            for b in s.encode("utf-8"):
                bid = self.token_to_id.get(f"<0x{b:02X}>")
                if bid is not None:
                    out.append(bid)
                    fell_back = True
            if not fell_back and self.unk_id >= 0:
                out.append(self.unk_id)
        return out

    def _encode_fragment(self, text: str, first: bool = False) -> list[int]:
        if self.model == "llama":
            return self._spm_encode(text, first)
        ids: list[int] = []
        for m in self._pre_re.finditer(text):
            piece = "".join(self._b2u[b] for b in m.group(0).encode("utf-8"))
            ids.extend(self._bpe(piece))
        return ids

    # -- public API ------------------------------------------------------
    def encode(self, text: str, add_special: bool = True,
               parse_special: bool = True) -> list[int]:
        """Tokenize text.  With parse_special, control/user-defined tokens in
        the text match literally (the reference always tokenizes prompts with
        special parsing on, `test-to-speech.cpp:118-119`)."""
        ids: list[int] = []
        if add_special and self.add_bos and self.bos_id >= 0:
            ids.append(self.bos_id)
        if parse_special and self._special_re is not None:
            pos = 0
            first = True
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    ids.extend(self._encode_fragment(text[pos:m.start()],
                                                     first=first))
                ids.append(self.special_tokens[m.group(0)])
                pos = m.end()
                # SPM prefixes the fragment AFTER a special token with the
                # dummy space too (llama.cpp is_prev_special = true after
                # every special); BPE fragments ignore the flag
                first = True
            if pos < len(text):
                ids.extend(self._encode_fragment(text[pos:], first=first))
        else:
            ids.extend(self._encode_fragment(text, first=True))
        if add_special and self.add_eos and self.eos_id >= 0:
            ids.append(self.eos_id)
        return ids

    def id_to_bytes(self, token_id: int) -> bytes:
        """Token id -> raw surface bytes.  Multibyte UTF-8 sequences may span
        several byte-level tokens, so decoding to text happens at the
        sequence level (`decode`)."""
        if not 0 <= token_id < len(self.tokens):
            return b""
        tok = self.tokens[token_id]
        ttype = self.token_types[token_id] if token_id < len(self.token_types) else TOKEN_TYPE_NORMAL
        if ttype in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED):
            return tok.encode("utf-8")
        if ttype == TOKEN_TYPE_BYTE:
            # "<0xNN>" byte tokens (sentencepiece style)
            if tok.startswith("<0x") and tok.endswith(">"):
                try:
                    return bytes([int(tok[3:-1], 16)])
                except ValueError:
                    return tok.encode("utf-8")
            return tok.encode("utf-8")
        if self.model == "llama":
            return tok.replace("▁", " ").encode("utf-8")
        u2b = self._u2b
        if all(ch in u2b for ch in tok):
            return bytes(u2b[ch] for ch in tok)
        return tok.encode("utf-8")

    def id_to_piece(self, token_id: int) -> str:
        """Token id -> surface text (llama_token_to_piece equivalent).
        Lossy for tokens holding partial UTF-8 sequences; prefer `decode`."""
        return self.id_to_bytes(token_id).decode("utf-8", errors="replace")

    def decode(self, ids) -> str:
        data = b"".join(self.id_to_bytes(int(i)) for i in ids)
        return data.decode("utf-8", errors="replace")

    def speech_code_table(self) -> np.ndarray:
        from .tokens import build_token_code_table
        return build_token_code_table(self.tokens)

"""What a served request should have been, worked out from its inputs
alone: its prompt's token ids, the uniform behind each sampled token, the
codes its tokens stand for, and the audio its commits emit.

The serving contract, as MioTTS's streaming path defines it:
  * the prompt is `<|startoftext|><|im_start|>user\\n{text}<|im_end|>\\n
    <|im_start|>assistant\\n`, byte-level (one token a UTF-8 byte, the three
    specials by id after the 256 byte tokens); the benchmark's texts are
    ones that text normalisation leaves as they are;
  * token 259 + i is speech code i; other tokens carry no code; a request
    stops at <|im_end|> or at its token budget;
  * draw number k of a request seeded s takes the uniform of output k + 1
    of splitmix64 started at s (top 53 bits), and the inverse CDF of
    softmax(logits / temperature) there; temperature 0 takes the argmax;
  * a commit decodes the request's first n codes and emits the samples
    [begin, end) of that decode; emitted samples travel as int16
    (x * 32767 clamped to [-32768, 32767], truncated toward zero, / 32767),
    cut in pieces of at most 4096 samples, the first piece of a commit
    blended into the last min(44100 * 3 // 100, 4096) samples of the
    previous piece by a linear crossfade.
"""

from __future__ import annotations

import numpy as np

BYTE_TOKENS = 256
START, IM_START, IM_END = 256, 257, 258
SPEECH0 = 259
MASK64 = (1 << 64) - 1
GOLDEN, MIX1, MIX2 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def prompt_ids(text: str) -> list[int]:
    def b(s):
        return list(s.encode("utf-8"))
    return ([START, IM_START] + b("user\n") + b(text) + [IM_END] + b("\n")
            + [IM_START] + b("assistant\n"))


def code_of(token: int, n_speech: int) -> int:
    """The speech code of a token, or -1."""
    return token - SPEECH0 if SPEECH0 <= token < SPEECH0 + n_speech else -1


def uniform(seed: int, draw: int) -> float:
    z = (seed + (draw + 1) * GOLDEN) & MASK64
    z = ((z ^ (z >> 30)) * MIX1) & MASK64
    z = ((z ^ (z >> 27)) * MIX2) & MASK64
    z ^= z >> 31
    return (z >> 11) * (1.0 / (1 << 53))


def to_int16(x: np.ndarray) -> np.ndarray:
    q = np.clip(x.astype(np.float32) * np.float32(32767.0), -32768, 32767)
    return np.trunc(q).astype(np.int16).astype(np.float32) / np.float32(32767.0)


def emit(pieces: list, tail: np.ndarray, audio: np.ndarray,
         chunk: int = 4096, sample_rate: int = 44100):
    """Append one commit's emitted pieces to `pieces`; returns the new
    tail."""
    xf_len = min(sample_rate * 3 // 100, 4096)
    for i in range(0, audio.size, chunk):
        piece = audio[i:i + chunk].copy()
        if i == 0 and tail.size:
            n = min(tail.size, piece.size)
            a = (np.arange(n, dtype=np.float32) + 1) / np.float32(n + 1)
            piece[:n] = (1 - a) * tail[:n] + a * piece[:n]
        tail = piece[-xf_len:].copy() if piece.size >= xf_len else piece.copy()
        pieces.append(piece)
    return tail


def replay(commits: list, decode, spt: int, i16: bool = True) -> np.ndarray:
    """The audio a request's commits emit: `commits` [(n_codes decoded,
    begin code, end code)], `decode(n)` the PCM of the first n codes."""
    pieces, tail = [], np.zeros(0, np.float32)
    for n, begin, end in commits:
        audio = decode(n)[begin * spt:end * spt]
        tail = emit(pieces, tail, to_int16(audio) if i16 else audio)
    return (np.concatenate(pieces) if pieces
            else np.zeros(0, np.float32))

"""The request mix: Japanese-like sentences of seeded length, each with a
code budget, a temperature and a sampling seed.

A request's length L in characters is lognormal (median `chars_median`,
sigma `chars_sigma`) clipped to [chars_min, chars_max]; its text is L
characters of hiragana, katakana and kanji (3 UTF-8 bytes each, so the
prompt is about 3 L bytes), with an ideographic comma now and then inside
and a hiragana at the end: a text that MioTTS's Japanese normalisation
leaves as it is.  Its budget is round(codes_per_char * L) codes (speech
runs at about 8 characters and 25 codes a second).  A share
`greedy_share` of requests is greedy (temperature 0); the rest sample at
`temperature`.  Request k of client c depends on (seed, c, k) alone, so
the same seed gives the same requests in any order of arrival.

With `strata` = B, each client's requests come in blocks of B whose
lengths and greedy picks are one fixed set for every seed: the B
lognormal quantiles at (i + 0.5) / B, clipped, and exactly round(B *
greedy_share) greedy requests, in an order drawn from (seed, client,
block).  Every seed then sends the same work, in another order; texts
and sampling seeds stay drawn per request.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

HIRAGANA = [chr(c) for c in range(0x3041, 0x3094)]
KATAKANA = [chr(c) for c in range(0x30A1, 0x30F4)]
KANJI = [chr(c) for c in range(0x4E00, 0x4E00 + 2000)]
COMMA = "、"


@dataclass(frozen=True)
class Request:
    client: int
    index: int
    text: str
    n_chars: int
    max_tokens: int
    temperature: float
    seed: int
    lead_in: bool = False


def sentence(rng: np.random.Generator, n: int) -> str:
    kind = rng.random(n)
    out = []
    for i, k in enumerate(kind):
        if 0 < i < n - 1 and k < 0.05 and out[-1] != COMMA:
            out.append(COMMA)
        elif i == n - 1 or k < 0.55:
            out.append(HIRAGANA[rng.integers(len(HIRAGANA))])
        elif k < 0.8:
            out.append(KATAKANA[rng.integers(len(KATAKANA))])
        else:
            out.append(KANJI[rng.integers(len(KANJI))])
    return "".join(out)


class Mix:
    def __init__(self, params: dict, seed: int):
        self.p, self.seed = params, seed

    def chars(self, rng: np.random.Generator) -> int:
        return self._length(rng.standard_normal())

    def _length(self, z: float) -> int:
        p = self.p
        n = p["chars_median"] * np.exp(p["chars_sigma"] * z)
        return int(np.clip(round(n), p["chars_min"], p["chars_max"]))

    def _stratum(self, client: int, index: int) -> tuple[int, bool]:
        """Request `index`'s length and greediness from its block's fixed
        set (`strata`)."""
        b = self.p["strata"]
        rng = np.random.default_rng([self.seed, client, index // b, 0x57A7])
        place = int(rng.permutation(b)[index % b])
        pick = int(rng.permutation(b)[index % b])
        z = NormalDist().inv_cdf((place + 0.5) / b)
        return (self._length(z),
                pick < round(b * self.p["greedy_share"]))

    def request(self, client: int, index: int,
                lead_in_tokens: int = 0) -> Request:
        """Request `index` of `client`.  `lead_in_tokens` > 0 makes it a
        lead-in request of that budget (it counts in nothing)."""
        rng = np.random.default_rng([self.seed, client, index])
        n = self.chars(rng)
        if self.p.get("strata"):
            n, greedy = self._stratum(client, index)
            text = sentence(rng, n)
            rng.random()
        else:
            text = sentence(rng, n)
            greedy = rng.random() < self.p["greedy_share"]
        budget = (lead_in_tokens if lead_in_tokens
                  else int(round(self.p["codes_per_char"] * n)))
        return Request(client=client, index=index, text=text, n_chars=n,
                       max_tokens=budget,
                       temperature=0.0 if greedy else self.p["temperature"],
                       seed=int(rng.integers(0, 1 << 62)),
                       lead_in=bool(lead_in_tokens))

    def prompt_bytes_max(self) -> int:
        """The longest prompt the mix can send, in bytes (= tokens)."""
        return 3 * self.p["chars_max"] + 20

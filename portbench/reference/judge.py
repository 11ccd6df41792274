"""The comparison that decides `correct`: a served request against the plain
reference, from the request's inputs and what the program served.

For each request of the sample the reference runs once over its prompt
and served tokens (teacher-forced, `llm.forward_logits`), then reads:
  * logit_gap (greedy requests): the widest gap by which a served token's
    reference logit lies below the reference's best at its position;
  * cdf_miss (sampled requests): the widest distance by which a served
    token's draw (the request's uniform, `serving.uniform`) falls outside
    the token's interval of the reference's CDF of softmax(logits / t);
  * code_errors: requests whose codes differ from the codes of their
    served tokens, whose ending (the stop token, the budget) does not
    follow from them, or that failed with codes or kept none and did not
    fail (a request with no speech code has no audio and fails);
  * audio_err: the widest |difference| between the samples the callbacks
    received and the reference's replay of the request's commits (each a
    decode of its first n codes by `codec.Codec`, int16 on the wire, the
    crossfaded pieces); a length that differs reads as infinite.
The control puts the reference in the program's place one precision
lower (float8 e4m3 activations, scaled by row, into every linear; TF32 in
the codec): at each position of the same prompts and tokens it takes the
token that it puts first (its argmax, or its own CDF at the draw) and the
audio it replays, and reads the same numbers against the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import serving
from .codec import Codec
from .llm import forward_logits

STOP = serving.IM_END


@dataclass
class Served:
    """One request as the program served it."""
    text: str
    temperature: float
    seed: int
    max_tokens: int
    tokens: list          # the kept tokens, in order
    stopped: bool         # ended by the stop token (drawn after `tokens`)
    codes: list           # the codes the program kept
    commits: list         # [(n codes decoded, begin code, end code)]
    audio: np.ndarray     # what the callbacks received, concatenated
    failed: bool = False  # the program failed it (no speech codes)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a row (amax -> 448)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _positions(r: Served, n_prompt: int):
    """(checked tokens, their positions in the logits)."""
    toks = r.tokens + ([STOP] if r.stopped else [])
    return toks, list(range(n_prompt - 1, n_prompt - 1 + len(toks)))


def _cdf(logits: torch.Tensor, t: float) -> torch.Tensor:
    return torch.cumsum(torch.softmax(logits.double() / t, dim=-1), dim=-1)


def _miss(cdf: torch.Tensor, toks: torch.Tensor, u: torch.Tensor):
    hi = cdf.gather(1, toks[:, None])[:, 0]
    lo = torch.where(toks > 0, cdf.gather(1, (toks - 1).clamp(min=0)[:, None])
                     [:, 0], torch.zeros_like(hi))
    hi, lo = hi / cdf[:, -1], lo / cdf[:, -1]
    return torch.clamp(torch.maximum(lo - u, u - hi), min=0.0)


def token_numbers(reqs: list, logits: list, chosen=None) -> dict:
    """logit_gap and cdf_miss of each request's tokens against the
    reference logits; `chosen[i]`, when given, are other tokens to read
    in their place (the control's)."""
    gap, miss = 0.0, 0.0
    for i, (r, lg) in enumerate(zip(reqs, logits)):
        n_prompt = len(serving.prompt_ids(r.text))
        toks, pos = _positions(r, n_prompt)
        if not toks:
            continue
        L = lg[pos].float()
        t = torch.tensor(toks if chosen is None else chosen[i],
                         device=L.device)
        if r.temperature <= 0:
            g = L.max(dim=-1).values - L.gather(1, t[:, None])[:, 0]
            gap = max(gap, float(g.max()))
        else:
            u = torch.tensor([serving.uniform(r.seed, k)
                              for k in range(len(toks))],
                             dtype=torch.float64, device=L.device)
            miss = max(miss, float(_miss(_cdf(L, r.temperature), t,
                                         u).max()))
    return {"logit_gap": gap, "cdf_miss": miss}


def control_tokens(reqs: list, logits: list) -> list:
    """The token the control's logits put first at each checked position:
    the argmax (greedy) or the inverse CDF at the request's draw."""
    out = []
    for r, lg in zip(reqs, logits):
        n_prompt = len(serving.prompt_ids(r.text))
        toks, pos = _positions(r, n_prompt)
        L = lg[pos].float()
        if r.temperature <= 0 or not toks:
            out.append(L.argmax(dim=-1).tolist())
            continue
        u = torch.tensor([serving.uniform(r.seed, k) for k in range(len(toks))],
                         dtype=torch.float64, device=L.device)
        cdf = _cdf(L, r.temperature)
        idx = torch.searchsorted(cdf / cdf[:, -1:], u[:, None], right=True)
        out.append(idx[:, 0].clamp(max=L.shape[-1] - 1).tolist())
    return out


def code_errors(reqs: list, n_speech: int) -> int:
    bad = 0
    for r in reqs:
        want = [c for c in (serving.code_of(t, n_speech) for t in r.tokens)
                if c >= 0]
        ended = r.stopped or len(r.tokens) >= r.max_tokens
        if (want != list(r.codes) or STOP in r.tokens or not ended
                or r.failed != (not want)):
            bad += 1
    return bad


def replays(reqs: list, codec: Codec, voice, n_speech: int,
            spt: int) -> list:
    """Each request's commits replayed through `codec`."""
    out = []
    for r in reqs:
        codes = [c for c in (serving.code_of(t, n_speech) for t in r.tokens)
                 if c >= 0]
        cache = {}

        def decode(n):
            if n not in cache:
                cache[n] = codec.decode(codes[:n], voice).cpu().numpy()
            return cache[n]
        out.append(serving.replay(r.commits, decode, spt))
    return out


def audio_err(ref: list, got: list) -> float:
    worst = 0.0
    for a, b in zip(ref, got):
        if a.size != b.size:
            return math.inf
        if a.size:
            worst = max(worst, float(np.abs(a - b).max()))
    return worst


def judge(reqs: list, llm_tensors: dict, shape, codec_model, codec_cfg: dict,
          voice, device, control: bool = False) -> tuple[dict, dict | None]:
    """(the numbers of the program's served requests, the control's or
    None)."""
    seqs = []
    for r in reqs:
        toks = serving.prompt_ids(r.text) + r.tokens + (
            [STOP] if r.stopped else [])
        seqs.append(toks[:-1] if len(toks) > 1 else toks)
    logits = forward_logits(llm_tensors, shape, seqs, device)
    spt = codec_cfg["samples_per_token"]
    nums = token_numbers(reqs, logits)
    nums["code_errors"] = code_errors(reqs, shape.n_speech)
    ref = replays(reqs, Codec(codec_model, codec_cfg, device), voice,
                  shape.n_speech, spt)
    nums["audio_err"] = audio_err(ref, [r.audio for r in reqs])
    if not control:
        return nums, None
    low = forward_logits(llm_tensors, shape, seqs, device, act=fp8_rows)
    ctl = token_numbers(reqs, logits, control_tokens(reqs, low))
    ctl["code_errors"] = 0
    ctl["audio_err"] = audio_err(ref, replays(
        reqs, Codec(codec_model, codec_cfg, device, tf32=True), voice,
        shape.n_speech, spt))
    return nums, ctl

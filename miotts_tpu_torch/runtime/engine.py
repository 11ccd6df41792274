"""TTS engine on PyTorch: text -> speech tokens -> codec -> PCM, offline and
streaming.

Counterpart of `miotts_tpu/runtime/engine.py`, keeping its contract: prompt
format and normalisation, greedy / temperature sampling in on-device chunks,
token -> code mapping through the vocab table, a bucketed codec decode with
exact output length T * samples_per_token, peak normalisation to 0.95 on
the host, and the reference's streaming policy (`synthesize_stream`: a
check every 20 tokens, 32 codes held back, commits of >= 24 codes, the
full-prefix re-decode or a trailing window, ~30 ms crossfades, chunked
callbacks).  For batched serving (`runtime/batching.py`) it adds a batched
codec decode that returns only each stream's emission slice
(`decode_codes_batch_sliced[_async]`, and `decode_code_rows_sliced` over
the device code buffer of the fused batch step, `_fused_batch_step`).

Streaming takes one of three paths, as in the JAX package:
  * fused (the default): each chunk's generation, code append and commit
    policy are enqueued on the device with no host sync (`_fused_chunk`),
    chunk k + 1 before chunk k's small outputs are read back
    (`stream_pipeline_depth`); the codec decode chunk k's policy asked for
    is enqueued when the host reads k, over the code buffer as k left it;
  * unfused: `generate_tokens` in chunks of `stream_check_interval`, the
    policy checked on the host after each;
  * pipelined codec (`pipeline_codec=True`): the unfused path with each
    commit's audio read back one check interval later.
With a speculative draft model (`draft_model_path`) the tokens come from
draft-propose / target-verify rounds (`_spec_loop`), and a stream takes the
unfused path.

The codec options of the JAX package: `codec_fast` (TF32 matmuls and
convolutions after the codec's prenet, models/codec.py) and
`codec_device`, which puts the codec on a CUDA device of its own index and
runs its decodes on a dedicated CUDA stream there (with one GPU: beside
the LLM's stream on the same card), so a pipelined decode overlaps the
next LLM chunk.  Decode outputs
are then read through `codec_readback`, which waits on the codec stream.
`quantized_kv` gives the single-stream caches (the target's and the
draft's) int8 k / v with per-(token, head) scales.

Everything runs on `EngineConfig.device` ("cuda" by default).  Asking for
the GPU when none is available raises; the engine never carries on quietly
on the CPU.  The quantized linears take the kernel route of
`EngineConfig.qdot_route`, or of the JAX package's environment switches
(`ops/qmat.QdotRoute.from_env`) read once when the engine is built.
"""

from __future__ import annotations

import contextlib
import copy
import os
import sys
import time
from collections import Counter
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from ..gguf import GGUFReader, load_voice_embedding
from ..models.codec import (codec_decode_spec, codec_fast, exact_f32,
                            load_codec_params)
from ..models.llm import (LLMConfig, init_kv_cache, kv_heads,
                          llm_generate_chunk, llm_generate_chunk_batched,
                          llm_generate_chunk_spec, llm_prefill,
                          load_llm_params, sample_token)
from ..ops.collective import Shard
from ..ops.istft import spec_to_audio_bucketed
from ..ops.qmat import QdotRoute, QTensor, with_route
from ..text import build_prompt, normalize_tts_text, parse_speech_tokens
from ..text.tokenizer import Tokenizer
from .profile import StreamProfile

# tokens per on-device generation chunk (one host read per chunk)
OFFLINE_CHUNK = 64

# StreamCallback(samples_or_None, sample_rate, is_last) -> keep_going
StreamCallback = Callable[[Optional[np.ndarray], int, bool], bool]


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available (pass device='cpu' to run on the CPU)")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _leaves(tree):
    """The leaves of a params tree (dicts / lists), depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, Shard):
        yield from _leaves(tree.local)
    elif tree is not None:
        yield tree


def _round_up(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


def _bucket_len(n: int, min_bucket: int) -> int:
    """Geometric (power-of-2) length bucket."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


class _Readback:
    """Device tensors copied to the host without waiting: on a GPU into
    pinned memory behind a CUDA event recorded right after the copy, so
    get() waits only for work enqueued before it.  The copy runs on
    `stream` (default: the current stream), the one that produced the
    tensors."""

    def __init__(self, *tensors: torch.Tensor,
                 stream: torch.cuda.Stream | None = None):
        self._event = None
        if tensors[0].is_cuda:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                self._host = []
                for t in tensors:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    self._host.append(h)
                self._event = torch.cuda.Event()
                self._event.record()
        else:
            self._host = [t.clone() for t in tensors]

    def get(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without a host wait: on a GPU through
    pinned memory (a copy from pageable memory synchronises the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _slice_plan(lens: list, begins: list, ends: list, bucket: int,
                spt: int):
    """The batched sliced decode's shapes, the JAX package's: the batch
    padded to a bucket (powers of two up to 16, then multiples of 16), the
    slice length E to multiples of 8 codes of audio (at most the bucket's
    samples), each row's slice start clamped so that it fits.  Returns
    (padded batch B, E, starts, offsets, n_samples): row i's samples are
    audio[i, offsets[i] : offsets[i] + n_samples[i]] of the slices that
    start at starts[i]."""
    B_real = len(lens)
    if B_real <= 16:
        B = 1
        while B < B_real:
            B *= 2
    else:
        B = _round_up(B_real, 16)
    total = bucket * spt
    n_samp = [max(0, min(int(e), lens[i] * spt) - int(b))
              for i, (b, e) in enumerate(zip(begins, ends))]
    E = min(_round_up(max(n_samp + [1]), 8 * spt), total)
    starts, offs = [], []
    for b in begins:
        st = max(0, min(int(b), total - E))
        starts.append(st)
        offs.append(int(b) - st)
    return B, E, starts, offs, n_samp


def emit_chunks(audio: np.ndarray, begin: int, end: int, is_final: bool,
                tail: np.ndarray, chunk_samples: int, sample_rate: int,
                send) -> tuple[bool, np.ndarray]:
    """Chunked emission of audio[begin:end]: pieces of at most
    `chunk_samples`, the first blended into `tail` (the end of the previous
    emission) by a linear crossfade of up to ~30 ms (min(sr * 3 // 100,
    4096) samples).  `send(chunk, is_last)` delivers a piece and returns
    False to stop.  Returns (ok, the new tail).  The one copy of this math,
    shared by the engine's streams and the batcher."""
    crossfade = min(sample_rate * 3 // 100, 4096)
    i, first = begin, True
    while i < end:
        n = min(chunk_samples, end - i)
        chunk = audio[i:i + n].copy()
        if first and tail.size:
            xf = min(tail.size, chunk.size)
            a = (np.arange(xf, dtype=np.float32) + 1.0) / (xf + 1.0)
            chunk[:xf] = (1.0 - a) * tail[:xf] + a * chunk[:xf]
        tail = chunk[-crossfade:].copy() if n >= crossfade else chunk.copy()
        if not send(chunk, is_final and i + n >= end):
            return False, tail
        i += n
        first = False
    return True, tail


@torch.no_grad()
def _fused_batch_step(llm_params, last_logits, cache, active, seed, drawn,
                      temperature, stop_ids, code_table, codes_buf, n_codes,
                      committed, n_tokens, max_toks, llm_cfg, n_steps: int,
                      holdback: int, min_step: int, first_commit: int = -1,
                      attn_len: int = 0):
    """The fused batch step (the JAX package's `_fused_batch_step`), all
    enqueued on the device with no host sync: `llm_generate_chunk_batched`
    over the active slots with each slot's token budget and the code
    append into codes_buf (its `codes` state), then each slot's commit
    policy: target = max(n_codes - holdback, 0); the smallest commit is
    first_commit (clamped to min_step; < 0: min_step) while the slot has
    committed nothing, min_step after; emit = active & n_codes > 0 &
    target > committed & target - committed >= that.

    The JAX step also decodes every row under `lax.cond(any(emit))`.  Here
    the caller reads the outputs back (the step's one sync) and then
    decodes the emitting rows only (TTSEngine.decode_code_rows_sliced): a
    row's audio does not depend on the other rows.  All n_steps run,
    masked, where the JAX loop leaves once no slot is active.

    Shapes: last_logits [B, V]; active bool [B]; seed / drawn int64 [B];
    temperature f32 [B]; code_table [V'] (token -> code, -1 for none);
    codes_buf int32 [B, bucket] (written in place); n_codes / committed /
    n_tokens / max_toks int32 [B].  Returns (buf [B, n_steps] int64 (-1
    where not kept), active, last_logits, cache, drawn, codes_buf, n_codes,
    n_tokens, emit [B] bool, target [B])."""
    codes = dict(table=code_table, buf=codes_buf, n_codes=n_codes,
                 n_tokens=n_tokens, max_toks=max_toks)
    buf, active, last, cache, drawn = llm_generate_chunk_batched(
        llm_params, last_logits, cache, active, seed, drawn, temperature,
        stop_ids, llm_cfg, n_steps, attn_len, codes=codes)
    n_codes = codes["n_codes"]
    fc = min_step if first_commit < 0 else min(first_commit, min_step)
    target = torch.clamp(n_codes - holdback, min=0)
    min_eff = torch.where(committed == 0, fc, min_step)
    emit = (active & (n_codes > 0) & (target > committed)
            & (target - committed >= min_eff))
    return (buf, active, last, cache, drawn, codes_buf, n_codes,
            codes["n_tokens"], emit, target)


@dataclass
class EngineConfig:
    """Engine-level knobs (the JAX package's defaults) plus `device`."""
    model_path: str = ""
    codec_path: str = ""
    temperature: float = 0.8
    max_tokens: int = 700
    seed: int = 42
    n_ctx: int = 2048
    # streaming policy (commit holdback)
    stream_check_interval: int = 20
    holdback_codes: int = 32
    min_commit_step_codes: int = 24
    # smaller threshold for a stream's FIRST commit only: with the 20-token
    # check, the first commit goes out at 40 codes (target 40 - 32 = 8)
    # instead of 56 (<= 0: the reference's uniform cadence)
    first_commit_codes: int = 8
    chunk_samples: int = 4096
    prompt_bucket: int = 64
    code_bucket: int = 32
    llm_dtype: str = "bfloat16"
    # Speculative decoding: a small draft model of the same vocab (the
    # 0.1B for the 2.6B) proposes `spec_tokens` tokens a round and ONE
    # target forward at M = spec_tokens + 1 verifies them, so the target's
    # weights are read once a round.  The output distribution is exact
    # (models/llm.spec_accept); at temperature <= 0 the tokens are plain
    # greedy decoding's.  Dense models only; streams take the unfused path.
    draft_model_path: str = ""
    spec_tokens: int = 6
    # Fused streaming: a chunk's generation, code append and commit policy
    # are enqueued on the device with no host sync, so the host reads a
    # chunk's outputs while the next chunk runs.  Stage timing: the chunk
    # loop, the codec decodes it enqueues included, is llm_sec;
    # attribute_stages() moves their device-measured share to codec_sec /
    # istft_sec.
    fused_streaming: bool = True
    # Fused chunks enqueued ahead of the host's read: with the stop latch,
    # commit watermark and code buffer on the device, chunk k + 1 is
    # enqueued before chunk k's outputs come back through pinned memory.
    # 1 = synchronous (for A/B measurement).  A commit's decode queues
    # behind the chunk already enqueued on the one CUDA stream.
    stream_pipeline_depth: int = 2
    # 0 = full-prefix re-decode per commit; W > 0 re-decodes only the last
    # W codes (O(T) streaming; the final flush stays full-prefix)
    stream_window_codes: int = 0
    # Read each non-final commit's audio back one check interval (single
    # stream) or one scheduler step (batched serving) later.  Single
    # stream: None or False takes the fused path, True the unfused path
    # with the deferred read.  Batched serving: None = on.
    pipeline_codec: bool | None = None
    # batched serving: ship emission slices as int16 (None = on; False
    # keeps them float-exact)
    i16_transfer: bool | None = None
    device: str = "cuda"
    # the kernel route of every quantized linear (None: from the
    # environment, MIOTTS_QDOT_GEMV / MIOTTS_PACK4_SPLIT / MIOTTS_GEMV_M8)
    qdot_route: QdotRoute | None = None
    # int8 single-stream KV caches (the target's and the draft's); batched
    # serving takes ContinuousBatcher(quantized_kv=), as in the JAX package
    quantized_kv: bool = False
    # TF32 matmuls and convolutions after the codec's prenet
    # (CodecConfig.fast; the env MIOTTS_CODEC_FAST=1 too); the prenet and
    # the iSTFT stay exact f32
    codec_fast: bool = False
    # the codec on CUDA device min(i, count - 1) and its decodes on a CUDA
    # stream of their own there (-1: the LLM's device and stream).  The
    # pipelined codec paths (the unfused stream with pipeline_codec, the
    # batcher's deferred decodes) then overlap the next LLM chunk; on the
    # CPU it changes nothing
    codec_device: int = -1

    @property
    def serving_pipeline_codec(self) -> bool:
        return True if self.pipeline_codec is None else bool(self.pipeline_codec)

    @property
    def serving_i16_transfer(self) -> bool:
        return True if self.i16_transfer is None else bool(self.i16_transfer)


@dataclass
class Options:
    """Per-call overrides (negative sentinel = engine default), the JAX
    package's fields in its order."""
    temperature: float = -1.0
    max_tokens: int = -1
    skip_llm: bool = False
    apply_peak_normalization: bool = True
    seed: int = -1


class VoiceModel:
    """Voice embedding holder: a `.emb.gguf` file, or an embedding array.
    Without either it is not ready (`is_ready` False), as in the JAX
    package."""

    def __init__(self, path: str | None = None,
                 embedding: np.ndarray | None = None):
        self.path = path or ""
        self.embedding = None
        if embedding is not None:
            self.embedding = np.asarray(embedding, np.float32)
        elif path:
            self.embedding = load_voice_embedding(path)
        self._dev_emb: dict[torch.device, torch.Tensor] = {}

    def device_embedding(self, device) -> torch.Tensor:
        """f32 copy of the embedding on `device`, uploaded once."""
        if not self.is_ready:
            raise RuntimeError("voice model is not ready")
        device = torch.device(device)
        if device not in self._dev_emb:
            self._dev_emb[device] = torch.from_numpy(
                np.ascontiguousarray(self.embedding, np.float32)).to(device)
        return self._dev_emb[device]

    @property
    def is_ready(self) -> bool:
        return self.embedding is not None and self.embedding.size > 0


class TTSEngine:
    def __init__(self, config: EngineConfig):
        # the route is resolved once, here
        self.config = replace(config, qdot_route=(config.qdot_route
                                                  or QdotRoute.from_env()))
        self.device = resolve_device(config.device)
        # effective first-commit threshold: <= 0 disables the early first
        # emission; never above min_commit
        self._first_commit = (
            min(config.first_commit_codes, config.min_commit_step_codes)
            if config.first_commit_codes > 0
            else config.min_commit_step_codes)
        self.llm_params = None
        self.llm_cfg: LLMConfig | None = None
        self.tokenizer: Tokenizer | None = None
        self.code_table: np.ndarray | None = None
        self.dtype = (torch.bfloat16 if config.llm_dtype == "bfloat16"
                      else torch.float32)
        if config.model_path:
            with GGUFReader(config.model_path) as r:
                self.llm_cfg = LLMConfig.from_gguf(r)
                params, _ = load_llm_params(
                    r, self.llm_cfg, dtype=self.dtype, device=self.device)
                self.llm_params = with_route(params, self.config.qdot_route)
                self.tokenizer = Tokenizer.from_gguf(r)
            self.code_table = self.tokenizer.speech_code_table()
            # the token -> code table on the device (the fused stream's
            # code append)
            self._code_table_dev = torch.from_numpy(
                self.code_table.astype(np.int64)).to(self.device)
            im_end = self.tokenizer.token_to_id.get("<|im_end|>", -1)
            self._stop_ids = torch.tensor([self.tokenizer.eos_id, im_end],
                                          dtype=torch.int64, device=self.device)
        self.draft_params = None
        self.draft_cfg: LLMConfig | None = None
        self._dcache = None
        self._spec_stats: dict | None = None
        if (config.model_path and config.draft_model_path
                and config.spec_tokens > 0):
            self._load_draft(config.draft_model_path)
        self.codec_device = self.device
        self._codec_stream: torch.cuda.Stream | None = None
        if config.codec_device >= 0 and self.device.type == "cuda":
            self.codec_device = torch.device(
                "cuda", min(config.codec_device, torch.cuda.device_count() - 1))
            self._codec_stream = torch.cuda.Stream(self.codec_device)
        with GGUFReader(config.codec_path) as r:
            self.codec_params, self.codec_cfg = load_codec_params(
                r, device=self.codec_device)
        if config.codec_fast:
            self.codec_cfg = replace(self.codec_cfg, fast=True)
        self.sample_rate = self.codec_cfg.sample_rate
        self.samples_per_token = self.codec_cfg.samples_per_token
        # one KV cache reused across requests (prefill overwrites it and
        # `fill` masks the rest); reallocated when the size bucket changes
        self._cache = None

    def _load_draft(self, path: str) -> None:
        """Load the speculative draft model on the engine's device and
        dtype, its linears on the engine's route.  Raises ValueError for a
        vocab other than the target's, or a hybrid target or draft (their
        short-conv state advances on every forward and cannot roll back
        with `fill`)."""
        with GGUFReader(path) as r:
            self.draft_cfg = LLMConfig.from_gguf(r)
            params, _ = load_llm_params(r, self.draft_cfg, dtype=self.dtype,
                                        device=self.device)
        if self.draft_cfg.n_vocab != self.llm_cfg.n_vocab:
            raise ValueError(
                f"draft vocab ({self.draft_cfg.n_vocab}) != target vocab "
                f"({self.llm_cfg.n_vocab}): speculative decoding needs a "
                f"draft of the same tokenizer")
        if self.llm_cfg.layer_types or self.draft_cfg.layer_types:
            raise ValueError(
                "speculative decoding supports dense attention models only "
                "(a hybrid model's conv state cannot roll back)")
        self.draft_params = with_route(params, self.config.qdot_route)

    def with_qdot_route(self, route: QdotRoute) -> "TTSEngine":
        """Another engine over this one's loaded weights, codec and
        tokenizer (shared, not copied) whose quantized linears, the
        draft's included, take `route`, with KV caches of its own."""
        eng = copy.copy(self)
        eng.config = replace(self.config, qdot_route=route)
        eng.llm_params = with_route(self.llm_params, route)
        if self.draft_params is not None:
            eng.draft_params = with_route(self.draft_params, route)
        eng._cache = eng._dcache = eng._spec_stats = None
        return eng

    def route_line(self) -> str:
        """One line naming the switches this engine runs under: the qdot
        route (`xla=True` under MIOTTS_FORCE_XLA_QDOT), how many quantized
        linears hold packed 4-bit values (none under MIOTTS_NO_PACK4), the
        attention merge (MIOTTS_ATTN_NOCAT, read now as `_attend` reads it
        at every call), the LLM's dtype, the KV cache and the codec mode.
        The group scales' dtypes follow the linears' count (bf16 under
        MIOTTS_SCALE_BF16)."""
        qts = [t for t in _leaves(self.llm_params) if isinstance(t, QTensor)]
        kv = "int8" if self.config.quantized_kv else str(self.dtype)[6:]
        scales = "/".join(sorted({str(t.scales.dtype)[6:] for t in qts}))
        return (f"engine: route {self.config.qdot_route}; packed 4-bit "
                f"linears {sum(t.packed for t in qts)} of {len(qts)}"
                f"{f' (scales {scales})' if qts else ''}; "
                f"attention "
                f"{'nocat' if os.environ.get('MIOTTS_ATTN_NOCAT') else 'cat'}"
                f"; llm {str(self.dtype)[6:]}; kv cache {kv}; codec "
                f"{'fast' if codec_fast(self.codec_cfg) else 'exact'}")

    def with_draft(self, path: str, spec_tokens: int | None = None
                   ) -> "TTSEngine":
        """Another engine over this one's loaded weights, codec and
        tokenizer (shared, not copied) with the draft model at `path`
        proposing `spec_tokens` a round ("" for none: plain decoding), with
        KV caches of its own: plain and speculative decoding over one load.
        The draft is loaded on this engine's device, dtype and route, or
        shared when this engine has it loaded already."""
        if self.llm_params is None:
            raise RuntimeError("LLM model is not loaded")
        k = self.config.spec_tokens if spec_tokens is None else spec_tokens
        eng = copy.copy(self)
        eng.config = replace(self.config, draft_model_path=path,
                             spec_tokens=k)
        eng._cache = eng._dcache = eng._spec_stats = None
        if not (path and k > 0):
            eng.draft_params = eng.draft_cfg = None
        elif path != self.config.draft_model_path or self.draft_params is None:
            eng._load_draft(path)
        return eng

    def _cache_len(self, bucket: int, max_tok: int) -> int:
        """The KV cache's size bucket for a prompt bucket and a budget: a
        geometric bucket of prompt + budget + one chunk (decode attention
        reads the whole cache length every step), with a speculative
        round's overshoot (spec_tokens + 8) when a draft is loaded, clamped
        to n_ctx."""
        need = bucket + max_tok + 64
        if self.draft_params is not None:
            need += self.config.spec_tokens + 8
        return min(_bucket_len(need, 256), self.config.n_ctx)

    def _code_buckets(self, max_codes: int, first: int) -> list[int]:
        """The geometric code buckets from the one holding `first` codes up
        to the first >= max_codes."""
        out = [_bucket_len(first, self.config.code_bucket)]
        while out[-1] < max_codes:
            out.append(out[-1] * 2)
        return out

    def warmup(self, max_codes: int | None = None,
               prompt_len: int = 64) -> None:
        """Run every path a synthesis takes once, before a timed one: the
        codec + iSTFT at every code bucket up to `max_codes`, the prefill
        bucket of `prompt_len`, the chunk loop at both chunk sizes (the
        stream check interval and the offline 64) and the fused streaming
        step at each full-mode code bucket (the one window bucket in window
        mode).  With a draft model the draft's prefill and one speculative
        chunk at both chunk sizes take the place of the chunk loop and the
        fused step, which a speculative engine never runs.  On a GPU this
        builds the CUDA kernels, sets up cuDNN's plans and primes the
        caching allocator, so none of it lands in a stream's time to first
        audio.  After each chunk size a codec decode at the smallest bucket
        runs too, as a stream interleaves them.  With MIOTTS_WARMUP_VERBOSE
        set, each stage's seconds go to stderr as `warmup: <label>: <s>s`
        with the JAX package's labels, timed after the engine's devices
        are synchronised."""
        cfgE = self.config
        dev = self.device
        cdev = self.codec_device
        verbose = bool(os.environ.get("MIOTTS_WARMUP_VERBOSE"))
        t_prev = [time.perf_counter()]

        def mark(label: str) -> None:
            if verbose:
                _sync(dev)
                _sync(cdev)
                now = time.perf_counter()
                print(f"warmup: {label}: {now - t_prev[0]:.1f}s",
                      file=sys.stderr, flush=True)
                t_prev[0] = now

        emb = torch.zeros(self.codec_cfg.adaln_dim, device=cdev)
        if max_codes is None:
            max_codes = cfgE.max_tokens
        for T in self._code_buckets(max_codes, 1):
            self._codec_audio(torch.zeros(T, dtype=torch.int64, device=cdev),
                              emb, min(T, max_codes))
            mark(f"codec bucket T={T}")
        if self.llm_params is None:
            _sync(dev)
            return
        cfg = self.llm_cfg
        bucket_p = _round_up(prompt_len, cfgE.prompt_bucket)
        # the cache-size bucket rule of generate_tokens
        s_cache = self._cache_len(bucket_p, cfgE.max_tokens)
        cache = init_kv_cache(cfg, 1, s_cache, dtype=self.dtype, device=dev,
                              quantized=cfgE.quantized_kv,
                              n_kv_heads=kv_heads(self.llm_params, cfg))
        toks = torch.zeros((1, bucket_p), dtype=torch.int64, device=dev)
        n_real = torch.tensor([8], dtype=torch.int32)
        last, cache = llm_prefill(self.llm_params, toks, n_real, cache, cfg)
        mark(f"llm prefill bucket={bucket_p}")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        chunk = cfgE.stream_check_interval
        if self.draft_params is not None:
            # with a draft every generation is speculative: the plain chunk
            # and the fused step never run
            dcache = init_kv_cache(self.draft_cfg, 1, s_cache,
                                   dtype=self.dtype, device=dev,
                                   quantized=cfgE.quantized_kv)
            _, dcache = llm_prefill(self.draft_params, toks, n_real, dcache,
                                    self.draft_cfg)
            pending = torch.zeros((1,), dtype=torch.int64, device=dev)
            K = cfgE.spec_tokens
            for n in sorted({chunk, OFFLINE_CHUNK}):
                _, _, _, pending, cache, dcache, _, _ = llm_generate_chunk_spec(
                    self.llm_params, self.draft_params, pending, cache,
                    dcache, 1.0, self._stop_ids, cfg, self.draft_cfg,
                    -(-n // (K + 1)), K, generator=gen,
                    force_p=self._spec_force_p())
                mark(f"spec chunk={n} (k={K})")
            self._dcache = dcache
        else:
            codes_w = torch.zeros(cfgE.code_bucket, dtype=torch.int64,
                                  device=cdev)
            for n in sorted({chunk, OFFLINE_CHUNK}):
                _, _, _, last, cache = llm_generate_chunk(
                    self.llm_params, last, cache, 1.0, self._stop_ids, cfg,
                    n, gen)
                self._codec_spec(codes_w, emb, 1)
                mark(f"llm chunk={n} + codec interleave")
            if cfgE.fused_streaming:
                win = cfgE.stream_window_codes > 0
                buckets = ([self._window_bucket()] if win
                           else self._code_buckets(max_codes, chunk))
                for b in buckets:
                    st = self._fused_state(last, cache, b)
                    self._fused_chunk(st, chunk, 1.0, gen, b, win, 1 << 30)
                    last, cache = st["last"], st["cache"]
                    mark(f"fused stream step bucket={b}")
        _sync(dev)
        self._cache = cache

    def attribute_stages(self, profile: StreamProfile,
                         reps: int = 8) -> StreamProfile:
        """Device-measured codec / iSTFT split for a fused stream's profile
        (the reference's per-stage contract, `stream-benchmark.cpp:163-166`,
        which the fused path's single chunk-loop timer otherwise folds into
        llm_sec).  Times the codec and the iSTFT alone at each code bucket
        in `profile.decode_bucket_codes` (the standalone measurement, not
        events around the stream's own decodes): `reps` back-to-back calls
        between CUDA events on a GPU (host clock on the CPU), and moves
        that time times the bucket's decode count from llm_sec to codec_sec
        / istft_sec; the stage sum is kept.  Runs after a timed stream, so
        it never adds to its latency; a second call does nothing
        (`stages_calibrated`).  A measurement that reads 0 is retried with
        4x the reps; reading 0 again clears `stages_trusted`."""
        if profile.stages_calibrated or not profile.decode_bucket_codes:
            return profile
        dev = self.codec_device
        emb = torch.zeros(self.codec_cfg.adaln_dim, device=dev)

        def timed(fn, n: int) -> float:
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    fn()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) * 1e-3 / n
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n

        def measured(fn) -> float:
            fn()
            _sync(dev)
            dt = timed(fn, reps)
            if dt <= 0.0:
                dt = timed(fn, 4 * reps)
                if dt <= 0.0:
                    profile.stages_trusted = False
            return max(dt, 0.0)

        codec_total = istft_total = 0.0
        for b, n_calls in sorted(Counter(profile.decode_bucket_codes).items()):
            codes = torch.zeros(b, dtype=torch.int64, device=dev)
            lm, ph = self._codec_spec(codes, emb, b)
            codec_total += n_calls * measured(
                lambda: self._codec_spec(codes, emb, b))
            istft_total += n_calls * measured(
                lambda: self._spec_to_audio(lm, ph, b))
        moved = codec_total + istft_total
        cap = 0.9 * profile.llm_sec
        if moved > cap > 0:
            # the standalone measurement exceeds what the chunk loop can
            # hold (noise): scale it down, never to a free LLM stage
            scale = cap / moved
            codec_total *= scale
            istft_total *= scale
            moved = cap
        elif profile.llm_sec <= 0:
            return profile
        profile.llm_sec -= moved
        profile.codec_sec += codec_total
        profile.istft_sec += istft_total
        profile.stages_calibrated = True
        return profile

    # ------------------------------------------------------------------
    # LLM: speech-token generation
    # ------------------------------------------------------------------

    def _resolve(self, options: Options) -> tuple[float, int, int]:
        c = self.config
        temp = options.temperature if options.temperature >= 0 else c.temperature
        max_tok = options.max_tokens if options.max_tokens > 0 else c.max_tokens
        seed = options.seed if options.seed >= 0 else c.seed
        return temp, max_tok, seed

    def _prefill(self, text: str, max_tok: int):
        """Tokenize `text`'s prompt, clamp the budget to n_ctx and prefill
        the reused cache, and the draft's reused cache of the same size
        when a draft is loaded.  Returns (last_logits, cache, max_tok,
        draft cache or None)."""
        cfgE = self.config
        dev = self.device
        prompt = build_prompt(normalize_tts_text(text))
        ids = self.tokenizer.encode(prompt, add_special=True,
                                    parse_special=True)
        n = len(ids)
        if n + max_tok > cfgE.n_ctx:
            max_tok = max(0, cfgE.n_ctx - n)
        if self.draft_params is not None:
            # a speculative round writes positions fill .. fill + k before
            # its rollback: reserve them below n_ctx
            max_tok = max(0, min(max_tok,
                                 cfgE.n_ctx - n - (cfgE.spec_tokens + 1)))
        bucket = _round_up(n, cfgE.prompt_bucket)
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n] = torch.tensor(ids, dtype=torch.int64)
        s_cache = self._cache_len(bucket, max_tok)
        heads = kv_heads(self.llm_params, self.llm_cfg)
        if (self._cache is None or self._cache["k"].shape[3] != s_cache
                or self._cache["k"].shape[2] != heads):
            self._cache = init_kv_cache(
                self.llm_cfg, 1, s_cache, dtype=self.dtype, device=dev,
                quantized=cfgE.quantized_kv, n_kv_heads=heads)
        cache = dict(self._cache,
                     fill=torch.zeros((1,), dtype=torch.int32, device=dev))
        if "conv" in cache:
            # a hybrid model's conv state holds the previous request's last
            # inputs, and the prefill starts from it: clear it (`fill`
            # alone masks the old k / v, nothing masks this state)
            cache["conv"].zero_()
        toks = toks.to(dev)
        n_real = torch.tensor([n], dtype=torch.int32)
        last, cache = llm_prefill(self.llm_params, toks, n_real, cache,
                                  self.llm_cfg)
        if self.draft_params is None:
            return last, cache, max_tok, None
        if self._dcache is None or self._dcache["k"].shape[3] != s_cache:
            self._dcache = init_kv_cache(self.draft_cfg, 1, s_cache,
                                         dtype=self.dtype, device=dev,
                                         quantized=cfgE.quantized_kv)
        dcache = dict(self._dcache,
                      fill=torch.zeros((1,), dtype=torch.int32, device=dev))
        _, dcache = llm_prefill(self.draft_params, toks, n_real, dcache,
                                self.draft_cfg)
        return last, cache, max_tok, dcache

    def generate_tokens(self, text: str, options: Options = Options(),
                        on_token=None, profile: StreamProfile | None = None
                        ) -> list[int]:
        """LLM token ids for `text`.  `on_token(tid, n_generated)` is called
        for each token as its chunk arrives (chunks of
        `stream_check_interval` steps when it is given, else 64) and may
        return False to stop, as in the JAX package.  No chunk runs past
        the budget: the last one is cut to the tokens left, so no step
        writes past the last cache column when the budget was clamped to
        n_ctx.  With `profile`, fills prefill_sec, llm_sec (the chunk
        loop), llm_tokens, decode_steps and token_ids, synchronising the
        device after the prefill (the draft's prefill included).  With a
        draft model loaded, the tokens come from `_spec_loop`."""
        if self.llm_params is None or self.tokenizer is None:
            raise RuntimeError("LLM model is not loaded")
        temp, max_tok, seed = self._resolve(options)
        dev = self.device
        t0 = time.perf_counter()
        last, cache, max_tok, dcache = self._prefill(text, max_tok)
        if profile is not None:
            _sync(dev)
            profile.prefill_sec += time.perf_counter() - t0

        chunk = (self.config.stream_check_interval if on_token is not None
                 else OFFLINE_CHUNK)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if dcache is not None and max_tok > 0:
            return self._spec_loop(last, cache, dcache, temp, gen, chunk,
                                   max_tok, on_token, profile)
        generated: list[int] = []
        stopped = False
        while len(generated) < max_tok and not stopped:
            t1 = time.perf_counter()
            n_steps = min(chunk, max_tok - len(generated))
            buf, cnt, done, last, cache = llm_generate_chunk(
                self.llm_params, last, cache, temp, self._stop_ids,
                self.llm_cfg, n_steps, gen)
            # the chunk's one host read: tokens, count and stop flag
            host = torch.cat([buf, cnt[None], done[None].long()]).cpu().numpy()
            if profile is not None:
                profile.llm_sec += time.perf_counter() - t1
                profile.decode_steps += n_steps
            stopped = bool(host[n_steps + 1])
            for t in host[:int(host[n_steps])]:
                generated.append(int(t))
                if profile is not None:
                    profile.llm_tokens = len(generated)
                    profile.token_ids.append(int(t))
                if on_token is not None and not on_token(int(t),
                                                         len(generated)):
                    stopped = True
                    break
        self._cache = cache
        return generated

    @staticmethod
    def _spec_force_p() -> float | None:
        """MIOTTS_SPEC_FORCE_ACCEPT as a float, None when unset: the
        forced-acceptance measurement harness of `spec_accept`, read at
        each call, as the JAX package's engine reads it.  Never set outside
        a measurement: the tokens are then not the target's."""
        v = os.environ.get("MIOTTS_SPEC_FORCE_ACCEPT", "")
        return float(v) if v else None

    def _spec_loop(self, last, cache, dcache, temp: float, gen, chunk: int,
                   max_tok: int, on_token, profile) -> list[int]:
        """Speculative generation (`llm_generate_chunk_spec`) after both
        prefills: the first token is drawn on the host from the target's
        own distribution, then chunks of draft-propose / target-verify
        rounds follow.  At temperature <= 0 the tokens are plain greedy
        decoding's; above it their distribution is exact but the draws
        differ from the plain loop's.

        A chunk runs ceil(min(chunk, tokens left) / (k + 1)) rounds: the
        most that can never start past `chunk` tokens, since each active
        round emits 1 to k + 1.  The chunk's token limit and the budget
        left stay on the device, so a round past either, or after a stop,
        runs masked.  Depth-2 dispatch: the next chunk is enqueued before
        this one's tokens are read back (through pinned memory behind an
        event), unless this one may spend the budget.  The acceptance
        counts land in self._spec_stats (rounds, accepted, drafted);
        profile.decode_steps counts the rounds the device ran, masked ones
        included (each k + 1 draft steps and one verify)."""
        cfgE = self.config
        K = cfgE.spec_tokens
        dev = self.device
        force_p = self._spec_force_p()
        stats = self._spec_stats = {"rounds": 0, "accepted": 0, "drafted": 0}
        generated: list[int] = []

        def emit(tid: int) -> bool:
            generated.append(tid)
            if profile is not None:
                profile.llm_tokens = len(generated)
                profile.token_ids.append(tid)
            return on_token is None or on_token(tid, len(generated))

        t1 = time.perf_counter()
        pending = sample_token(last, temp, gen)
        tid0 = int(pending[0])
        if profile is not None:
            profile.llm_sec += time.perf_counter() - t1
        st = dict(pending=pending, cache=cache, dcache=dcache,
                  done=torch.zeros((), dtype=torch.bool, device=dev),
                  left=torch.full((), max_tok - 1, dtype=torch.int64,
                                  device=dev))

        def dispatch(bound: int):
            """Enqueue one chunk for at most `bound` tokens (a host-side
            upper bound of the budget left); returns (readback, rounds)."""
            n_rounds = -(-max(1, min(chunk, bound)) // (K + 1))
            buf, cnt, done, pending, cache, dcache, rounds, acc = (
                llm_generate_chunk_spec(
                    self.llm_params, self.draft_params, st["pending"],
                    st["cache"], st["dcache"], temp, self._stop_ids,
                    self.llm_cfg, self.draft_cfg, n_rounds, K,
                    limit=st["left"].clamp(max=chunk), generator=gen,
                    force_p=force_p, done=st["done"]))
            st.update(pending=pending, cache=cache, dcache=dcache, done=done,
                      left=st["left"] - cnt)
            if profile is not None:
                profile.decode_steps += n_rounds
            return _Readback(torch.cat(
                [buf, torch.stack([cnt, done.long(), rounds, acc])])), n_rounds

        # a stop token first: nothing is emitted
        stopped = tid0 in self._stop_ids.tolist() or not emit(tid0)
        inflight: list = []
        while not stopped and len(generated) < max_tok:
            t1 = time.perf_counter()
            if not inflight:
                inflight.append(dispatch(max_tok - len(generated)))
            _, r_cur = inflight[0]
            if len(generated) + r_cur * (K + 1) < max_tok:
                # this chunk cannot spend the budget: enqueue the next
                # behind it (it emits at least one token a round)
                inflight.append(dispatch(max_tok - len(generated) - r_cur))
            rb, _ = inflight.pop(0)
            h = rb.get()[0]
            cnt, done, rounds, acc = (int(v) for v in h[-4:])
            if profile is not None:
                profile.llm_sec += time.perf_counter() - t1
            stats["rounds"] += rounds
            stats["accepted"] += acc
            stats["drafted"] += rounds * K
            take = min(cnt, max_tok - len(generated))
            stopped = bool(done)
            for tid in h[:take]:
                if not emit(int(tid)):
                    stopped = True
                    break
        # a chunk still in flight writes past the kept fill of both caches
        # only, which the next prefill resets
        self._cache = st["cache"]
        self._dcache = st["dcache"]
        return generated

    def generate_token_text(self, text: str,
                            options: Options = Options()) -> str:
        """Token-text output (the reference's `generate_token_text`): the
        generated ids detokenized, or `text` itself under skip_llm."""
        if options.skip_llm:
            return text
        return self.tokenizer.decode(self.generate_tokens(text, options))

    def tokens_to_codes(self, token_ids: list[int]) -> list[int]:
        """Sampled token ids -> codec codes via the vocab table."""
        t = self.code_table
        return [int(t[i]) for i in token_ids if 0 <= i < len(t) and t[i] >= 0]

    # ------------------------------------------------------------------
    # Codec: codes -> audio (bucketed)
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _codec_ctx(self, *produced: torch.Tensor):
        """The codec's stream for the decodes enqueued inside (a no-op
        without `codec_device`).  `produced`: tensors that the LLM's
        (current) stream wrote and the decode reads; the codec stream waits
        on an event recorded after them, and each is marked as used on the
        codec stream (record_stream), so that the caching allocator does
        not hand its memory out while the decode may still read it.  What
        is allocated inside belongs to the codec stream: read it through
        `codec_readback`.  The codec's TF32 flags are set and restored on
        this one host thread, around the enqueue."""
        s = self._codec_stream
        if s is None:
            yield
            return
        if produced:
            ev = torch.cuda.Event()
            ev.record()
            s.wait_event(ev)
            for t in produced:
                t.record_stream(s)
        with torch.cuda.stream(s):
            yield

    def codec_readback(self, *tensors: torch.Tensor) -> _Readback:
        """A readback of decode outputs that waits for the codec's stream
        (the current stream without `codec_device`)."""
        return _Readback(*tensors, stream=self._codec_stream)

    def _codec_emb(self, voice: VoiceModel) -> torch.Tensor:
        """The voice embedding on the codec's device, marked as used on the
        codec stream."""
        emb = voice.device_embedding(self.codec_device)
        if self._codec_stream is not None:
            emb.record_stream(self._codec_stream)
        return emb

    def _padded_codes(self, codes) -> tuple[torch.Tensor, int]:
        """codes -> (the codes zero-padded to their bucket, on the codec's
        device; T).  On a GPU the upload goes through pinned memory and does
        not wait: a copy from pageable memory synchronises the stream."""
        codes = np.asarray(codes, np.int32).reshape(-1)
        T = len(codes)
        padded = np.zeros(_bucket_len(T, self.config.code_bucket), np.int32)
        padded[:T] = codes
        return _upload(padded, self.codec_device), T

    def _count(self, n: int) -> torch.Tensor:
        """A code count as a 0-d tensor filled on the device, for a decode
        that must not wait: a Python int would go up by a blocking copy."""
        return torch.full((), n, dtype=torch.int64, device=self.codec_device)

    def _codec_spec(self, codes: torch.Tensor, emb: torch.Tensor, n_real):
        return codec_decode_spec(self.codec_params, codes, emb, self.codec_cfg,
                                 n_real=n_real)

    def _spec_to_audio(self, log_mag, phase, n_real) -> torch.Tensor:
        """The iSTFT in exact f32 (TF32 off, as codec_decode_spec does for
        the codec, fast mode or not): every caller goes through here."""
        cfg = self.codec_cfg
        p = self.codec_params
        with torch.no_grad(), exact_f32():
            return spec_to_audio_bucketed(
                log_mag, phase, p["istft_cos_basis"], p["istft_sin_basis"],
                p["istft_hann"], cfg.hop_length, cfg.total_upsample, n_real)

    def _codec_audio(self, codes: torch.Tensor, emb: torch.Tensor,
                     n_real) -> torch.Tensor:
        """Codec + iSTFT of bucketed codes on the device, not waited for."""
        return self._spec_to_audio(*self._codec_spec(codes, emb, n_real),
                                   n_real)

    def decode_codes(self, codes, voice: VoiceModel,
                     apply_peak_normalization: bool = True,
                     profile: StreamProfile | None = None) -> np.ndarray:
        """codes -> float PCM of exactly T * samples_per_token samples,
        decoded in a power-of-2 bucket with the padding masked out and
        (unless told otherwise) peak-normalised to 0.95 on the host.  With
        `profile`, fills codec_sec and istft_sec (the device synchronised
        between them), decode_calls and decoded_codes."""
        if not voice.is_ready:
            raise RuntimeError("voice model is not ready")
        if len(codes) == 0:
            return np.zeros(0, np.float32)
        with self._codec_ctx():
            codes_dev, T = self._padded_codes(codes)
            t0 = time.perf_counter()
            n_real = self._count(T)
            log_mag, phase = self._codec_spec(codes_dev, self._codec_emb(voice),
                                              n_real)
            if profile is not None:
                _sync(self.codec_device)
            t1 = time.perf_counter()
            audio = self._spec_to_audio(log_mag, phase, n_real)
            audio = audio[: T * self.samples_per_token].cpu().numpy()
        if profile is not None:
            profile.codec_sec += t1 - t0
            profile.istft_sec += time.perf_counter() - t1
            profile.decode_calls += 1
            profile.decoded_codes += T
        if apply_peak_normalization:
            peak = float(np.max(np.abs(audio)))
            if peak > 1e-8:
                audio = audio * (0.95 / peak)
        return audio.astype(np.float32)

    def decode_codes_async(self, codes, voice: VoiceModel):
        """Enqueue a bucketed codec + iSTFT decode without waiting for it (no
        host sync).  Returns (audio on the device, T): its first T *
        samples_per_token samples are the decode.  With `codec_device` it
        runs on the codec stream: read it through `codec_readback`."""
        with self._codec_ctx():
            codes_dev, T = self._padded_codes(codes)
            return self._codec_audio(codes_dev, self._codec_emb(voice),
                                     self._count(T)), T

    def _codec_audio_sliced(self, codes_b, embs_b, n_real_b, starts_b,
                            emit_len: int, to_i16: bool) -> torch.Tensor:
        """Batched codec + iSTFT returning ONLY each row's emission slice
        audio[b, starts[b] : starts[b] + emit_len] (starts pre-clamped to
        [0, total - emit_len]), as int16 with `to_i16` (scale, clamp,
        truncate: audio.wav.f32_to_s16's semantics), else f32."""
        audio = self._codec_audio(codes_b, embs_b, n_real_b)
        idx = starts_b[:, None] + torch.arange(emit_len, device=audio.device)
        out = audio.gather(1, idx)
        if to_i16:
            out = torch.clamp(out * 32767.0, -32768, 32767).to(torch.int16)
        return out

    def decode_codes_batch_sliced_async(self, codes_list: list, voices: list,
                                        begins: list, ends: list,
                                        i16: bool | None = None):
        """Batched codec decode that enqueues ONLY each stream's emission
        slice [begins[i], ends[i]) (sample offsets relative to the decoded
        window) and does not wait for it.  The batch pads to a bucket
        (powers of two up to 16, then multiples of 16) with zero-length
        rows, and the slice length to multiples of 8 codes of audio, as in
        the JAX package (`_slice_plan`).  int16 slices where `i16` (None:
        serving_i16_transfer), else f32.  Returns (audio [B, E] on the
        device, offsets, n_samples): row i's samples are audio[i, offsets[i]
        : offsets[i] + n_samples[i]].  With `codec_device` it runs on the
        codec stream: read it through `codec_readback`."""
        assert len(codes_list) == len(voices) == len(begins) == len(ends)
        cfg = self.codec_cfg
        lens = [len(c) for c in codes_list]
        bucket = _bucket_len(max(lens), self.config.code_bucket)
        B, E, starts, offs, n_samp = _slice_plan(
            lens, begins, ends, bucket, cfg.samples_per_token)
        padded = np.zeros((B, bucket), np.int32)
        embs = np.zeros((B, cfg.adaln_dim), np.float32)
        for i, (c, v) in enumerate(zip(codes_list, voices)):
            padded[i, :lens[i]] = np.asarray(c, np.int32)
            embs[i] = v.embedding
        lens_arr = np.ones((B,), np.int64)
        lens_arr[:len(lens)] = lens
        starts_arr = np.zeros((B,), np.int64)
        starts_arr[:len(starts)] = starts
        dev = self.codec_device
        with self._codec_ctx():
            audio = self._codec_audio_sliced(
                _upload(padded, dev), _upload(embs, dev),
                _upload(lens_arr, dev), _upload(starts_arr, dev), E,
                self.config.serving_i16_transfer if i16 is None else i16)
        return audio, offs, n_samp

    def decode_codes_batch_sliced(self, codes_list: list, voices: list,
                                  begins: list, ends: list,
                                  profile: StreamProfile | None = None,
                                  i16: bool | None = None) -> list:
        """Synchronous form of decode_codes_batch_sliced_async: a list of
        float PCM arrays, exactly ends[i] - begins[i] samples each (clipped
        to the decoded length)."""
        t0 = time.perf_counter()
        audio, offs, n_samp = self.decode_codes_batch_sliced_async(
            codes_list, voices, begins, ends, i16)
        a = self.codec_readback(audio).get()[0]
        if a.dtype == np.int16:
            a = a.astype(np.float32) / 32767.0
        if profile:
            profile.codec_sec += time.perf_counter() - t0
            profile.decode_calls += 1
            profile.decoded_codes += sum(len(c) for c in codes_list)
        return [a[i, offs[i]:offs[i] + n_samp[i]] for i in range(len(offs))]

    def decode_code_rows_sliced(self, codes_buf: torch.Tensor,
                                embs: torch.Tensor, rows: list,
                                n_codes: list, begins: list,
                                ends: list) -> list:
        """The fused batch step's decode (`_fused_batch_step`): rows `rows`
        of the device code buffer codes_buf [B, bucket] (each row's first
        n_codes[i] codes real) with their embeddings embs [B, adaln_dim],
        decoded over the full prefix, and only each row's f32 slice
        [begins[i], ends[i]) read back (`_slice_plan`'s shapes).  The rows
        are gathered on the LLM's stream, which may write the buffer again
        after the gather.  Returns one float PCM array per row."""
        spt = self.codec_cfg.samples_per_token
        B, E, starts, offs, n_samp = _slice_plan(
            n_codes, begins, ends, codes_buf.shape[1], spt)
        pad = B - len(rows)
        idx = _upload(np.asarray(rows + rows[:1] * pad, np.int64),
                      codes_buf.device)
        codes_b = codes_buf.index_select(0, idx).to(self.codec_device)
        embs_b = embs.index_select(0, idx).to(self.codec_device)
        dev = self.codec_device
        with self._codec_ctx(codes_b, embs_b):
            audio = self._codec_audio_sliced(
                codes_b, embs_b,
                _upload(np.asarray(n_codes + [1] * pad, np.int64), dev),
                _upload(np.asarray(starts + [0] * pad, np.int64), dev), E,
                False)
        a = self.codec_readback(audio).get()[0]
        return [a[i, offs[i]:offs[i] + n_samp[i]] for i in range(len(rows))]

    # ------------------------------------------------------------------
    # Offline synthesis
    # ------------------------------------------------------------------

    def synthesize(self, voice: VoiceModel, text: str,
                   options: Options = Options(),
                   profile: StreamProfile | None = None) -> np.ndarray:
        """Offline text -> PCM.  With skip_llm, `text` is `<|s_N|>` token
        text decoded as it is."""
        if options.skip_llm:
            codes = parse_speech_tokens(text)
        else:
            codes = self.tokens_to_codes(
                self.generate_tokens(text, options, profile=profile))
        if not codes:
            raise RuntimeError("no speech codes generated")
        return self.decode_codes(codes, voice,
                                 options.apply_peak_normalization, profile)

    def synthesize_to_file(self, voice: VoiceModel, text: str, path: str,
                           options: Options = Options(),
                           profile: StreamProfile | None = None) -> None:
        from ..audio.wav import wav_write
        wav_write(path, self.synthesize(voice, text, options, profile),
                  self.sample_rate)

    # ------------------------------------------------------------------
    # Streaming synthesis
    # ------------------------------------------------------------------

    def synthesize_stream(self, voice: VoiceModel, text: str,
                          callback: StreamCallback,
                          chunk_samples: int = 0,
                          options: Options = Options(),
                          profile: StreamProfile | None = None) -> bool:
        """Streaming synthesis with the reference commit policy
        (`synthesize_stream_profiled`, `test-to-speech.cpp:348-626`): an
        emit check every `stream_check_interval` tokens, `holdback_codes`
        held back, commits of >= `min_commit_step_codes` (the first of >=
        `first_commit_codes`), the full-prefix re-decode (or the trailing
        `stream_window_codes`), the actual-ratio sample mapping, ~30 ms
        crossfades, chunked callbacks, no peak normalisation.  The callback
        returns False to abort; the stream then returns False with no
        further callback.  Returns True when the last sample went out with
        is_last."""
        if profile is None:
            profile = StreamProfile()
        t_total0 = time.perf_counter()
        if callback is None:
            return False
        if chunk_samples <= 0:
            chunk_samples = self.config.chunk_samples
        sr = self.sample_rate
        tail = np.zeros(0, np.float32)

        def timed_callback(samples, is_last):
            t0 = time.perf_counter()
            ok = callback(samples, sr, is_last)
            profile.callback_sec += time.perf_counter() - t0
            if samples is not None and profile.first_audio_sec < 0:
                profile.first_audio_sec = time.perf_counter() - t_total0
            return ok

        def send(chunk, is_last):
            if not timed_callback(chunk, is_last):
                return False
            profile.emitted_samples += chunk.size
            return True

        def emit_range(audio: np.ndarray, begin: int, end: int,
                       is_final: bool) -> bool:
            nonlocal tail
            if begin >= end:
                return timed_callback(None, True) if is_final else True
            ok, tail = emit_chunks(audio, begin, end, is_final, tail,
                                   chunk_samples, sr, send)
            return ok

        if options.skip_llm:
            codes0 = parse_speech_tokens(text)
            if not codes0:
                # the reference: the decode fails on an empty parse, and no
                # final callback comes (test-to-speech.cpp:419-423)
                profile.total_sec = time.perf_counter() - t_total0
                return False
            audio = self.decode_codes(codes0, voice,
                                      apply_peak_normalization=False,
                                      profile=profile)
            ok = emit_range(audio, 0, len(audio), True)
            profile.total_sec = time.perf_counter() - t_total0
            return ok

        if (self.config.fused_streaming and self.llm_params is not None
                and not self.config.pipeline_codec
                and self.draft_params is None):
            ok = self._stream_fused(voice, text, emit_range, timed_callback,
                                    options, profile)
            profile.total_sec = time.perf_counter() - t_total0
            return ok

        committed = 0
        codes: list[int] = []
        # pipelined mode: each non-final commit's audio is read back (on the
        # codec stream with codec_device) by the NEXT emit check, one check
        # interval later
        pipeline = bool(self.config.pipeline_codec)
        spt = self.samples_per_token
        pending: list = []            # [(readback, T, begin, end)]

        def flush_pending() -> bool:
            if not pending:
                return True
            rb, n_dec, begin, end = pending.pop()
            t0 = time.perf_counter()
            audio = rb.get()[0][: n_dec * spt]
            profile.codec_sec += time.perf_counter() - t0
            return emit_range(audio, begin, end, False)

        def maybe_emit(is_final: bool) -> bool:
            nonlocal committed
            if not codes:
                return not is_final
            target = len(codes) if is_final else max(
                len(codes) - self.config.holdback_codes, 0)
            if target <= committed:
                if is_final:
                    if not flush_pending():
                        return False
                    return timed_callback(None, True)
                return True
            min_eff = (self._first_commit if committed == 0
                       else self.config.min_commit_step_codes)
            if not is_final and (target - committed) < min_eff:
                return True
            # the full prefix, or (stream_window_codes > 0) the trailing
            # window, re-decoded
            window = self.config.stream_window_codes
            start = 0
            if window > 0 and not is_final:
                start = max(0, min(committed, len(codes) - window))
            if pipeline and not is_final:
                # enqueue this decode, then emit the PREVIOUS one's audio
                audio_dev, n_dec = self.decode_codes_async(codes[start:],
                                                           voice)
                profile.decode_calls += 1
                profile.decoded_codes += n_dec
                ok = flush_pending()
                pending.append((self.codec_readback(audio_dev), n_dec,
                                (committed - start) * spt,
                                (target - start) * spt))
                committed = target
                return ok
            if not flush_pending():
                return False
            audio = self.decode_codes(codes[start:], voice,
                                      apply_peak_normalization=False,
                                      profile=profile)
            spc = len(audio) / (len(codes) - start)
            begin = int(round((committed - start) * spc))
            end = int(round((target - start) * spc))
            safe_end = min(end, len(audio))
            if begin >= safe_end:
                return timed_callback(None, True) if is_final else True
            committed = target
            return emit_range(audio, begin, safe_end, is_final)

        ok_holder = {"ok": True}
        table = self.code_table

        def on_token(tid: int, n_gen: int) -> bool:
            if 0 <= tid < len(table) and table[tid] >= 0:
                codes.append(int(table[tid]))
            if n_gen % self.config.stream_check_interval == 0:
                if not maybe_emit(False):
                    ok_holder["ok"] = False
                    return False
            return True

        try:
            self.generate_tokens(text, options, on_token=on_token,
                                 profile=profile)
        except Exception:
            # a mid-stream LLM failure: flush what was generated, then
            # report failure (the reference breaks its loop and flushes,
            # test-to-speech.cpp:596-617)
            ok_holder["ok"] = False
            try:
                maybe_emit(True)
            except Exception:
                pass
        ok = ok_holder["ok"]
        if ok:
            ok = maybe_emit(True)
        profile.total_sec = time.perf_counter() - t_total0
        return ok

    # ------------------------------------------------------------------
    # Fused streaming
    # ------------------------------------------------------------------

    def _window_bucket(self) -> int:
        """The fixed code-buffer size of sliding-window fused streaming:
        the window, or the most codes the policy can leave uncommitted
        after a full chunk (holdback + min step + chunk), plus one chunk."""
        c = self.config
        keep = max(c.stream_window_codes, c.holdback_codes
                   + c.min_commit_step_codes + c.stream_check_interval)
        return _bucket_len(keep + c.stream_check_interval, c.code_bucket)

    def _fused_state(self, last, cache, bucket: int) -> dict:
        """The fused stream's device state before its first chunk."""
        z = torch.zeros((), dtype=torch.int64, device=self.device)
        return dict(last=last, cache=cache, codes=z.new_zeros(bucket),
                    n_codes=z, committed=z, n_tokens=z,
                    done=torch.zeros((), dtype=torch.bool, device=self.device))

    def _fused_chunk(self, st: dict, n_steps: int, temp: float,
                     gen: torch.Generator | None, bucket: int,
                     win_slide: bool, max_toks: int):
        """Enqueue one fused streaming step with no host sync: in window
        mode first drop committed codes from the front of the code buffer
        when the coming chunk could overflow it; generate `n_steps` tokens
        (the stop latch `st["done"]` carried in); append their codes to the
        code buffer through the device code table; then the commit policy
        (`test-to-speech.cpp:507-522`): emit only after a full chunk of
        `stream_check_interval` tokens, target = n_codes - holdback, the
        first commit's smaller threshold; and in full mode the final flush
        of [committed, n_codes) once the stream stopped or spent its
        budget (`max_toks`).

        Updates `st` with new tensors: no tensor an earlier step returned
        is written again (the code buffer is rebuilt out of place), so the
        buffer a step leaves stays as its policy saw it until the host
        decodes it.  Returns (outputs, code buffer): outputs is one int64
        tensor [n_steps + 7], the chunk's tokens (-1 padded), count, done,
        do_emit, begin, target, n_codes, flush; begin / target are code
        positions in the buffer."""
        c = self.config
        dev = self.device
        codes_buf, n_codes, committed = st["codes"], st["n_codes"], st["committed"]
        if win_slide:
            d = torch.minimum(torch.clamp(n_codes + n_steps - bucket, min=0),
                              committed)
            idx = (torch.arange(bucket, device=dev) + d) % bucket
            codes_buf = codes_buf[idx]
            n_codes = n_codes - d
            committed = committed - d
        buf, cnt, done, last, cache = llm_generate_chunk(
            self.llm_params, st["last"], st["cache"], temp, self._stop_ids,
            self.llm_cfg, n_steps, gen, done=st["done"])
        # code append: the chunk's kept tokens lead buf, -1 after them
        table = self._code_table_dev
        code = table[buf.clamp(0, table.shape[0] - 1)]
        valid = (buf >= 0) & (code >= 0)
        pos = n_codes + torch.cumsum(valid, 0) - 1
        write = valid & (pos < bucket)
        codes_buf = torch.cat([codes_buf, codes_buf.new_zeros(1)]).scatter(
            0, torch.where(write, pos, bucket), code)[:bucket]
        n_codes = n_codes + write.sum()
        n_tokens = st["n_tokens"] + cnt
        # the commit policy
        target = torch.clamp(n_codes - c.holdback_codes, min=0)
        min_eff = torch.where(committed == 0, self._first_commit,
                              c.min_commit_step_codes)
        do_emit = ((cnt == c.stream_check_interval) & (n_codes > 0)
                   & (target > committed) & (target - committed >= min_eff))
        begin = committed
        committed = torch.where(do_emit, target, committed)
        if win_slide:
            flush = torch.zeros_like(done)
        else:
            flush = (done | (n_tokens >= max_toks)) & (n_codes > committed)
            committed = torch.where(flush, n_codes, committed)
        st.update(last=last, cache=cache, codes=codes_buf, n_codes=n_codes,
                  committed=committed, n_tokens=n_tokens, done=done)
        out = torch.cat([buf, torch.stack(
            [cnt, done.long(), do_emit.long(), begin, target, n_codes,
             flush.long()])])
        return out, codes_buf

    def _stream_fused(self, voice: VoiceModel, text: str, emit_range,
                      timed_callback, options: Options,
                      profile: StreamProfile) -> bool:
        """Streaming through `_fused_chunk`: chunk k + 1 is enqueued before
        chunk k's outputs are read (`stream_pipeline_depth` deep, through
        pinned memory behind a CUDA event), and when chunk k's policy fired
        the host enqueues the decode over the code buffer chunk k left:
        full mode decodes its first bucket(n_codes) codes (the unfused
        path's bucket), window mode the whole window buffer.  Full mode's
        buffer grows out of place at the dispatch count's bucket points;
        window mode keeps one buffer the device slides.  After an abort the
        outputs still in flight are dropped unprocessed.  The chunk loop's
        time, the host's callbacks left out, is llm_sec (see
        attribute_stages)."""
        cfgE = self.config
        dev = self.device
        temp, max_tok, seed = self._resolve(options)
        t0 = time.perf_counter()
        last, cache, max_tok, _ = self._prefill(text, max_tok)
        _sync(dev)
        profile.prefill_sec += time.perf_counter() - t0

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        emb = voice.device_embedding(self.codec_device)
        table = self.code_table
        spt = self.samples_per_token
        chunk = cfgE.stream_check_interval
        win_mode = cfgE.stream_window_codes > 0
        cur_bucket = (self._window_bucket() if win_mode else
                      _bucket_len(min(chunk, max_tok), cfgE.code_bucket))
        st = self._fused_state(last, cache, cur_bucket)
        codes: list[int] = []          # host mirror of the stream's codes
        committed = 0                  # global commit watermark (host)
        n_gen = 0
        stopped = flushed = False
        depth = max(1, cfgE.stream_pipeline_depth)
        pending: list = []             # (readback, code buffer, steps)

        def process(rb, codes_buf, n_steps) -> bool:
            """Consume one step's outputs: the host mirror, then the emit."""
            nonlocal n_gen, stopped, committed, flushed
            t1 = time.perf_counter()
            h = rb.get()[0]
            cnt, done, emit, begin, target, n_codes, flush = (
                int(v) for v in h[n_steps:])
            for tid in h[:cnt]:
                n_gen += 1
                profile.token_ids.append(int(tid))
                code = table[tid] if 0 <= tid < len(table) else -1
                if code >= 0:
                    codes.append(int(code))
            profile.llm_tokens = n_gen
            stopped = bool(done)
            if not (emit or flush):
                profile.llm_sec += time.perf_counter() - t1
                return True
            dec_bucket = (codes_buf.shape[0] if win_mode
                          else _bucket_len(n_codes, cfgE.code_bucket))
            profile.decode_calls += 1
            profile.decoded_codes += n_codes
            profile.decode_bucket_codes.append(dec_bucket)
            end_c = n_codes if flush else target
            audio = self._codec_audio(
                codes_buf[:dec_bucket].to(self.codec_device), emb,
                self._count(n_codes))
            audio = audio[begin * spt:end_c * spt].cpu().numpy()
            profile.llm_sec += time.perf_counter() - t1
            if emit:
                committed += target - begin
                if not emit_range(audio, 0, (target - begin) * spt, False):
                    return False
            if flush:
                # the device-side final flush: [committed, n_codes) with no
                # holdback, in the same decode as the step's commit
                start = target if emit else begin
                committed += n_codes - start
                flushed = True
                return emit_range(audio, (start - begin) * spt,
                                  (n_codes - begin) * spt, True)
            return True

        ok = True
        dispatched = 0                 # steps enqueued
        while ok and dispatched < max_tok and not stopped:
            n_steps = min(chunk, max_tok - dispatched)
            if not win_mode:
                want = _bucket_len(dispatched + n_steps, cfgE.code_bucket)
                if want != cur_bucket:
                    st["codes"] = torch.cat(
                        [st["codes"], st["codes"].new_zeros(want - cur_bucket)])
                    cur_bucket = want
            t1 = time.perf_counter()
            out, codes_buf = self._fused_chunk(
                st, n_steps, temp, gen, cur_bucket, win_mode, max_tok)
            pending.append((_Readback(out), codes_buf, n_steps))
            profile.llm_sec += time.perf_counter() - t1
            dispatched += n_steps
            profile.decode_steps += n_steps
            if len(pending) >= depth:
                ok = process(*pending.pop(0))
        while ok and pending:
            ok = process(*pending.pop(0))
        self._cache = st["cache"]
        if not ok:
            return False

        # the final flush: normally delivered by the device-side flush of
        # the last step (full mode); here for window mode (a full-prefix
        # decode, wider than the window buffer) and a stream whose last
        # codes were all committed already
        if not codes:
            return False
        if flushed:
            return True
        if len(codes) <= committed:
            return timed_callback(None, True)
        audio = self.decode_codes(codes, voice, apply_peak_normalization=False,
                                  profile=profile)
        return emit_range(audio, committed * spt, len(audio), True)

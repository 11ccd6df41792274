"""Offline TTS engine on PyTorch: text -> speech tokens -> codec -> PCM.

Counterpart of the offline path of `miotts_tpu/runtime/engine.py`
(`TTSEngine.synthesize`), keeping its contract: prompt format and
normalisation, greedy / temperature sampling with on-device chunks of 64
tokens, token -> code mapping through the vocab table, a bucketed codec
decode with exact output length T * samples_per_token, and peak
normalisation to 0.95 on the host.  For batched serving
(`runtime/batching.py`) it adds the streaming-policy fields of
`EngineConfig` and a batched codec decode that returns only each stream's
emission slice (`decode_codes_batch_sliced[_async]`).

Everything runs on `EngineConfig.device` ("cuda" by default).  Asking for
the GPU when none is available raises; the engine never carries on quietly
on the CPU.  The quantized linears take the kernel route of
`EngineConfig.qdot_route`, or of the JAX package's environment switches
(`ops/qmat.QdotRoute.from_env`) read once when the engine is built.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..gguf import GGUFReader, load_voice_embedding
from ..models.codec import codec_decode_spec, exact_f32, load_codec_params
from ..models.llm import (LLMConfig, init_kv_cache, llm_generate_chunk,
                          llm_prefill, load_llm_params)
from ..ops.istft import spec_to_audio_bucketed
from ..ops.qmat import QdotRoute, with_route
from ..text import build_prompt, normalize_tts_text, parse_speech_tokens
from ..text.tokenizer import Tokenizer
from .profile import StreamProfile

# tokens per on-device generation chunk (one host read per chunk)
OFFLINE_CHUNK = 64


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


def _round_up(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


def _bucket_len(n: int, min_bucket: int) -> int:
    """Geometric (power-of-2) length bucket."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


@dataclass
class EngineConfig:
    """Engine-level knobs (the JAX package's defaults) plus `device`."""
    model_path: str = ""
    codec_path: str = ""
    temperature: float = 0.8
    max_tokens: int = 700
    seed: int = 42
    n_ctx: int = 2048
    # streaming policy (commit holdback) of batched serving
    stream_check_interval: int = 20
    holdback_codes: int = 32
    min_commit_step_codes: int = 24
    # smaller threshold for a stream's FIRST commit only (<= 0: uniform)
    first_commit_codes: int = 8
    chunk_samples: int = 4096
    # 0 = full-prefix re-decode per commit; W > 0 re-decodes only the last
    # W codes (O(T) streaming; the final flush stays full-prefix)
    stream_window_codes: int = 0
    prompt_bucket: int = 64
    code_bucket: int = 32
    llm_dtype: str = "bfloat16"
    # batched serving: defer each non-final commit's audio read-back by one
    # scheduler step (None = on), and ship emission slices as int16 (None =
    # on; False keeps them float-exact)
    pipeline_codec: bool | None = None
    i16_transfer: bool | None = None
    device: str = "cuda"
    # the kernel route of every quantized linear (None: from the
    # environment, MIOTTS_QDOT_GEMV / MIOTTS_PACK4_SPLIT / MIOTTS_GEMV_M8)
    qdot_route: QdotRoute | None = None

    @property
    def serving_pipeline_codec(self) -> bool:
        return True if self.pipeline_codec is None else bool(self.pipeline_codec)

    @property
    def serving_i16_transfer(self) -> bool:
        return True if self.i16_transfer is None else bool(self.i16_transfer)


@dataclass
class Options:
    """Per-call overrides (negative sentinel = engine default)."""
    temperature: float = -1.0
    max_tokens: int = -1
    skip_llm: bool = False
    seed: int = -1


class VoiceModel:
    """Voice embedding holder: a `.emb.gguf` file, or an embedding array."""

    def __init__(self, path: str = "", embedding: np.ndarray | None = None):
        self.path = path
        self.embedding = (np.asarray(embedding, np.float32)
                          if embedding is not None
                          else load_voice_embedding(path))
        self._dev_emb: dict[torch.device, torch.Tensor] = {}

    def device_embedding(self, device) -> torch.Tensor:
        """f32 copy of the embedding on `device`, uploaded once."""
        device = torch.device(device)
        if device not in self._dev_emb:
            self._dev_emb[device] = torch.from_numpy(
                np.ascontiguousarray(self.embedding, np.float32)).to(device)
        return self._dev_emb[device]

    @property
    def is_ready(self) -> bool:
        return self.embedding.size > 0


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
            im_end = self.tokenizer.token_to_id.get("<|im_end|>", -1)
            self._stop_ids = torch.tensor([self.tokenizer.eos_id, im_end],
                                          dtype=torch.int64, device=self.device)
        with GGUFReader(config.codec_path) as r:
            self.codec_params, self.codec_cfg = load_codec_params(
                r, device=self.device)
        self.sample_rate = self.codec_cfg.sample_rate
        self.samples_per_token = self.codec_cfg.samples_per_token
        # one KV cache reused across requests (prefill overwrites it and
        # `fill` masks the rest); reallocated when the size bucket changes
        self._cache = None

    def with_qdot_route(self, route: QdotRoute) -> "TTSEngine":
        """Another engine over this one's loaded weights, codec and
        tokenizer (shared, not copied) whose quantized linears take
        `route`, with a KV cache of its own."""
        eng = copy.copy(self)
        eng.config = replace(self.config, qdot_route=route)
        eng.llm_params = with_route(self.llm_params, route)
        eng._cache = None
        return eng

    # ------------------------------------------------------------------
    # LLM: speech-token generation
    # ------------------------------------------------------------------

    def _resolve(self, options: Options) -> tuple[float, int, int]:
        c = self.config
        temp = options.temperature if options.temperature >= 0 else c.temperature
        max_tok = options.max_tokens if options.max_tokens > 0 else c.max_tokens
        seed = options.seed if options.seed >= 0 else c.seed
        return temp, max_tok, seed

    def generate_tokens(self, text: str, options: Options = Options(),
                        profile: dict | None = None) -> list[int]:
        """LLM token ids for `text`.  With `profile`, adds prefill_sec,
        decode_sec, decode_steps (steps run on the device, 64 per chunk)
        and llm_tokens (tokens kept) to it, synchronising the device at the
        stage boundaries."""
        if self.llm_params is None or self.tokenizer is None:
            raise RuntimeError("LLM model is not loaded")
        temp, max_tok, seed = self._resolve(options)
        cfg = self.llm_cfg
        dev = self.device

        prompt = build_prompt(normalize_tts_text(text))
        ids = self.tokenizer.encode(prompt, add_special=True,
                                    parse_special=True)
        n = len(ids)
        if n + max_tok > self.config.n_ctx:
            max_tok = max(0, self.config.n_ctx - n)
        bucket = _round_up(n, self.config.prompt_bucket)
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n] = torch.tensor(ids, dtype=torch.int64)

        t0 = time.perf_counter()
        # cache sized to a geometric bucket of prompt + budget: decode
        # attention reads the whole cache length every step
        s_cache = min(_bucket_len(bucket + max_tok + 64, 256), self.config.n_ctx)
        if self._cache is None or self._cache["k"].shape[3] != s_cache:
            self._cache = init_kv_cache(cfg, 1, s_cache, dtype=self.dtype,
                                        device=dev)
        cache = dict(self._cache,
                     fill=torch.zeros((1,), dtype=torch.int32, device=dev))
        if "conv" in cache:
            # a hybrid model's conv state holds the previous request's last
            # inputs, and the prefill starts from it: clear it (`fill`
            # alone masks the old k / v, nothing masks this state)
            cache["conv"].zero_()
        last, cache = llm_prefill(self.llm_params, toks.to(dev),
                                  torch.tensor([n], dtype=torch.int32), cache,
                                  cfg)
        if profile is not None:
            _sync(dev)
            profile["prefill_sec"] = profile.get("prefill_sec", 0.0) + \
                time.perf_counter() - t0

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        generated: list[int] = []
        stopped = False
        steps = 0
        t1 = time.perf_counter()
        while len(generated) < max_tok and not stopped:
            buf, cnt, done, last, cache = llm_generate_chunk(
                self.llm_params, last, cache, temp, self._stop_ids, cfg,
                OFFLINE_CHUNK, gen)
            steps += OFFLINE_CHUNK
            # the chunk's one host read: tokens, count and stop flag
            host = torch.cat([buf, cnt[None], done[None].long()]).cpu().numpy()
            cnt = int(host[OFFLINE_CHUNK])
            take = min(cnt, max_tok - len(generated))
            stopped = bool(host[OFFLINE_CHUNK + 1]) or take < cnt
            generated.extend(int(t) for t in host[:take])
        if profile is not None:
            profile["decode_sec"] = profile.get("decode_sec", 0.0) + \
                time.perf_counter() - t1
            profile["decode_steps"] = profile.get("decode_steps", 0) + steps
            profile["llm_tokens"] = profile.get("llm_tokens", 0) + len(generated)
        self._cache = cache
        return generated

    def tokens_to_codes(self, token_ids: list[int]) -> list[int]:
        """Sampled token ids -> codec codes via the vocab table."""
        t = self.code_table
        return [int(t[i]) for i in token_ids if 0 <= i < len(t) and t[i] >= 0]

    # ------------------------------------------------------------------
    # Codec: codes -> audio (bucketed)
    # ------------------------------------------------------------------

    def decode_codes(self, codes, voice: VoiceModel,
                     profile: dict | None = None,
                     apply_peak_normalization: bool = True) -> np.ndarray:
        """codes -> float PCM of exactly T * samples_per_token samples,
        decoded in a power-of-2 bucket with the padding masked out and
        (unless told otherwise) peak-normalised to 0.95 on the host."""
        if not voice.is_ready:
            raise RuntimeError("voice model is not ready")
        codes = np.asarray(codes, np.int32).reshape(-1)
        T = len(codes)
        if T == 0:
            return np.zeros(0, np.float32)
        padded = np.zeros(_bucket_len(T, self.config.code_bucket), np.int32)
        padded[:T] = codes
        cfg = self.codec_cfg
        p = self.codec_params
        t0 = time.perf_counter()
        log_mag, phase = codec_decode_spec(
            p, torch.from_numpy(padded).to(self.device),
            voice.device_embedding(self.device), cfg, n_real=T)
        with torch.no_grad(), exact_f32():
            audio = spec_to_audio_bucketed(
                log_mag, phase, p["istft_cos_basis"], p["istft_sin_basis"],
                p["istft_hann"], cfg.hop_length, cfg.total_upsample, T)
        audio = audio[: T * cfg.samples_per_token].cpu().numpy()
        if profile is not None:
            profile["codec_sec"] = profile.get("codec_sec", 0.0) + \
                time.perf_counter() - t0
        if apply_peak_normalization:
            peak = float(np.max(np.abs(audio)))
            if peak > 1e-8:
                audio = audio * (0.95 / peak)
        return audio.astype(np.float32)

    def _codec_audio_sliced(self, codes_b, embs_b, n_real_b, starts_b,
                            emit_len: int) -> torch.Tensor:
        """Batched codec + iSTFT returning ONLY each row's emission slice
        audio[b, starts[b] : starts[b] + emit_len] (starts pre-clamped to
        [0, total - emit_len]), as int16 when serving_i16_transfer (scale,
        clamp, truncate: audio.wav.f32_to_s16's semantics), else f32."""
        cfg = self.codec_cfg
        p = self.codec_params
        log_mag, phase = codec_decode_spec(p, codes_b, embs_b, cfg,
                                           n_real=n_real_b)
        with torch.no_grad(), exact_f32():
            audio = spec_to_audio_bucketed(
                log_mag, phase, p["istft_cos_basis"], p["istft_sin_basis"],
                p["istft_hann"], cfg.hop_length, cfg.total_upsample, n_real_b)
        idx = starts_b[:, None] + torch.arange(emit_len, device=audio.device)
        out = audio.gather(1, idx)
        if self.config.serving_i16_transfer:
            out = torch.clamp(out * 32767.0, -32768, 32767).to(torch.int16)
        return out

    def decode_codes_batch_sliced_async(self, codes_list: list, voices: list,
                                        begins: list, ends: list):
        """Batched codec decode that enqueues ONLY each stream's emission
        slice [begins[i], ends[i]) (sample offsets relative to the decoded
        window) and does not wait for it.  The batch pads to a bucket
        (powers of two up to 16, then multiples of 16) with zero-length
        rows, and the slice length to multiples of 8 codes of audio, as in
        the JAX package.  Returns (audio [B, E] on the device, offsets,
        n_samples): row i's samples are audio[i, offsets[i] : offsets[i] +
        n_samples[i]]."""
        assert len(codes_list) == len(voices) == len(begins) == len(ends)
        cfg = self.codec_cfg
        spt = cfg.samples_per_token
        lens = [len(c) for c in codes_list]
        bucket = _bucket_len(max(lens), self.config.code_bucket)
        B_real = len(codes_list)
        if B_real <= 16:
            B = 1
            while B < B_real:
                B *= 2
        else:
            B = _round_up(B_real, 16)
        padded = np.zeros((B, bucket), np.int32)
        embs = np.zeros((B, cfg.adaln_dim), np.float32)
        for i, (c, v) in enumerate(zip(codes_list, voices)):
            padded[i, :lens[i]] = np.asarray(c, np.int32)
            embs[i] = v.embedding
        total = bucket * spt
        n_samp = [max(0, min(int(e), lens[i] * spt) - int(b))
                  for i, (b, e) in enumerate(zip(begins, ends))]
        E = min(_round_up(max(n_samp + [1]), 8 * spt), total)
        starts, offs = [], []
        for b in begins:
            s = max(0, min(int(b), total - E))
            starts.append(s)
            offs.append(int(b) - s)
        lens_arr = np.ones((B,), np.int64)
        lens_arr[:B_real] = lens
        starts_arr = np.zeros((B,), np.int64)
        starts_arr[:B_real] = starts
        dev = self.device
        audio = self._codec_audio_sliced(
            torch.from_numpy(padded).to(dev), torch.from_numpy(embs).to(dev),
            torch.from_numpy(lens_arr).to(dev),
            torch.from_numpy(starts_arr).to(dev), E)
        return audio, offs, n_samp

    def decode_codes_batch_sliced(self, codes_list: list, voices: list,
                                  begins: list, ends: list,
                                  profile: StreamProfile | None = None) -> list:
        """Synchronous form of decode_codes_batch_sliced_async: a list of
        float PCM arrays, exactly ends[i] - begins[i] samples each (clipped
        to the decoded length)."""
        t0 = time.perf_counter()
        audio, offs, n_samp = self.decode_codes_batch_sliced_async(
            codes_list, voices, begins, ends)
        a = audio.cpu().numpy()
        if a.dtype == np.int16:
            a = a.astype(np.float32) / 32767.0
        if profile:
            profile.codec_sec += time.perf_counter() - t0
            profile.decode_calls += 1
            profile.decoded_codes += sum(len(c) for c in codes_list)
        return [a[i, offs[i]:offs[i] + n_samp[i]] for i in range(len(offs))]

    # ------------------------------------------------------------------
    # Offline synthesis
    # ------------------------------------------------------------------

    def synthesize(self, voice: VoiceModel, text: str,
                   options: Options = Options(),
                   profile: dict | None = None) -> np.ndarray:
        """Offline text -> PCM.  With skip_llm, `text` is `<|s_N|>` token
        text decoded as it is."""
        if options.skip_llm:
            codes = parse_speech_tokens(text)
        else:
            codes = self.tokens_to_codes(
                self.generate_tokens(text, options, profile))
        if not codes:
            raise RuntimeError("no speech codes generated")
        if profile is not None:
            profile["n_codes"] = len(codes)
        return self.decode_codes(codes, voice, profile)

    def synthesize_to_file(self, voice: VoiceModel, text: str, path: str,
                           options: Options = Options(),
                           profile: dict | None = None) -> None:
        from ..audio.wav import wav_write
        wav_write(path, self.synthesize(voice, text, options, profile),
                  self.sample_rate)

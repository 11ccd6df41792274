"""Continuous batching on PyTorch (counterpart of
`miotts_tpu/runtime/batching.py`): many concurrent utterances through one
batched decode loop.

A slot scheduler over a shared TTSEngine: waiting requests are admitted
into free slots (one batched prefill per admission wave), every active slot
steps together in chunks of on-device generation (`llm_generate_chunk_
batched`, whose attention is the hand-written CUDA kernel on a GPU), and
each request's audio streams out through the commit-holdback policy with a
batched, sliced codec decode per scheduler step.  Dense and hybrid (lfm2)
models alike: a hybrid cache's per-slot conv state is reset by the slot
prefill and advanced by the chunk.

Reading results back without stalling the pipeline: a chunk's tokens and
stop flags (and a deferred codec decode's samples) are copied into pinned
host memory right after they are enqueued, behind a CUDA event, so the
scheduler can read chunk k while chunk k + 1 already runs on the device.
With the engine's `codec_device`, the codec decodes run on a CUDA stream of
their own and are read back from it, so a deferred decode overlaps the next
chunk.

The fused batch step (`fused=True`, `_step_fused`, the JAX package's):
one chunk at a time (depth 1), generation with each slot's token budget
and the code append into a device code buffer, and the commit policy, all
on the device (`engine._fused_batch_step`); one readback of the tokens,
the active bits, the emit bits and the targets; then one batched decode of
the emitting rows only, each row's f32 slice [committed, target) read back,
and the final flushes of the slots that ended, batched into one decode.

Sharded serving (`mesh`, a parallel/mesh.make_mesh DeviceMesh; every rank
runs this scheduler over the same submissions, as the JAX package's
multi-host worker does): the engine's weights are this rank's tensor-
parallel slice (`eng.llm_params = shard_llm_params(...)`), the KV cache is
this rank's block (`shard_kv_cache`: slots over 'data', heads over
'model'), and the per-slot device state (logits, sampling state, the fused
step's code buffer) is whole on every rank.  Each 'data' rank prefills the
admissions into its own slots (the wave's last logits summed over 'data',
zeros elsewhere) and runs each chunk on its own rows; the chunk's outputs
are gathered over 'data', so every rank reads every slot and decodes
every request's audio.  Both the unfused and the fused step take a mesh.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..models.llm import (init_kv_cache, llm_generate_chunk_batched,
                          llm_prefill_slots)
from ..ops.collective import all_gather, psum
from ..text import build_prompt, normalize_tts_text
from .engine import (Options, TTSEngine, VoiceModel, _bucket_len, _Readback,
                     _fused_batch_step, _round_up, _upload, emit_chunks)
from .profile import tracer


@dataclass
class Request:
    req_id: int
    text: str
    voice: VoiceModel
    callback: Callable[[Optional[np.ndarray], int, bool], bool]
    options: Options = field(default_factory=Options)
    on_finish: Optional[Callable] = None
    # state
    slot: int = -1
    token_budget: int = 0
    codes: list = field(default_factory=list)
    committed: int = 0
    tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    n_tokens: int = 0
    done: bool = False
    failed: bool = False
    submitted_at: float = 0.0
    # the start and the end of the admission wave that prefilled it
    admitted_at: float = 0.0
    prefilled_at: float = 0.0
    first_audio_at: float = -1.0
    finished_at: float = 0.0
    emitted_samples: int = 0


class ContinuousBatcher:
    """Slot scheduler over a shared TTSEngine.

    Usage:
        batcher = ContinuousBatcher(engine, n_slots=8)
        batcher.submit(text, voice, callback)
        while batcher.pending:
            batcher.step()
    """

    def __init__(self, engine: TTSEngine, n_slots: int = 8,
                 chunk_steps: int = 20, quantized_kv: bool = False,
                 ctx_len: int | None = None, mesh=None,
                 fused: bool = False, pipeline_depth: int = 2,
                 admit_wave: int = 0):
        """`pipeline_depth`: chunk k + 1 is enqueued BEFORE chunk k's
        results are read (depth 2), so host bookkeeping overlaps device
        work; per-slot request snapshots drop a stale in-flight chunk's
        tokens when a slot is finished or re-admitted before its results
        arrive.  Depth 1 = the unpipelined loop.

        `admit_wave`: cap on admissions per scheduler step (0 = admit into
        every free slot at once).  Per-request sampling state makes each
        request's output independent of the admission schedule.

        `fused`: the fused batch step (`_step_fused`); it runs one chunk at
        a time whatever `pipeline_depth` says, as the JAX package's does.

        `mesh`: sharded serving over a ('data', 'model') DeviceMesh (see
        the module docstring); the engine's params must be sharded over
        the same mesh.  Slots split over 'data' when n_slots divides it,
        else every data rank holds them all, as the cache's layout."""
        if engine.llm_params is None:
            raise ValueError("batching needs the LLM")
        self.mesh = mesh
        self._rows = self._data_group = None
        if mesh is not None:
            from ..parallel.mesh import axis_size
            from ..parallel.sharding import data_rows
            if axis_size(mesh, "model") > 1 and "tp" not in engine.llm_params:
                raise ValueError("sharded serving needs the engine's weights "
                                 "sharded over the mesh: eng.llm_params = "
                                 "shard_llm_params(eng.llm_params, mesh, cfg)")
            if axis_size(mesh, "data") > 1 and n_slots % axis_size(mesh,
                                                                   "data") == 0:
                self._rows = data_rows(mesh, n_slots)
                self._data_group = mesh.get_group("data")
        self.engine = engine
        self.cfg = engine.llm_cfg
        self.device = engine.device
        self.n_slots = n_slots
        self.chunk_steps = chunk_steps
        self.admit_wave = admit_wave
        self.use_fused = fused
        # the fused step's device code buffer [n_slots, bucket] and voice
        # embeddings, rebuilt from the host mirrors (req.codes) when marked
        # dirty (an admission, a finish) or when the bucket grows
        self._codes_buf = self._embs = None
        self._codes_bucket = 0
        self._dirty_codes = True
        if ctx_len is None:
            # geometric bucket of prompt bucket + token budget: per-step
            # attention traffic scales with this length, not n_ctx
            need = (engine.config.prompt_bucket * 2
                    + engine.config.max_tokens + chunk_steps + 64)
            ctx_len = min(_bucket_len(need, 256), engine.config.n_ctx)
        self.ctx_len = ctx_len
        self.quantized_kv = quantized_kv
        self.active = np.zeros(n_slots, bool)
        # host-side per-slot fill upper bound (prompt + dispatched chunks):
        # picks each chunk's attention length
        self._fill_ub = np.zeros(n_slots, np.int64)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.waiting: deque[Request] = deque()
        self._next_id = 0
        # requests taken from `waiting` whose admission has not finished
        self._admitting = 0
        self._stop_ids = engine._stop_ids
        self._table = engine.code_table
        self._reset_device_state()
        # deferred codec emissions: [(readback, items)] with items
        # [(req, row, sample_offset, n_samples)]
        self._pending: list = []
        self._depth = max(1, pipeline_depth)
        self._inflight: deque = deque()
        # coarse wall-clock stage accounting, read by benches and /stats;
        # the _sec sums are the durations of the spans of the same names
        # (sched.admit, sched.readback, sched.flush).  codes_kept: codes
        # appended to requests; codes_decoded: codes fed to codec decodes
        # (a full-prefix decode re-decodes every committed code);
        # codes_committed: codes whose audio went out.
        self.stage = {"admit_sec": 0.0, "llm_wait_sec": 0.0,
                      "codec_sync_sec": 0.0, "codec_dispatch_sec": 0.0,
                      "flush_wait_sec": 0.0, "chunks": 0, "decodes": 0,
                      "prefills": 0, "device_steps": 0, "codes_kept": 0,
                      "codes_decoded": 0, "codes_committed": 0,
                      "emitted_samples": 0}

    def _reset_device_state(self) -> None:
        """Fresh cache, logits and per-slot sampling state on the device:
        temperature, seed and the count of draws made (see
        models/llm.sample_tokens_slots)."""
        dev, B = self.device, self.n_slots
        cfgE = self.engine.config
        dtype = (torch.bfloat16 if cfgE.llm_dtype == "bfloat16"
                 else torch.float32)
        self.cache = init_kv_cache(self.cfg, B, self.ctx_len, dtype=dtype,
                                   device=dev, quantized=self.quantized_kv)
        if self.mesh is not None:
            from ..parallel.sharding import shard_kv_cache
            self.cache = shard_kv_cache(self.cache, self.mesh)
        self.last_logits = torch.zeros((B, self.cfg.n_vocab),
                                       dtype=torch.float32, device=dev)
        self._slot_temp = torch.full((B,), cfgE.temperature,
                                     dtype=torch.float32, device=dev)
        self._slot_seed = torch.full((B,), cfgE.seed, dtype=torch.int64,
                                     device=dev)
        self._slot_drawn = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._active_dev = torch.tensor(self.active, device=dev)   # a copy

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This data rank's slots of a per-slot tensor (a view)."""
        return t if self._rows is None else t[self._rows]

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's slots of a per-slot tensor, in slot order."""
        return (t if self._rows is None
                else all_gather(t, 0, self._data_group))

    def _chunk(self, active, attn_len: int):
        """One unfused chunk on this rank's slots; returns the tokens
        [n_slots, chunk_steps] and updates the per-slot state, all slots."""
        L = self._local
        buf, active, last, self.cache, drawn = llm_generate_chunk_batched(
            self.engine.llm_params, L(self.last_logits), self.cache,
            L(active), L(self._slot_seed), L(self._slot_drawn),
            L(self._slot_temp), self._stop_ids, self.cfg, self.chunk_steps,
            attn_len)
        G = self._gathered
        self._active_dev, self.last_logits = G(active), G(last)
        self._slot_drawn = G(drawn)
        return G(buf)

    def _prefill(self, toks: torch.Tensor, n_real: torch.Tensor,
                 slots: list[int]) -> torch.Tensor:
        """The wave's slot prefill into this rank's slots; returns the last
        logits [A, V] of every admission (a 'data' rank sums its rows with
        zeros from the others)."""
        eng, dev = self.engine, self.device
        if self._rows is None:
            last, self.cache = llm_prefill_slots(
                eng.llm_params, toks, n_real, self.cache,
                torch.tensor(slots, dtype=torch.int64, device=dev), self.cfg)
            return last
        r0, r1 = self._rows.start, self._rows.stop
        mine = [i for i, s in enumerate(slots) if r0 <= s < r1]
        last = torch.zeros((len(slots), self.cfg.n_vocab),
                           dtype=torch.float32, device=dev)
        if mine:
            idx = torch.tensor(mine, dtype=torch.int64)
            part, self.cache = llm_prefill_slots(
                eng.llm_params, toks[idx.to(dev)], n_real[idx], self.cache,
                torch.tensor([slots[i] - r0 for i in mine],
                             dtype=torch.int64, device=dev), self.cfg)
            last[idx.to(dev)] = part
        return psum(last, self._data_group)

    # ------------------------------------------------------------------
    def warmup(self, prompt_len: int = 64) -> None:
        """Run each serving shape once before traffic (the batched slot
        prefill at A = 1 and A = n_slots, a chunk, the batched sliced codec
        decode at the first-commit shape), so the first admission wave does
        not pay kernel builds, library handles and allocator growth.
        Serving state is re-initialized afterwards."""
        eng = self.engine
        cfgE = eng.config
        dev = self.device
        bucket = _round_up(max(1, prompt_len), cfgE.prompt_bucket)
        for A in (1, self.n_slots):
            self._prefill(torch.zeros((A, bucket), dtype=torch.int64,
                                      device=dev),
                          torch.ones((A,), dtype=torch.int32), list(range(A)))
        attn_len = min(_bucket_len(bucket + self.chunk_steps, 128),
                       self.ctx_len)
        active = torch.zeros((self.n_slots,), dtype=torch.bool, device=dev)
        active[0] = True
        self._chunk(active, 0 if attn_len >= self.ctx_len else attn_len).cpu()
        n0 = cfgE.holdback_codes + eng._first_commit + cfgE.stream_check_interval
        voices = [VoiceModel(embedding=np.zeros(eng.codec_cfg.adaln_dim,
                                                np.float32))] * self.n_slots
        spt = eng.codec_cfg.samples_per_token
        eng.decode_codes_batch_sliced([[1] * n0] * self.n_slots, voices,
                                      [0] * self.n_slots,
                                      [eng._first_commit * spt] * self.n_slots)
        self._reset_device_state()

    @property
    def pending(self) -> int:
        """Requests not finished: waiting, being admitted, active, plus
        chunks still in flight."""
        return (len(self.waiting) + self._admitting + int(np.sum(self.active))
                + len(self._inflight))

    def submit(self, text: str, voice: VoiceModel, callback,
               options: Options = Options(), on_finish=None) -> int:
        req = Request(req_id=self._next_id, text=text, voice=voice,
                      callback=callback, options=options, on_finish=on_finish,
                      submitted_at=time.perf_counter())
        self._next_id += 1
        self.waiting.append(req)
        return req.req_id

    # ------------------------------------------------------------------
    def _reject(self, req: Request) -> None:
        """Fail one request (final callback + on_finish), never the
        scheduler."""
        req.done = True
        req.failed = True
        req.finished_at = time.perf_counter()
        for fn, arg in ((req.callback, (None, self.engine.sample_rate, True)),
                        (req.on_finish, (req,))):
            if fn is None:
                continue
            try:
                fn(*arg)
            except Exception:
                pass

    def _admit(self) -> None:
        """Fill free slots with waiting requests, all of one scheduler step
        in ONE batched prefill (`llm_prefill_slots`).  Prompts are
        right-padded to the longest admitted prompt's bucket; per-slot
        `fill` masks the padding.  A token budget that does not fit the
        cache is clamped; a prompt that cannot fit fails that request
        only."""
        eng = self.engine
        admit: list[tuple[int, Request, list[int]]] = []
        try:
            for slot in range(self.n_slots):
                if self.admit_wave > 0 and len(admit) >= self.admit_wave:
                    break
                if self.active[slot] or not self.waiting:
                    continue
                req = self.waiting.popleft()
                self._admitting += 1
                ids = eng.tokenizer.encode(
                    build_prompt(normalize_tts_text(req.text)))
                n = len(ids)
                max_tok = (req.options.max_tokens
                           if req.options.max_tokens > 0
                           else eng.config.max_tokens)
                if n + max_tok + self.chunk_steps > self.ctx_len:
                    clamped = max(0, self.ctx_len - n - self.chunk_steps)
                    if clamped < max_tok:
                        sys.stderr.write(
                            f"miotts: request {req.req_id}: token budget "
                            f"{max_tok} -> {clamped} (prompt {n} tokens, "
                            f"ctx_len {self.ctx_len}; pass ctx_len= to the "
                            f"batcher for longer utterances)\n")
                    max_tok = clamped
                if (max_tok < 1 or _round_up(n, eng.config.prompt_bucket)
                        > self.ctx_len):
                    sys.stderr.write(
                        f"miotts: request {req.req_id}: prompt ({n} tokens) "
                        f"does not fit ctx_len {self.ctx_len}; rejected\n")
                    self._admitting -= 1
                    self._reject(req)
                    continue
                req.token_budget = max_tok
                admit.append((slot, req, ids))
            if not admit:
                return
            with tracer.timed("sched.admit") as wave:
                dev = self.device
                bucket = _round_up(max(len(ids) for _, _, ids in admit),
                                   eng.config.prompt_bucket)
                A = len(admit)
                toks = np.zeros((A, bucket), np.int64)
                n_real = np.zeros((A,), np.int32)
                for i, (_, _, ids) in enumerate(admit):
                    toks[i, :len(ids)] = ids
                    n_real[i] = len(ids)
                slot_list = [s for s, _, _ in admit]
                slots = torch.tensor(slot_list, dtype=torch.int64, device=dev)
                last = self._prefill(torch.from_numpy(toks).to(dev),
                                     torch.from_numpy(n_real), slot_list)
                self.last_logits[slots] = last
                self._active_dev[slots] = True
                cfgE = eng.config
                self._slot_temp[slots] = torch.tensor(
                    [r.options.temperature if r.options.temperature >= 0
                     else cfgE.temperature for _, r, _ in admit],
                    dtype=torch.float32).to(dev)
                self._slot_seed[slots] = torch.tensor(
                    [r.options.seed if r.options.seed >= 0 else cfgE.seed
                     for _, r, _ in admit], dtype=torch.int64).to(dev)
                self._slot_drawn[slots] = 0
                for slot, req, ids in admit:
                    self.active[slot] = True
                    self.slot_req[slot] = req
                    req.slot = slot
                    self._fill_ub[slot] = len(ids)
                self._dirty_codes = True
            self.stage["admit_sec"] += wave.seconds
            self.stage["prefills"] += 1
            for _, req, _ in admit:
                req.admitted_at = wave.start * 1e-9
                req.prefilled_at = wave.end * 1e-9
                tracer.add("req.queue", int(req.submitted_at * 1e9),
                           wave.start, req.req_id, parent=-1)
                tracer.add("req.prefill", wave.start, wave.end, req.req_id,
                           parent=wave.index)
        finally:
            self._admitting -= len(admit)

    def _finish(self, req: Request, ok: bool) -> None:
        req.done = True
        req.failed = not ok
        req.finished_at = time.perf_counter()
        slot = req.slot
        self.active[slot] = False
        self.slot_req[slot] = None
        # budget stops are host-detected: clear the device bit too (an
        # in-flight chunk may still step this slot; the snapshot check
        # drops those tokens)
        self._active_dev[slot] = False
        if req.on_finish is not None:
            try:
                req.on_finish(req)
            except Exception:
                pass

    def _emit_policy(self, req: Request, is_final: bool):
        """Commit-holdback decision.  Returns ("decode", target) when a
        re-decode + emission is due, ("final_cb", None) when only the final
        sentinel remains, or ("done", ok)."""
        cfgE = self.engine.config
        if not req.codes:
            return ("done", not is_final)
        target = (len(req.codes) if is_final
                  else max(len(req.codes) - cfgE.holdback_codes, 0))
        if target <= req.committed:
            return ("final_cb", None) if is_final else ("done", True)
        # the first emission uses the smaller first-commit threshold
        min_eff = (self.engine._first_commit if req.committed == 0
                   else cfgE.min_commit_step_codes)
        if not is_final and (target - req.committed) < min_eff:
            return ("done", True)
        return ("decode", target)

    def _emit_samples(self, req: Request, audio: np.ndarray, begin: int,
                      end: int, is_final: bool) -> bool:
        """Chunked emission of audio[begin:end] with a ~30 ms linear
        crossfade against the previous chunk's tail (engine.emit_chunks)."""
        sr = self.engine.sample_rate

        def send(chunk, is_last):
            if req.first_audio_at < 0:
                now = time.perf_counter_ns()
                req.first_audio_at = now * 1e-9
                tracer.add("req.first_audio", int(req.prefilled_at * 1e9),
                           now, req.req_id)
            if not req.callback(chunk, sr, is_last):
                return False
            req.emitted_samples += chunk.size
            self.stage["emitted_samples"] += chunk.size
            return True

        ok, req.tail = emit_chunks(audio, begin, end, is_final, req.tail,
                                   self.engine.config.chunk_samples, sr, send)
        return ok

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One scheduler iteration: `_step_fused` with `fused`, else admit
        -> enqueue a batched decode chunk -> emit last step's deferred
        audio -> consume the oldest finished chunk (distribute tokens,
        commit, emit, finish)."""
        tracer.follow_profiler()
        with tracer.span("sched.step"):
            if self.use_fused:
                return self._step_fused()
            return self._step_unfused()

    def _attn_len(self) -> int:
        """The attention length of the next chunk: every active slot's fill
        stays under fill_ub, so reading only the first attn_len cache
        positions is exact (0 = the whole cache)."""
        need = int(self._fill_ub[self.active].max()) + self.chunk_steps
        attn_len = min(_bucket_len(need, 128), self.ctx_len)
        return 0 if attn_len >= self.ctx_len else attn_len

    def _step_unfused(self) -> None:
        self._admit()
        dispatched = False
        if np.any(self.active):
            with tracer.span("sched.dispatch"):
                buf = self._chunk(self._active_dev, self._attn_len())
                self.stage["device_steps"] += self.chunk_steps
                self._fill_ub[self.active] += self.chunk_steps
                self._inflight.append((_Readback(buf, self._active_dev),
                                       list(self.slot_req)))
            dispatched = True
        self._flush_pending()
        keep = self._depth - 1 if dispatched else 0
        while len(self._inflight) > keep:
            with tracer.span("sched.process"):
                self._process_chunk(*self._inflight.popleft())

    def _flush_pending(self) -> None:
        """Read back and emit deferred (pipelined) codec decodes."""
        if not self._pending:
            return
        with tracer.timed("sched.flush") as flush:
            for rb, items in self._pending:
                audio = rb.get()[0]
                if audio.dtype == np.int16:
                    audio = audio.astype(np.float32) / 32767.0
                for req, row, off, n in items:
                    if req.done or n <= 0:
                        continue
                    if not self._emit_samples(req, audio[row, off:off + n],
                                              0, n, False):
                        self._finish(req, False)
        self.stage["flush_wait_sec"] += flush.seconds
        self._pending = []

    def _process_chunk(self, rb: _Readback, snapshot) -> None:
        """Consume one chunk's results.  `snapshot` is the per-slot request
        list at dispatch time: a slot finished or re-admitted since then
        drops its stale tokens here."""
        with tracer.timed("sched.readback") as wait:
            buf, still_active = rb.get()
        self.stage["llm_wait_sec"] += wait.seconds
        self.stage["chunks"] += 1

        table = self._table
        decode_work: list[tuple[Request, int, bool]] = []
        kept = 0
        for slot in range(self.n_slots):
            req = snapshot[slot]
            if req is None or req.done or self.slot_req[slot] is not req:
                continue
            toks = buf[slot]
            toks = toks[toks >= 0]
            # the device chunk is budget-blind: truncate to the budget
            toks = toks[:max(0, req.token_budget - req.n_tokens)]
            for tid in toks:
                req.n_tokens += 1
                code = table[tid] if 0 <= tid < len(table) else -1
                if code >= 0:
                    req.codes.append(int(code))
                    kept += 1
            is_final = (not still_active[slot]
                        or req.n_tokens >= req.token_budget)
            action, val = self._emit_policy(req, is_final)
            if action == "decode":
                decode_work.append((req, val, is_final))
                continue
            ok = (req.callback(None, self.engine.sample_rate, True)
                  if action == "final_cb" else val)
            if is_final or not ok:
                self._finish(req, ok)
        self.stage["codes_kept"] += kept
        if decode_work:
            with tracer.span("sched.decode_emit"):
                self._decode_and_emit(decode_work)

    def _decode_and_emit(self, decode_work) -> None:
        """ONE batched codec decode per group of committing streams.  With
        stream_window_codes > 0 a non-final stream decodes only its trailing
        window.  With serving_pipeline_codec, non-final commits after a
        stream's first are enqueued now and emitted at the next step; first
        commits and finals are decoded synchronously."""
        eng = self.engine
        spt = eng.codec_cfg.samples_per_token
        window = eng.config.stream_window_codes
        work = []
        for r, target, is_final in decode_work:
            s = 0
            if window > 0 and not is_final:
                s = max(0, min(r.committed, len(r.codes) - window))
            work.append((r, target, is_final, s))
        sync_work = work
        if eng.config.serving_pipeline_codec:
            deferred = [w for w in work if not w[2] and w[0].committed > 0]
            sync_work = [w for w in work if w[2] or w[0].committed == 0]
            if deferred:
                t0 = time.perf_counter()
                audio, offs, n_samp = eng.decode_codes_batch_sliced_async(
                    [r.codes[s:] for r, _, _, s in deferred],
                    [r.voice for r, _, _, _ in deferred],
                    [(r.committed - s) * spt for r, _, _, s in deferred],
                    [(t - s) * spt for _, t, _, s in deferred])
                self.stage["codec_dispatch_sec"] += time.perf_counter() - t0
                self.stage["decodes"] += 1
                items = []
                for row, (req, target, _, s) in enumerate(deferred):
                    self.stage["codes_decoded"] += len(req.codes) - s
                    self.stage["codes_committed"] += target - req.committed
                    req.committed = target
                    items.append((req, row, offs[row], n_samp[row]))
                self._pending.append((eng.codec_readback(audio), items))
        if not sync_work:
            return
        t0 = time.perf_counter()
        segs = eng.decode_codes_batch_sliced(
            [r.codes[s:] for r, _, _, s in sync_work],
            [r.voice for r, _, _, _ in sync_work],
            [(r.committed - s) * spt for r, _, _, s in sync_work],
            [(t - s) * spt for _, t, _, s in sync_work])
        self.stage["codec_sync_sec"] += time.perf_counter() - t0
        self.stage["decodes"] += 1
        self.stage["codes_decoded"] += sum(len(r.codes) - s
                                           for r, _, _, s in sync_work)
        for (req, target, is_final, _), seg in zip(sync_work, segs):
            if seg.size == 0:
                ok = (req.callback(None, eng.sample_rate, True)
                      if is_final else True)
            else:
                self.stage["codes_committed"] += target - req.committed
                req.committed = target
                ok = self._emit_samples(req, seg, 0, seg.size, is_final)
            if is_final or not ok:
                self._finish(req, ok)

    # ------------------------------------------------------------------
    # The fused batch step
    # ------------------------------------------------------------------

    def _step_fused(self) -> None:
        """Fused scheduler iteration (engine._fused_batch_step): admit ->
        one chunk with the budget, the code append and the commit policy on
        the device -> one readback -> distribute tokens -> one batched
        decode of the emitting rows (`_emit_segment`) -> the final flushes
        of the slots that ended, batched (`_emit_policy(req, True)`).  As
        in the JAX package, the budget is tested when a slot next draws:
        a request whose budget ends with a chunk ends one chunk later than
        on the unfused path, with the same tokens, its last commit and its
        final flush apart where the unfused path flushes once."""
        self._admit()
        if not np.any(self.active):
            return
        with tracer.span("sched.dispatch"):
            buf, active, emit, target = self._dispatch_fused()
        with tracer.timed("sched.readback") as wait:
            h = _Readback(torch.cat([buf, torch.stack(
                [active.long(), emit.long(), target.long()], 1)], 1)).get()[0]
        self.stage["llm_wait_sec"] += wait.seconds
        self.stage["chunks"] += 1
        with tracer.span("sched.process"):
            self._process_fused(h)

    def _dispatch_fused(self):
        """Enqueue one fused chunk (`_fused_batch_step`) over every slot;
        returns its tokens, active bits, emit bits and targets, gathered
        over 'data'."""
        eng = self.engine
        cfgE = eng.config
        dev = self.device
        B = self.n_slots
        reqs = self.slot_req
        # the device code buffer, rebuilt from the host mirrors on
        # admission churn or when the bucket must grow
        max_len = max((len(r.codes) for r in reqs if r), default=0)
        want = _bucket_len(max_len + self.chunk_steps, cfgE.code_bucket)
        if self._dirty_codes or want != self._codes_bucket:
            nb = np.zeros((B, want), np.int32)
            embs = np.zeros((B, eng.codec_cfg.adaln_dim), np.float32)
            for slot, req in enumerate(reqs):
                if req is not None:
                    nb[slot, :len(req.codes)] = req.codes
                    embs[slot] = req.voice.embedding
            self._codes_buf = _upload(nb, dev)
            self._embs = _upload(embs, dev)
            self._codes_bucket = want
            self._dirty_codes = False
        # the host mirrors are authoritative: n_codes, committed, n_tokens
        # and the budget go up with each chunk
        state = _upload(np.array(
            [[len(r.codes), r.committed, r.n_tokens, r.token_budget]
             if r else [0, 0, 0, 0] for r in reqs], np.int32).T.copy(), dev)
        L, G = self._local, self._gathered
        (buf, active, last, self.cache, drawn, codes_buf, _, _, emit,
         target) = _fused_batch_step(
            eng.llm_params, L(self.last_logits), self.cache,
            L(_upload(self.active, dev)), L(self._slot_seed),
            L(self._slot_drawn), L(self._slot_temp), self._stop_ids,
            eng._code_table_dev, L(self._codes_buf), L(state[0]),
            L(state[1]), L(state[2]), L(state[3]), self.cfg,
            self.chunk_steps, cfgE.holdback_codes,
            cfgE.min_commit_step_codes, eng._first_commit, self._attn_len())
        buf, active, emit, target = G(buf), G(active), G(emit), G(target)
        self.last_logits, self._slot_drawn = G(last), G(drawn)
        self._codes_buf = G(codes_buf)
        self.stage["device_steps"] += self.chunk_steps
        self._fill_ub[self.active] += self.chunk_steps
        return buf, active, emit, target

    def _process_fused(self, h: np.ndarray) -> None:
        """Distribute a fused chunk's read-back outputs `h` (tokens, then
        the active bits, emit bits and targets as columns), decode the
        emitting rows and flush the slots that ended."""
        eng = self.engine
        B = self.n_slots
        spt = eng.codec_cfg.samples_per_token
        reqs = self.slot_req
        n = self.chunk_steps
        buf_h, active_h, emit_h, target_h = (h[:, :n], h[:, n], h[:, n + 1],
                                             h[:, n + 2])

        table = self._table
        emitting, ending = [], []
        kept = 0
        for slot in range(B):
            req = reqs[slot]
            if not self.active[slot] or req is None:
                continue
            toks = buf_h[slot]
            for tid in toks[toks >= 0]:
                req.n_tokens += 1
                code = table[tid] if 0 <= tid < len(table) else -1
                if code >= 0:
                    req.codes.append(int(code))
                    kept += 1
            if emit_h[slot]:
                emitting.append((slot, req, int(target_h[slot])))
            elif not active_h[slot]:
                ending.append(req)
        self.stage["codes_kept"] += kept
        if emitting:
            with tracer.span("sched.decode_emit"):
                n_codes = [len(r.codes) for _, r, _ in emitting]
                t0 = time.perf_counter()
                segs = eng.decode_code_rows_sliced(
                    self._codes_buf, self._embs, [s for s, _, _ in emitting],
                    n_codes, [r.committed * spt for _, r, _ in emitting],
                    [t * spt for _, _, t in emitting])
                self.stage["codec_sync_sec"] += time.perf_counter() - t0
                self.stage["decodes"] += 1
                self.stage["codes_decoded"] += sum(n_codes)
                for (_, req, target), seg in zip(emitting, segs):
                    if not self._emit_segment(req, seg, target):
                        self._finish(req, False)
                        self._dirty_codes = True
        if ending:
            with tracer.span("sched.flush"):
                self._final_flush(ending)

    def _emit_segment(self, req: Request, seg: np.ndarray,
                      target: int) -> bool:
        """Emit a fused-step decode's slice, the samples [committed * spt,
        target * spt) of its full-prefix decode (the exact spt mapping; the
        crossfade of _emit_samples), and commit up to `target`."""
        if seg.size == 0:
            return True
        self.stage["codes_committed"] += target - req.committed
        req.committed = target
        return self._emit_samples(req, seg, 0, seg.size, False)

    def _final_flush(self, reqs: list) -> None:
        """The final flush of the fused path's slots that ended (a stop or
        the budget): `_emit_policy(req, True)` for each, the full-prefix
        decodes it asks for batched into ONE decode of f32 slices
        [committed, len(codes)), then each request finished."""
        eng = self.engine
        spt = eng.codec_cfg.samples_per_token
        work, results = [], {}
        for req in reqs:
            action, val = self._emit_policy(req, True)
            if action == "decode":
                work.append((req, val))
            else:
                results[req.req_id] = (
                    req.callback(None, eng.sample_rate, True)
                    if action == "final_cb" else val)
        if work:
            t0 = time.perf_counter()
            segs = eng.decode_codes_batch_sliced(
                [r.codes for r, _ in work], [r.voice for r, _ in work],
                [r.committed * spt for r, _ in work],
                [t * spt for _, t in work], i16=False)
            self.stage["codec_sync_sec"] += time.perf_counter() - t0
            self.stage["decodes"] += 1
            self.stage["codes_decoded"] += sum(len(r.codes) for r, _ in work)
            for (req, target), seg in zip(work, segs):
                self.stage["codes_committed"] += target - req.committed
                req.committed = target
                results[req.req_id] = self._emit_samples(req, seg, 0,
                                                         seg.size, True)
        for req in reqs:
            self._finish(req, results[req.req_id])
        self._dirty_codes = True

    def run_until_done(self, max_iters: int = 10 ** 6) -> None:
        it = 0
        while self.pending and it < max_iters:
            self.step()
            it += 1

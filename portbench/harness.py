"""One run of one benchmark cell: the port's ContinuousBatcher serving a
seeded request mix on seeded weights, measured over a window, traced on
request, and judged against the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by name:
  configs/<config>.json      the model as it is run (weights.shape_of)
  archs/<model_type>.py      its architecture: seeded tensors, GGUF KVs,
                             the reference's layer, FLOPs, weight parts
  workloads/<cell>.json      the cell: its config, traffic kind and
                             parameters, slots, chunk, limits, why
  traffic/<kind>.py          a Driver that says when each request is due
  metrics/<metric>.py        a reader of one per-layer metric
The program is `miotts_tpu_torch`, driven as runtime/server.py builds it:
TTSEngine with its defaults (bf16 activations, bf16 KV cache, the default
qdot route) and ContinuousBatcher(n_slots, chunk_steps), unfused, pipeline
depth 2.

A run: draw the weights from the seed and write them to memory files;
load the engine; warm up every prompt bucket and every codec shape the
cell's traffic can reach; run the traffic's lead-in; then measure for
`seconds` (a traced run: a window of the cell's `trace_seconds` under
torch.profiler); then serve on until every request due in the window has
its first audio.  Last: free the program's state and judge a seeded
sample of the finished requests (reference/judge.py).
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import flops, stats, weights
from .mix import Mix, Request as MixRequest
from .reference import judge as ref_judge
from .reference.serving import SPEECH0, prompt_ids
from .trace import TraceView

PB = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "miotts_tpu")
E2E_UNITS = {"audio_x_realtime": "audio_s/s", "ttfa_p50_s": "s",
             "ttfa_p95_s": "s", "setup_s": "s"}
LEAD_IN_LIMIT_S = 120.0   # a lead-in that takes longer is a fault
DRAIN_LIMIT_S = 60.0      # the wait past the close for first audio


def workloads(root: Path = PB) -> list:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def workload(name: str, root: Path = PB) -> dict:
    return json.loads((root / "workloads" / f"{name}.json").read_text())


def config(name: str, root: Path = PB) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def metric_modules() -> dict:
    return {p.stem: importlib.import_module(f"portbench.metrics.{p.stem}")
            for p in sorted((PB / "metrics").glob("*.py"))
            if p.stem != "__init__"}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Record:
    """One request as its client saw it."""
    req: MixRequest
    due: float
    req_id: int = -1
    handle: object = None            # the program's Request once finished
    first_audio: float | None = None
    finished: float | None = None
    failed: bool = False
    pieces: list = field(default_factory=list)


@dataclass
class Chunk:
    """A processed chunk's work: each snapshot slot's fill when the chunk
    began and its device-active steps, and the kept tokens' spans."""
    fill0: list = field(default_factory=list)
    active_steps: list = field(default_factory=list)
    kept_codes: int = 0
    spans: list = field(default_factory=list)


@dataclass
class LayerContext:
    """What a per-layer metric reader gets (metrics/*.py)."""
    shape: object
    n_slots: int
    chunk_steps: int
    peak: dict | None
    trace: TraceView | None
    stage: dict
    chunks: list
    prefills: list
    qdot_calls: list
    audio_s: float


class Observer:
    """Wraps the program's entry points, by attribute name, to record what
    the judge and the readers need: each request's kept tokens and commits
    (always), and in a traced window the chunks' fills, the prefill waves,
    every quantized linear's shape and portbench.* ranges."""

    def __init__(self, batcher, engine, model: weights.Model, shape):
        self.b, self.e, self.shape = batcher, engine, shape
        self.tokens: dict[int, list] = {}
        self.stopped: set = set()
        self.commits: dict[int, list] = {}
        self.pos: dict[int, int] = {}
        self.prompt_len: dict[int, int] = {}
        self.chunks: list[Chunk] = []
        self.prefills: list = []
        self.qdot_calls: list = []
        self.tracing = False
        self._dispatched: list = []
        self._bytes = self._weight_bytes(engine, model, shape)
        self._wrap()

    @staticmethod
    def _weight_bytes(engine, model, shape) -> dict:
        """id(QTensor) -> its GGUF bytes, for the fused weights the loader
        builds (the architecture's weight_parts) and the output head; {}
        where the layout is not the one known here."""
        p = engine.llm_params
        nb = {n: t.payload.nbytes for n, t in model.tensors.items()}
        parts = shape.impl.weight_parts(shape)
        out = {}
        try:
            blocks = p.get("blocks") or p.get("layers")
            for i, blk in enumerate(blocks):
                pre = f"blk.{i}."
                for key, names in parts.items():
                    if key in blk:
                        out[id(blk[key])] = sum(nb[pre + n + ".weight"]
                                                for n in names)
            if "output" in p:
                out[id(p["output"])] = nb["output.weight"]
        except (KeyError, TypeError, AttributeError):
            return {}
        return out

    def _range(self, obj, attr: str, name: str):
        """Run obj.attr inside record_function(name) while tracing."""
        fn = getattr(obj, attr, None)
        if fn is None:
            return

        def wrapped(*a, **k):
            if not self.tracing:
                return fn(*a, **k)
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        setattr(obj, attr, wrapped)

    def _wrap(self) -> None:
        b, e = self.b, self.e
        process, decode_emit = b._process_chunk, b._decode_and_emit
        chunk, prefill = b._chunk, b._prefill

        def on_chunk(*a, **k):
            self._dispatched.append(self.tracing)
            return chunk(*a, **k)

        def on_prefill(toks, n_real, slots):
            if self.tracing:
                self.prefills.append([int(n) for n in n_real.tolist()])
            return prefill(toks, n_real, slots)

        def on_process(rb, snapshot):
            self._record_chunk(rb.get(), snapshot)
            return process(rb, snapshot)

        def on_decode_emit(work):
            for req, target, _ in work:
                self.commits.setdefault(req.req_id, []).append(
                    (len(req.codes), req.committed, target))
            return decode_emit(work)

        b._chunk, b._prefill = on_chunk, on_prefill
        b._process_chunk, b._decode_and_emit = on_process, on_decode_emit
        for attr in ("_admit", "_chunk", "_process_chunk", "_flush_pending"):
            self._range(b, attr, "portbench." + attr.strip("_"))
        self._range(e, "_codec_audio_sliced", "portbench.codec")

        import miotts_tpu_torch.models.llm as llm
        qdot = llm.qdot

        def on_qdot(x, w, *a, **k):
            if self.tracing:
                K = x.shape[-1]
                self.qdot_calls.append((x.numel() // K, K, w.shape[0],
                                        self._bytes.get(id(w))))
            return qdot(x, w, *a, **k)
        llm.qdot = on_qdot
        self._restore = lambda: setattr(llm, "qdot", qdot)

    def _record_chunk(self, got, snapshot) -> None:
        """The program's own rule for a chunk's tokens (kept while the
        request is live and within its budget), recorded before it runs."""
        buf, still = got
        traced = self._dispatched.pop(0) if self._dispatched else False
        c = Chunk()
        for slot, req in enumerate(snapshot):
            if req is None:
                continue
            row = buf[slot]
            dev = int((row >= 0).sum())
            rid = req.req_id
            fill0 = self.pos.get(rid, self.prompt_len.get(rid, 0))
            self.pos[rid] = fill0 + dev
            c.fill0.append(fill0)
            c.active_steps.append(dev)
            if req.done or self.b.slot_req[slot] is not req:
                continue
            kept = row[row >= 0][:max(0, req.token_budget - req.n_tokens)]
            self.tokens.setdefault(rid, []).extend(int(t) for t in kept)
            if not still[slot] and req.n_tokens + len(kept) < req.token_budget:
                self.stopped.add(rid)
            c.spans.append((fill0, len(kept)))
            c.kept_codes += int(((kept >= SPEECH0)
                                 & (kept < SPEECH0 + self.shape.n_speech)).sum())
        if traced:
            self.chunks.append(c)

    def close(self) -> None:
        """Put `qdot` back and let go of the program's objects."""
        self._restore()
        self.b = self.e = None


def _buckets(n: int, first: int) -> list:
    out = [first]
    while out[-1] < n:
        out.append(out[-1] * 2)
    return out


def warm_up(batcher, engine, voice, mix: Mix, max_codes: int) -> dict:
    """Every shape the cell's traffic reaches: the slot prefill and a chunk
    at each prompt bucket (ContinuousBatcher.warmup), and the batched
    sliced codec decode at every batch bucket up to n_slots and every code
    bucket up to `max_codes`.  Returns the seconds of each part."""
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else lambda: None)
    took = {}
    pb = engine.config.prompt_bucket
    for n in range(pb, mix.prompt_bytes_max() + pb, pb):
        t = time.perf_counter()
        batcher.warmup(n)
        sync()
        took[f"prefill_{n}"] = time.perf_counter() - t
    rows = [r for r in (1, 2, 4, 8, 16) if r < batcher.n_slots]
    rows += list(range(16, batcher.n_slots + 1, 16)) or [batcher.n_slots]
    spt = engine.samples_per_token
    for T in _buckets(max_codes, engine.config.code_bucket):
        t = time.perf_counter()
        for B in rows:
            engine.decode_codes_batch_sliced(
                [[1] * T] * B, [voice] * B, [0] * B, [8 * spt] * B)
        sync()
        took[f"codec_{T}"] = time.perf_counter() - t
    return took


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        control: bool = False, root: Path = PB) -> dict:
    """One run of cell `name` (its files under `root`); returns the result
    line's dict (and, with `control`, the control's numbers under
    "control")."""
    from miotts_tpu_torch.ops.qmat import QdotRoute
    from miotts_tpu_torch.runtime.batching import ContinuousBatcher
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)

    t0 = time.perf_counter() if t_start is None else t_start
    for key in [k for k in os.environ if k.startswith("MIOTTS_")]:
        del os.environ[key]
    wl = workload(name, root)
    shape = weights.shape_of(config(wl["config"], root), root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    split = {}

    t = time.perf_counter()
    llm_model = weights.make_llm(shape, seed, dev)
    codec_cfg = dict(weights.CODEC, **wl.get("codec", {}))
    codec_model = weights.make_codec(codec_cfg, shape.n_speech, seed, dev)
    voice_emb = weights.make_voice(codec_cfg["adaln_dim"], seed, dev)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    split["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    with weights.memory_file(llm_model, "llm") as lp, \
            weights.memory_file(codec_model, "codec") as cp:
        eng = TTSEngine(EngineConfig(model_path=lp, codec_path=cp,
                                     device=device, qdot_route=QdotRoute()))
    batcher = ContinuousBatcher(eng, n_slots=wl["n_slots"],
                                chunk_steps=wl["chunk_steps"])
    voice = VoiceModel(embedding=voice_emb)
    split["load_s"] = time.perf_counter() - t

    mix = Mix(wl["mix"], seed)
    max_codes = int(round(wl["mix"]["codes_per_char"]
                          * wl["mix"]["chars_max"]))
    t = time.perf_counter()
    parts = warm_up(batcher, eng, voice, mix, max_codes)
    split["warmup_s"] = time.perf_counter() - t
    log("portbench: warm-up " + json.dumps(
        {k: round(v, 3) for k, v in parts.items()}))

    obs = Observer(batcher, eng, llm_model, shape)
    driver = importlib.import_module(
        f"portbench.traffic.{wl['traffic']}").Driver(wl["traffic_params"],
                                                     mix)
    records: list[Record] = []
    counting = {"on": False, "samples": 0, "traced": 0}

    def submit(req: MixRequest, due: float) -> None:
        rec = Record(req=req, due=due)

        def callback(samples, rate, is_last):
            if samples is not None and len(samples):
                now = time.perf_counter()
                if rec.first_audio is None:
                    rec.first_audio = now
                rec.pieces.append(samples)
                if counting["on"]:
                    counting["samples"] += len(samples)
                    if obs.tracing:
                        counting["traced"] += len(samples)
            return True

        def on_finish(r):
            rec.finished = time.perf_counter()
            rec.failed, rec.handle = bool(r.failed), r
            driver.finished(req, rec.finished - held[0])

        rec.req_id = batcher.submit(
            req.text, voice, callback,
            Options(temperature=req.temperature, max_tokens=req.max_tokens,
                    seed=req.seed), on_finish=on_finish)
        obs.prompt_len[rec.req_id] = len(prompt_ids(req.text))
        records.append(rec)

    # The traffic's clock stands still while the harness holds the loop to
    # start or read the profiler: an open loop's arrivals would pile up
    # behind the hold, and the traced window would serve a burst that the
    # untraced one never sees.  Untraced, it is the host's clock.
    held = [0.0]

    def poll() -> None:
        for req, due in driver.poll(time.perf_counter() - held[0]):
            submit(req, due + held[0])

    # no collector pauses inside the lead-in, the window or the drain
    gc.collect()
    gc.disable()
    t = time.perf_counter()
    for req, due in driver.begin(t):
        submit(req, due)
    trace_s = wl.get("trace_seconds", seconds) if trace else 0.0
    win_start = prof = view = host0 = None
    stage0 = stage1 = None
    while True:
        poll()
        now = time.perf_counter()
        if win_start is None:
            if not driver.in_lead_in(now):
                split["lead_in_s"] = now - t
                if trace:
                    prof = _start_profile(cuda)
                    obs.tracing = True
                    held[0] += time.perf_counter() - now
                now = time.perf_counter()
                win_start, counting["on"] = now, True
                stage0 = dict(batcher.stage)
                waiting = [len(batcher.waiting)]
                host0 = _host_clocks()
            elif now - t > LEAD_IN_LIMIT_S:
                raise RuntimeError(
                    f"lead-in longer than {LEAD_IN_LIMIT_S} s")
        elif now >= win_start + (min(trace_s, seconds) if trace
                                 else seconds):
            break
        batcher.step()
    win_end = time.perf_counter()
    waiting.append(len(batcher.waiting))
    counting["on"] = False
    host = _host_share(host0, _host_clocks())
    if obs.tracing:
        stage1, view = _stop_profile(prof, obs, batcher, cuda,
                                     win_end - win_start, stage0)
        held[0] += time.perf_counter() - win_end
    due_in = [r for r in records if win_start <= r.due < win_end]
    # a request due in the window is timed to its first audio, however
    # late: the traffic goes on until each has it (or has failed)
    cutoff = win_end + DRAIN_LIMIT_S
    while time.perf_counter() < cutoff and any(
            r.first_audio is None and not r.failed for r in due_in):
        poll()
        batcher.step()
    drained = time.perf_counter()
    gc.enable()
    if cuda:
        torch.cuda.synchronize()
    window_s = win_end - win_start
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_s = win_start - t0

    sr = eng.sample_rate
    ttfa = stats.ttfa_values(due_in, win_start, drained)
    failed = sum(r.failed for r in due_in)
    log(f"portbench: setup {json.dumps({k: round(v, 3) for k, v in split.items()})}"
        f" setup_s {setup_s:.3f}")
    log(f"portbench: window {window_s:.3f} s (+{drained - win_end:.3f} s "
        f"to the last first audio), {len(due_in)} requests due, "
        f"{sum(r.finished is not None for r in due_in)} finished, "
        f"{failed} failed; waiting for a slot {waiting[0]} at the open, "
        f"{waiting[1]} at the close; traffic clock held {held[0]:.3f} s "
        f"for the profiler; traffic {json.dumps(driver.report())}")
    log(f"portbench: host in the window {json.dumps(host)}")
    if len(ttfa) < 200:
        log(f"portbench: only {len(ttfa)} requests in the window: the 95th "
            f"percentile has fewer than 10 beyond it")

    def finite(x):
        return x if math.isfinite(x) else 1e9
    metrics = {}
    if not trace:
        metrics = {
            "audio_x_realtime": counting["samples"] / sr / window_s,
            "ttfa_p50_s": finite(stats.percentile(ttfa, 50)),
            "ttfa_p95_s": finite(stats.percentile(ttfa, 95)),
            "setup_s": setup_s}
        metrics = {k: {"value": v, "unit": E2E_UNITS[k]}
                   for k, v in metrics.items()}

    result = {"attempted": len(due_in), "failed": failed}
    extra_device = {}
    if trace:
        ctx = LayerContext(
            shape=shape, n_slots=batcher.n_slots,
            chunk_steps=batcher.chunk_steps,
            peak=flops.peak(torch.cuda.get_device_name() if cuda else "cpu"),
            trace=view, stage=_delta(stage0, stage1), chunks=obs.chunks,
            prefills=obs.prefills, qdot_calls=obs.qdot_calls,
            audio_s=counting["traced"] / sr)
        for mname, mod in metric_modules().items():
            value = mod.read(ctx)
            if value is not None:
                metrics[mname] = {"value": value, "unit": mod.UNIT}
        if view is not None:
            busy = view.busy_ns() * 1e-9
            extra_device = {"busy_s": busy, "window_s": view.window_s}
            result["breakdown"] = {"device_ops": view.top_ops(),
                                   "idle_gaps": view.idle_gaps()}

    # the sample to judge, drawn from the seed once the window has closed
    obs.close()
    sample = _sample(due_in, obs, wl.get("check_requests", 8), seed)
    served = [_served(r, obs) for r in sample]
    del batcher, eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    nums, ctl = ref_judge.judge(served, llm_model.tensors, shape, codec_model,
                                codec_cfg, voice_emb, dev, control=control)
    log(f"portbench: judged {len(served)} requests "
        f"({sum(len(s.tokens) for s in served)} tokens, "
        f"{sum(s.temperature <= 0 for s in served)} greedy) in "
        f"{time.perf_counter() - t:.2f} s")
    limits = wl["limits"]
    compared = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    for r in served:
        if r.failed:
            log(f"portbench: a request failed: temperature {r.temperature}, "
                f"{len(r.tokens)} tokens of {r.max_tokens}, "
                f"{len(r.codes)} codes, stop token {r.stopped}")
    ok = bool(served) and all(nums[k] <= limits[k] for k in limits)
    result = {"correct": ok, **result, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name() if cuda
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(mem_peak),
                         **extra_device}}
    if "breakdown" in result:
        result["breakdown"] = result.pop("breakdown")
    if ctl is not None:
        result["control"] = ctl
        result["control_correct"] = all(ctl[k] <= limits[k] for k in limits)
    result["compared"] = compared
    return result


def _start_profile(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, obs, batcher, cuda, window_s, stage0):
    if cuda:
        torch.cuda.synchronize()
    obs.tracing = False
    stage1 = dict(batcher.stage)
    prof.__exit__(None, None, None)
    return stage1, TraceView.from_profile(prof, window_s)


def _host_clocks() -> dict:
    return {"wall": time.perf_counter(), "process": sum(os.times()[:2]),
            "main": time.thread_time()}


def _host_share(a: dict, b: dict) -> dict:
    """The process's and its main thread's CPU time over a window, as
    shares of the window's wall time: a main thread near 1 is what paces
    a host-bound run."""
    wall = b["wall"] - a["wall"]
    return {"process_cpu": round((b["process"] - a["process"]) / wall, 4),
            "main_thread_cpu": round((b["main"] - a["main"]) / wall, 4)}


def _delta(a: dict | None, b: dict | None) -> dict:
    if a is None or b is None:
        return {}
    return {k: b[k] - a[k] for k in a}


def _sample(records: list, obs: Observer, n: int, seed: int) -> list:
    """Of the requests due in the window: every one that failed (its
    tokens have to show why), and a seeded sample of the finished ones
    with their longest greedy and longest sampled ones in it."""
    failed = [r for r in records if r.failed]
    done = [r for r in records if r.handle is not None and not r.failed
            and r.req_id in obs.tokens]
    if not done:
        return failed
    rng = np.random.default_rng([seed, 0x5A11])
    longest = []
    for greedy in (True, False):
        pool = [r for r in done if (r.req.temperature <= 0) == greedy]
        if pool:
            longest.append(max(pool, key=lambda r: len(obs.tokens[r.req_id])))
    rest = [r for r in done if r not in longest]
    pick = rng.choice(len(rest), size=min(len(rest), max(0, n - len(longest))),
                      replace=False) if rest else []
    return failed + longest + [rest[i] for i in sorted(pick)]


def _served(rec: Record, obs: Observer) -> ref_judge.Served:
    h = rec.handle
    return ref_judge.Served(
        text=rec.req.text, temperature=rec.req.temperature,
        seed=rec.req.seed, max_tokens=rec.req.max_tokens,
        tokens=obs.tokens.get(rec.req_id, []),
        stopped=rec.req_id in obs.stopped,
        codes=list(h.codes) if h is not None else [],
        commits=obs.commits.get(rec.req_id, []),
        audio=(np.concatenate(rec.pieces).astype(np.float32)
               if rec.pieces else np.zeros(0, np.float32)),
        failed=rec.failed)

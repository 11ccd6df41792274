"""Per-stage synthesis profile (counterpart of
`miotts_tpu/runtime/profile.py`): the reference's StreamProfile fields and
`stream_bench.*` metric names (`examples/stream-benchmark.cpp:148-167`),
filled by the engine's generation, codec decodes and streaming paths, a
device trace around a run, and the port's own spans (`tracer`)."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import torch

_profiling = torch._C._autograd._profiler_enabled
# a profiler range from C++ (a cpu_op, ~10x cheaper to open and close than
# record_function's user annotation)
_range = torch._C._profiler._RecordFunctionFast


def _unix_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the narrowest of a few
    bracketed reads.  torch.profiler stamps host events on the Unix-epoch
    clock; every timestamp of the program is a perf_counter reading."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


class _Off:
    """The one context a span is while the tracer is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """An open span: its clock reads, and while the tracer is on its row
    in `Tracer.spans` and, inside a recording torch.profiler, a
    range "miotts.<name>" around the same interval."""
    __slots__ = ("tracer", "name", "start", "end", "index", "_on", "_row",
                 "_rf")

    def __init__(self, tracer: "Tracer", name: str, on: bool):
        self.tracer, self.name = tracer, name
        self.index = -1
        self._on = on
        self._row = self._rf = None

    def __enter__(self):
        if self._on:
            self.index, self._row = self.tracer._open(self.name)
            if _profiling():
                self._rf = _range("miotts." + self.name)
        self.start = time.perf_counter_ns()
        if self._rf is not None:
            # the range's own stamp falls inside its enter, which can take
            # tens of microseconds: start at the enter's midpoint
            self._rf.__enter__()
            self.start = (self.start + time.perf_counter_ns()) // 2
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.end = time.perf_counter_ns()
        if self._row is not None:
            self._row[1], self._row[2] = self.start, self.end
            self.tracer._close()
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Tracer:
    """The program's spans, kept in memory while the tracer is on.

    A span is a row [name, start_ns, end_ns, parent, req_id]: perf_counter
    readings; the index in `spans` of the span open around it on the same
    thread, or of the span that caused it (-1: none); the request it serves
    (-1: none; only the request spans, recorded by `add`, have one).  `offset_ns`, read at start(), puts a reading on
    torch.profiler's clock (`trace_ns`), so spans kept without a profiler
    line up with a device trace taken beside them.

    Off (the default), `span` returns one shared no-op context after one
    attribute check.  start() / stop() belong to whoever reads the spans:
    `device_trace`, or a recording torch.profiler through
    `follow_profiler`, which the batcher calls once a scheduler step.
    Counters live beside the work they count (ContinuousBatcher.stage)."""

    def __init__(self):
        self.on = False
        self.spans: list = []
        self.offset_ns = 0
        self._followed = False
        self._lock = threading.Lock()
        self._local = threading.local()

    def start(self) -> None:
        self.spans = []
        self.offset_ns = _unix_offset_ns()
        self.on = True

    def stop(self) -> None:
        self.on = self._followed = False

    def follow_profiler(self) -> None:
        """Start when a torch.profiler records and nobody has started the
        tracer; stop what was started so once the profiler has stopped.
        The spans stay readable until the next start."""
        if _profiling():
            if not self.on:
                self.start()
                self._followed = True
        elif self._followed:
            self.stop()

    def span(self, name: str):
        """`with tracer.span(name):` records the block while on."""
        if not self.on:
            return _OFF
        return _Span(self, name, True)

    def timed(self, name: str) -> _Span:
        """A span that reads the clock whether on or not (its `seconds`),
        for a sum that is kept either way (ContinuousBatcher.stage)."""
        return _Span(self, name, self.on)

    def add(self, name: str, start_ns: int, end_ns: int, req_id: int = -1,
            parent: int | None = None) -> int:
        """Record a span timed from stored readings (a request's); its
        parent defaults to the span open around the call.  Returns its
        index, or -1 while off."""
        if not self.on:
            return -1
        if parent is None:
            stack = self._stack()
            parent = stack[-1] if stack else -1
        with self._lock:
            self.spans.append([name, start_ns, end_ns, parent, req_id])
            return len(self.spans) - 1

    def self_ns(self) -> list:
        """Each span's self time: its duration less its children's, which
        nest inside it on its thread (request spans, which only name the
        span that caused them, aside)."""
        out = [r[2] - r[1] for r in self.spans]
        for r in self.spans:
            if r[3] >= 0 and r[4] < 0:
                out[r[3]] -= r[2] - r[1]
        return out

    def trace_ns(self, t_ns: int) -> int:
        """A perf_counter reading on torch.profiler's clock."""
        return t_ns + self.offset_ns

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str) -> tuple[int, list]:
        stack = self._stack()
        row = [name, 0, 0, stack[-1] if stack else -1, -1]
        with self._lock:
            self.spans.append(row)
            stack.append(len(self.spans) - 1)
        return stack[-1], row

    def _close(self) -> None:
        stack = self._stack()
        if stack:
            stack.pop()


tracer = Tracer()


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler around a run (host ops, and the device's kernels and
    copies when CUDA is available), written as a Chrome trace to
    `trace_dir`/trace.json on exit; view it in Perfetto or
    chrome://tracing.  The tracer runs beside it, so the trace holds the
    program's spans as `miotts.*` ranges.  No-op when `trace_dir` is
    falsy."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    tracer.start()
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        tracer.stop()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@dataclass
class StreamProfile:
    total_sec: float = 0.0
    llm_sec: float = 0.0
    codec_sec: float = 0.0
    istft_sec: float = 0.0
    callback_sec: float = 0.0
    llm_tokens: int = 0
    decode_calls: int = 0
    decoded_codes: int = 0
    emitted_samples: int = 0
    prefill_sec: float = 0.0
    first_audio_sec: float = -1.0   # time to first audio
    # The fused streaming path times its chunk loop as one stage (llm_sec):
    # the codec decodes it enqueues run between the chunks on the device.
    # It records the code bucket of every decode here, and
    # TTSEngine.attribute_stages() times codec and iSTFT at those buckets
    # on the device and moves that time from llm_sec to codec_sec /
    # istft_sec, so the reference's stage split holds there too.
    decode_bucket_codes: list = field(default_factory=list)
    stages_calibrated: bool = False
    # False when a stage's device measurement read 0 even after the
    # escalated retry: the codec / iSTFT split is then not to be trusted.
    stages_trusted: bool = True
    # Not in the JAX package's profile: the steps the device ran (whole
    # chunks, the masked steps after a stop included: the launch count
    # follows them) and the token ids kept, in order.
    decode_steps: int = 0
    token_ids: list = field(default_factory=list)

    def as_metrics(self, audio_sec: float) -> dict:
        """stream_bench.* key/value lines."""
        total = max(self.total_sec, 1e-12)
        m = {
            "stream_bench.total_sec": self.total_sec,
            "stream_bench.audio_sec": audio_sec,
            "stream_bench.rtf": (self.total_sec / audio_sec if audio_sec > 0
                                 else float("inf")),
            "stream_bench.x_realtime": audio_sec / total,
            "stream_bench.llm_tokens": self.llm_tokens,
            "stream_bench.decode_calls": self.decode_calls,
            "stream_bench.decoded_codes": self.decoded_codes,
            "stream_bench.emitted_samples": self.emitted_samples,
            "stream_bench.stage.llm_sec": self.llm_sec,
            "stream_bench.stage.codec_sec": self.codec_sec,
            "stream_bench.stage.istft_sec": self.istft_sec,
            "stream_bench.stage.callback_sec": self.callback_sec,
        }
        if self.first_audio_sec >= 0:
            m["stream_bench.first_audio_sec"] = self.first_audio_sec
        if self.prefill_sec > 0:
            m["stream_bench.stage.prefill_sec"] = self.prefill_sec
        return m

"""Per-stage synthesis profile (counterpart of
`miotts_tpu/runtime/profile.py`): the reference's StreamProfile fields and
`stream_bench.*` metric names (`examples/stream-benchmark.cpp:148-167`),
filled by the engine's generation, codec decodes and streaming paths, and
a device trace around a run."""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler around a run (host ops, and the device's kernels and
    copies when CUDA is available), written as a Chrome trace to
    `trace_dir`/trace.json on exit; view it in Perfetto or
    chrome://tracing.  No-op when `trace_dir` is falsy."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
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

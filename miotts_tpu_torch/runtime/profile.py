"""Per-stage synthesis profile (counterpart of
`miotts_tpu/runtime/profile.py:StreamProfile`): the reference's
StreamProfile fields and `stream_bench.*` metric names, filled by the
engine's codec decodes."""

from __future__ import annotations

from dataclasses import dataclass


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

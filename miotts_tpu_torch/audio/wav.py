"""WAV file I/O.

Write contract per `upstream src/wav-writer.cpp:6-45`: 44-byte RIFF
header, mono 16-bit PCM, float samples scaled by 32767 THEN clamped to
[-32768, 32767] (so hard-clipped negative audio hits -32768).
"""

from __future__ import annotations

import struct

import numpy as np


def f32_to_s16(samples: np.ndarray) -> np.ndarray:
    """float PCM -> int16, reference clamp semantics
    (`wav-writer.cpp:39-42`: clamp(s * 32767, -32768, 32767)).  The ONE
    conversion used by the WAV writer."""
    s = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
    return np.clip(s * 32767.0, -32768.0, 32767.0).astype(np.int16)


def wav_write(path: str, samples: np.ndarray, sample_rate: int) -> None:
    pcm = f32_to_s16(samples)
    data = pcm.tobytes()
    n = len(data)
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + n, b"WAVE",
        b"fmt ", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16,
        b"data", n,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)


def wav_read(path: str) -> tuple[np.ndarray, int]:
    """Minimal RIFF reader for mono/stereo 16-bit PCM; returns (float32
    samples in [-1, 1] (mono-mixed), sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32767.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}/{bits}bit")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate

"""Waveform health analysis — structured port of the reference heuristics.

Encodes "sounds like speech" numerically, per the reference tool
(the reference's `tools/analyze_wav.py:51-188`): peak/RMS/crest, zero-
crossing rate, silence/clipping %, DC offset, PSD spectral centroid, 7-band
energy, autocorrelation F0, frame-RMS coefficient of variation, and the
issue thresholds.  Returned as a dict so the test suite can use it as smoke
gates (SURVEY.md §4.4) and the CLI can print it.
"""

from __future__ import annotations

import numpy as np


def _welch_psd(x: np.ndarray, sr: int, nperseg: int):
    """Minimal Welch PSD (Hann, 50% overlap) — scipy-free."""
    nperseg = min(nperseg, len(x))
    if nperseg < 8:
        freqs = np.fft.rfftfreq(max(len(x), 1), 1.0 / sr)
        return freqs, np.abs(np.fft.rfft(x)) ** 2
    step = nperseg // 2
    win = np.hanning(nperseg)
    segs = []
    for start in range(0, len(x) - nperseg + 1, step):
        seg = x[start:start + nperseg] * win
        segs.append(np.abs(np.fft.rfft(seg)) ** 2)
    psd = np.mean(segs, axis=0) if segs else np.abs(np.fft.rfft(x[:nperseg] * win)) ** 2
    freqs = np.fft.rfftfreq(nperseg, 1.0 / sr)
    return freqs, psd


def analyze_audio(samples: np.ndarray, sr: int) -> dict:
    x = np.asarray(samples, dtype=np.float64).reshape(-1)
    duration = len(x) / sr if sr else 0.0
    out: dict = {"sample_rate": sr, "n_samples": len(x), "duration_sec": duration}
    if len(x) == 0:
        out["issues"] = ["empty audio"]
        return out

    peak = float(np.max(np.abs(x)))
    rms = float(np.sqrt(np.mean(x ** 2)))
    out["peak"] = peak
    out["rms"] = rms
    out["crest"] = peak / rms if rms > 0 else float("inf")

    zc = float(np.sum(np.diff(np.sign(x)) != 0) / duration) if duration > 0 else 0.0
    out["zero_crossing_hz"] = zc
    out["silent_pct"] = float(np.mean(np.abs(x) < 1e-6) * 100)
    out["clipped_pct"] = float(np.mean(np.abs(x) > 0.99) * 100)
    out["dc_offset"] = float(np.mean(x))

    freqs, psd = _welch_psd(x, sr, 4096)
    total = float(np.sum(psd))
    centroid = float(np.sum(freqs * psd) / total) if total > 0 else 0.0
    out["spectral_centroid_hz"] = centroid

    bands = [("sub_bass", 0, 100), ("bass", 100, 300), ("low_mid", 300, 1000),
             ("mid", 1000, 3000), ("high_mid", 3000, 6000),
             ("high", 6000, 12000), ("air", 12000, sr / 2)]
    band_energy = {}
    for name, lo, hi in bands:
        if lo >= sr / 2:
            break
        m = (freqs >= lo) & (freqs < min(hi, sr / 2))
        band_energy[name] = float(np.sum(psd[m]) / total * 100) if total > 0 else 0.0
    out["band_energy_pct"] = band_energy

    # F0 via autocorrelation on the first 2000 samples (60-400 Hz search)
    seg = x[:2000]
    if len(seg) == 2000:
        acf = np.correlate(seg, seg, mode="full")
        acf = acf[len(acf) // 2:]
        if acf[0] > 0:
            acf = acf / acf[0]
            min_lag, max_lag = int(sr / 400), int(sr / 60)
            if max_lag < len(acf) and max_lag > min_lag:
                idx = int(np.argmax(acf[min_lag:max_lag])) + min_lag
                out["f0_hz"] = sr / idx
                out["f0_acf_peak"] = float(acf[idx])

    frame_len = int(0.02 * sr)
    n_frames = len(x) // frame_len if frame_len else 0
    if n_frames > 0:
        fr = x[:n_frames * frame_len].reshape(n_frames, frame_len)
        frame_rms = np.sqrt(np.mean(fr ** 2, axis=1))
        cov = float(np.std(frame_rms) / (np.mean(frame_rms) + 1e-10))
        out["frame_rms_cov"] = cov
        out["active_frame_pct"] = float(
            np.mean(frame_rms > np.mean(frame_rms) * 0.3) * 100)

    issues = []
    if rms < 0.01:
        issues.append("very low RMS - nearly silent")
    if centroid < 200:
        issues.append("spectral centroid too low - likely noise/rumble")
    elif centroid > 6000:
        issues.append("spectral centroid too high - likely noise/hiss")
    if zc < 500:
        issues.append("zero crossing rate very low")
    elif zc > 10000:
        issues.append("zero crossing rate very high")
    if out["silent_pct"] > 90:
        issues.append("mostly silent")
    if out["clipped_pct"] > 5:
        issues.append("significant clipping")
    if abs(out["dc_offset"]) > 0.1:
        issues.append("large DC offset")
    if out.get("frame_rms_cov", 1.0) < 0.2:
        issues.append("too uniform - speech should have dynamic variation")
    out["issues"] = issues
    return out

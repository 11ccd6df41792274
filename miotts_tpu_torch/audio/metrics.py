"""Waveform quality metrics for parity evaluation.

BASELINE.md defines quality parity as "spectral distance vs reference CPU
WAVs at identical code sequences (--skip-llm replay)".  This module supplies
that metric: log-spectral distance (LSD) over STFT magnitudes, plus the
sample-domain errors the reference's stream-compare reports.
"""

from __future__ import annotations

import numpy as np


def stft_mag(x: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """Magnitude STFT (Hann), [frames, n_fft//2+1]."""
    x = np.asarray(x, np.float64)
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    win = np.hanning(n_fft)
    n_frames = 1 + (len(x) - n_fft) // hop
    frames = np.stack([x[i * hop:i * hop + n_fft] * win for i in range(n_frames)])
    return np.abs(np.fft.rfft(frames, axis=-1))


def log_spectral_distance(a: np.ndarray, b: np.ndarray,
                          n_fft: int = 1024, hop: int = 256,
                          eps: float = 1e-8) -> float:
    """Mean log-spectral distance in dB between two waveforms (lower is
    better; < 1 dB is typically inaudible)."""
    n = min(len(a), len(b))
    sa = stft_mag(a[:n], n_fft, hop)
    sb = stft_mag(b[:n], n_fft, hop)
    m = min(len(sa), len(sb))
    la = 20.0 * np.log10(sa[:m] + eps)
    lb = 20.0 * np.log10(sb[:m] + eps)
    return float(np.mean(np.sqrt(np.mean((la - lb) ** 2, axis=-1))))


def waveform_errors(a: np.ndarray, b: np.ndarray) -> dict:
    """MAE / RMSE / max-abs over the common prefix
    (stream-compare.cpp:100-124 contract)."""
    n = min(len(a), len(b))
    d = np.asarray(a[:n], np.float64) - np.asarray(b[:n], np.float64)
    return {
        "mae": float(np.abs(d).mean()) if n else 0.0,
        "rmse": float(np.sqrt((d ** 2).mean())) if n else 0.0,
        "max_abs": float(np.abs(d).max()) if n else 0.0,
        "n": n,
    }


def best_lag_rmse(a: np.ndarray, b: np.ndarray,
                  max_lag: int = 4096) -> tuple[int, float]:
    """Best alignment lag within ±max_lag by RMSE — EVERY integer lag with
    overlap >= 1024, like the reference (stream-compare.cpp:126-156; a
    strided search would miss true lags that aren't multiples of the step).

    Exact via sum decomposition: SSE(lag) = sum(a_win^2) + sum(b_win^2)
    - 2 * crosscorr(lag), with the cross-correlation over all lags from one
    FFT; the winning lag's RMSE is then recomputed directly so FFT roundoff
    never reaches the reported metric."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    la, lb = len(a), len(b)
    min_overlap = 1024
    if min(la, lb) < min_overlap:
        return 0, float("inf")

    from scipy.signal import fftconvolve
    cc = fftconvolve(a, b[::-1], mode="full")   # cc[lb-1+lag] = Σ a[j+lag]b[j]
    sa2 = np.concatenate([[0.0], np.cumsum(a * a)])
    sb2 = np.concatenate([[0.0], np.cumsum(b * b)])

    lags = np.arange(-max_lag, max_lag + 1)
    m = np.where(lags >= 0, np.minimum(la - lags, lb),
                 np.minimum(la, lb + lags))
    valid = m >= min_overlap
    mc = np.maximum(m, 0)
    a0 = np.clip(lags, 0, la)                    # window start in a
    b0 = np.clip(-lags, 0, lb)                   # window start in b
    sum_a2 = sa2[np.clip(a0 + mc, 0, la)] - sa2[a0]
    sum_b2 = sb2[np.clip(b0 + mc, 0, lb)] - sb2[b0]
    cross = cc[np.clip(lb - 1 + lags, 0, la + lb - 2)]
    sse = np.where(valid, sum_a2 + sum_b2 - 2.0 * cross, np.inf)
    rmse = np.sqrt(np.maximum(sse, 0.0) / np.maximum(m, 1))
    if not valid.any():
        return 0, float("inf")
    lag = int(lags[int(np.argmin(rmse))])

    x, y = (a[lag:], b) if lag >= 0 else (a, b[-lag:])
    n = min(len(x), len(y))
    exact = float(np.sqrt(np.mean((x[:n] - y[:n]) ** 2)))
    return lag, exact

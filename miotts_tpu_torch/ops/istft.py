"""iSTFT / overlap-add vocoder in PyTorch (counterpart of
`miotts_tpu/ops/istft.py`).

The inverse real DFT of every frame is one matmul against a precomputed
synthesis basis, and the overlap-add is a static k-way shifted-block sum
(win_length = 4 * hop for MioCodec).  Contract kept exactly:
  * irfft with Hermitian symmetry folded into the basis;
  * Hann window w[i] = 0.5 * (1 - cos(2 pi i / win));
  * Hann^2 window-sum normalisation with a 1e-8 floor;
  * edge trim of (win_length - hop) / 2 per side.

Everything is f32.  The caller runs it with TF32 off (see
`models/codec.exact_f32`): on a GPU a TF32 matmul keeps ~3 decimal digits,
which is audible on the synthesis basis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.profile import tracer


def make_synthesis_basis(n_fft: int, win_length: int | None = None):
    """Inverse-rDFT bases and Hann window (host, once), float32 numpy:
    (cos_basis [n_freq, n_fft], sin_basis [n_freq, n_fft], hann [win])."""
    if win_length is None:
        win_length = n_fft
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :].astype(np.float64)
    k = np.arange(n_freq)[:, None].astype(np.float64)
    ang = 2.0 * np.pi * k * n / n_fft
    coef = np.full((n_freq, 1), 2.0)
    coef[0, 0] = 1.0
    if n_fft % 2 == 0:
        coef[-1, 0] = 1.0
    cos_b = (coef * np.cos(ang) / n_fft).astype(np.float32)
    sin_b = (-coef * np.sin(ang) / n_fft).astype(np.float32)
    # DC and Nyquist rows are purely real (imag coefficient unused)
    sin_b[0, :] = 0.0
    if n_fft % 2 == 0:
        sin_b[-1, :] = 0.0
    i = np.arange(win_length).astype(np.float64)
    hann = (0.5 * (1.0 - np.cos(2.0 * np.pi * i / win_length))).astype(np.float32)
    return cos_b, sin_b, hann


def istft(spec_real: torch.Tensor, spec_imag: torch.Tensor,
          cos_basis: torch.Tensor, sin_basis: torch.Tensor,
          hann: torch.Tensor, hop_length: int,
          frame_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse STFT, Hann^2-normalised overlap-add, edge trim.

    spec_real / spec_imag [S, n_freq] or [B, S, n_freq] f32; frame_mask
    optional [S] / [B, S] f32 (1 = real frame): padded frames add neither
    audio nor window-sum, so the first n_real * hop samples of each row
    equal an unpadded call.  Returns [S * hop_length] or
    [B, S * hop_length] f32."""
    if spec_real.dim() == 2:
        return istft(spec_real[None], spec_imag[None], cos_basis, sin_basis,
                     hann, hop_length,
                     None if frame_mask is None else frame_mask[None])[0]
    B, S = spec_real.shape[:2]
    n_fft = cos_basis.shape[1]
    win = hann.shape[0]
    if win != n_fft or win % hop_length:
        raise ValueError("MioCodec uses win_length == n_fft, a multiple of hop")
    k_frames = win // hop_length
    n_pad = (win - hop_length) // 2
    n_out = (S - 1) * hop_length + win

    time = spec_real @ cos_basis + spec_imag @ sin_basis
    fw = time * hann
    w2 = (hann * hann).expand(B, S, win)
    if frame_mask is not None:
        fw = fw * frame_mask[..., None]
        w2 = w2 * frame_mask[..., None]

    fw_blocks = fw.reshape(B, S, k_frames, hop_length)
    w2_blocks = w2.reshape(B, S, k_frames, hop_length)
    n_blocks = n_out // hop_length
    audio = spec_real.new_zeros((B, n_blocks, hop_length))
    wsum = spec_real.new_zeros((B, n_blocks, hop_length))
    for c in range(k_frames):
        audio[:, c:c + S] += fw_blocks[:, :, c, :]
        wsum[:, c:c + S] += w2_blocks[:, :, c, :]
    audio = audio.reshape(B, -1)
    wsum = wsum.reshape(B, -1)
    ok = wsum > 1e-8
    audio = torch.where(ok, audio / torch.where(ok, wsum, torch.ones_like(wsum)),
                        audio)
    return audio[:, n_pad:n_out - n_pad]


def spec_to_audio(log_mag, phase, cos_basis, sin_basis, hann,
                  hop_length: int, frame_mask=None) -> torch.Tensor:
    """Codec head -> audio: mag = clamp(exp(log_mag), 0, 100),
    re = mag cos(phase), im = mag sin(phase), then the iSTFT."""
    mag = torch.clamp(torch.exp(log_mag), 0.0, 100.0)
    return istft(mag * torch.cos(phase), mag * torch.sin(phase), cos_basis,
                 sin_basis, hann, hop_length, frame_mask)


def spec_to_audio_bucketed(log_mag, phase, cos_basis, sin_basis, hann,
                           hop_length: int, frames_per_code: int,
                           n_real_codes) -> torch.Tensor:
    """Head -> audio for a bucketed decode ([S, n_freq] with an int, or
    [B, S, n_freq] with n_real_codes [B]); the frame mask is built on the
    device.  Only the first n_real_codes * frames_per_code * hop samples of
    a row are valid."""
    with tracer.span("codec.istft"):
        S = log_mag.shape[-2]
        n = torch.as_tensor(n_real_codes, device=log_mag.device)
        if log_mag.dim() == 3:
            n = n.reshape(-1, 1)
        frame_mask = (torch.arange(S, device=log_mag.device)
                      < n * frames_per_code).to(torch.float32)
        return spec_to_audio(log_mag, phase, cos_basis, sin_basis, hann,
                             hop_length, frame_mask)

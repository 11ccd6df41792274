"""The plain reference of MioCodec's acoustic decoder and its iSTFT, in
float32 with TF32 off (or on: the control), one unpadded row at a time.

  codes [T] -> token_embd [T, 768]
  -> prenet: pre-norm blocks (LayerNorm, local attention of window 65
     with interleaved RoPE, LayerNorm, SwiGLU), LayerNorm, Linear -> 512
  -> ConvTranspose1d(k 2, stride 2): T -> 2T
  -> prior ResNet blocks (GroupNorm 32, SiLU, Conv1d k 3, twice, + x)
  -> decoder: AdaLN-Zero blocks conditioned on the voice embedding
     (local attention of window 65, SwiGLU), a final AdaLN norm
  -> post ResNet blocks
  -> upsampler stages: ConvTranspose1d (k 7, stride 3), trim (k - s) / 2
     each side, Snake, ResNet block; Linear, Snake
  -> istft_head Linear -> log-magnitude | phase
  -> magnitude clip(exp(.), 0, 100); inverse rDFT of each frame (n_fft
     392), Hann window, overlap-add at hop 98 divided by the summed
     squared window (floor 1e-8), (n_fft - hop) / 2 trimmed each side.

Weights are the f32 arrays the benchmark drew, by their file names.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y if w is None else y * w + b


def _rope_pairs(x, theta):
    """x [T, H, d]: rotate adjacent pairs (2i, 2i + 1) by t * theta^(-2i/d)."""
    T, d = x.shape[0], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    e, o = x[..., 0::2], x[..., 1::2]
    return torch.stack([e * cos - o * sin, e * sin + o * cos],
                       dim=-1).reshape(x.shape)


def _local_attn(x, P, p, heads, window, theta):
    T, dim = x.shape
    hd = dim // heads
    q = _rope_pairs((x @ P(p + "attn_q.weight").T).reshape(T, heads, hd),
                    theta)
    k = _rope_pairs((x @ P(p + "attn_k.weight").T).reshape(T, heads, hd),
                    theta)
    v = (x @ P(p + "attn_v.weight").T).reshape(T, heads, hd)
    i = torch.arange(T, device=x.device)
    band = (i[:, None] - i[None, :]).abs() <= window // 2
    sc = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    pr = torch.softmax(sc.masked_fill(~band, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", pr, v).reshape(T, dim)
    return o @ P(p + "attn_output.weight").T


def _swiglu(x, P, p):
    return ((F.silu(x @ P(p + "ffn_gate.weight").T)
             * (x @ P(p + "ffn_up.weight").T)) @ P(p + "ffn_down.weight").T)


def _group_norm(x, w, b, groups, eps):
    T, C = x.shape
    g = x.reshape(T, groups, C // groups)
    mu = g.mean(dim=(0, 2), keepdim=True)
    var = (g - mu).square().mean(dim=(0, 2), keepdim=True)
    return ((g - mu) * torch.rsqrt(var + eps)).reshape(T, C) * w + b


def _conv3(x, w, b):
    return F.conv1d(x.T[None], w, b, padding=1)[0].T


def _resnet(x, P, p, groups, eps):
    h = F.silu(_group_norm(x, P(p + "norm1.weight"), P(p + "norm1.bias"),
                           groups, eps))
    h = _conv3(h, P(p + "conv1.weight"), P(p + "conv1.bias"))
    h = F.silu(_group_norm(h, P(p + "norm2.weight"), P(p + "norm2.bias"),
                           groups, eps))
    return x + _conv3(h, P(p + "conv2.weight"), P(p + "conv2.bias"))


def _snake(x, a, b):
    return x + torch.sin(x * torch.exp(a)).square() / torch.exp(b)


def _adaln(x, cond, w, b, eps):
    h = F.silu(cond) @ w.T + b
    n = x.shape[-1]
    return _ln(x, None, None, eps) * (1 + h[n:2 * n]) + h[:n], h


def _istft(log_mag, phase, n_fft, hop):
    mag = torch.clamp(torch.exp(log_mag), 0.0, 100.0)
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)            # [S, n_fft]
    i = torch.arange(n_fft, dtype=torch.float64, device=log_mag.device)
    win = (0.5 * (1 - torch.cos(2 * math.pi * i / n_fft))).float()
    S = frames.shape[0]
    n_out = (S - 1) * hop + n_fft
    idx = (torch.arange(S, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    audio = torch.zeros(n_out, device=frames.device).index_add_(
        0, idx, (frames * win).reshape(-1))
    wsum = torch.zeros(n_out, device=frames.device).index_add_(
        0, idx, (win * win).expand(S, n_fft).reshape(-1))
    audio = torch.where(wsum > 1e-8, audio / wsum.clamp(min=1e-8), audio)
    pad = (n_fft - hop) // 2
    return audio[pad:n_out - pad]


class Codec:
    """The codec's weights on `device`; `decode(codes, voice)` -> PCM of
    len(codes) * samples_per_token samples (f32, on the device).  `tf32`
    runs every matmul and convolution in TF32 (the control)."""

    def __init__(self, model, cfg: dict, device, tf32: bool = False):
        self.cfg, self.dev, self.tf32 = cfg, device, tf32
        self.w = {name: torch.from_numpy(
            t.payload.view(np.float32).reshape(t.shape).copy()).to(device)
            for name, t in model.tensors.items()
            if t.ggml_type == 0}

    def P(self, name: str) -> torch.Tensor:
        return self.w[name]

    @torch.no_grad()
    def decode(self, codes: list, voice: np.ndarray) -> torch.Tensor:
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32,
               torch.backends.cudnn.deterministic)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cudnn.deterministic = True
        try:
            return self._decode(codes, voice)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic) = old

    def _decode(self, codes, voice):
        c, P = self.cfg, self.P
        eps, gn = c["norm_eps"], c["group_norm_eps"]
        groups = c["resnet_groups"]
        cond = torch.as_tensor(np.asarray(voice, np.float32), device=self.dev)
        x = P("token_embd")[torch.as_tensor(codes, device=self.dev).long()]
        for i in range(c["prenet_layers"]):
            p = f"wave_prenet.blk.{i}."
            x = x + _local_attn(_ln(x, P(p + "attn_norm.weight"),
                                    P(p + "attn_norm.bias"), eps), P, p,
                                c["prenet_heads"], c["prenet_window"],
                                c["rope_theta"])
            x = x + _swiglu(_ln(x, P(p + "ffn_norm.weight"),
                                P(p + "ffn_norm.bias"), eps), P, p)
        x = _ln(x, P("wave_prenet.norm.weight"), P("wave_prenet.norm.bias"),
                eps)
        x = x @ P("wave_prenet.output.weight").T + P("wave_prenet.output.bias")
        x = F.conv_transpose1d(x.T[None], P("wave_upsample.weight"),
                               P("wave_upsample.bias"), stride=2)[0].T
        for b in range(c["resnet_blocks"]):
            x = _resnet(x, P, f"wave_prior.{b}.", groups, gn)
        for i in range(c["decoder_layers"]):
            p = f"wave_decoder.blk.{i}."
            h, m = _adaln(x, cond, P(p + "attn_cond.weight"),
                          P(p + "attn_cond.bias"), eps)
            n = x.shape[-1]
            x = x + _local_attn(h, P, p, c["decoder_heads"],
                                c["decoder_window"], c["rope_theta"]) * m[2 * n:]
            h, m = _adaln(x, cond, P(p + "ffn_cond.weight"),
                          P(p + "ffn_cond.bias"), eps)
            x = x + _swiglu(h, P, p) * m[2 * n:]
        x, _ = _adaln(x, cond, P("wave_decoder.norm_cond.weight"),
                      P("wave_decoder.norm_cond.bias"), eps)
        for b in range(c["resnet_blocks"]):
            x = _resnet(x, P, f"wave_post.{b}.", groups, gn)
        for s in range(c["upsampler_stages"]):
            f, k = c["up_factors"][s], c["up_kernels"][s]
            x = F.conv_transpose1d(x.T[None], P(f"wave_upsampler.up.{s}.weight"),
                                   P(f"wave_upsampler.up.{s}.bias"),
                                   stride=f)[0].T
            trim = (k - f) // 2
            if trim:
                x = x[trim:x.shape[0] - trim]
            x = _snake(x, P(f"wave_upsampler.snake.{s}.alpha"),
                       P(f"wave_upsampler.snake.{s}.beta"))
            x = _resnet(x, P, f"wave_upsampler.resblk.{s}.", groups, gn)
        x = (x @ P("wave_upsampler.out_proj.weight").T
             + P("wave_upsampler.out_proj.bias"))
        x = _snake(x, P("wave_upsampler.out_snake.alpha"),
                   P("wave_upsampler.out_snake.beta"))
        x = x @ P("istft_head.out.weight").T + P("istft_head.out.bias")
        nf = c["n_fft"] // 2 + 1
        return _istft(x[:, :nf], x[:, nf:2 * nf], c["n_fft"],
                      c["hop_length"])

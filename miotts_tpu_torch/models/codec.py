"""MioCodec acoustic decoder in PyTorch (counterpart of
`miotts_tpu/models/codec.py`), exact f32.

  codes i32[T] --token_embd LUT--> [T, 768]
  -> wave_prenet: pre-norm transformer blocks (local attention window 65,
     interleaved RoPE) + LN + 768 -> 512
  -> wave_upsample ConvTranspose1d(k=2, s=2): T -> S = 2T
  -> wave_prior ResNet blocks (masked GroupNorm + SiLU + Conv1d k3)
  -> wave_decoder AdaLN-Zero transformer blocks conditioned on the voice
  -> final AdaLN norm -> wave_post ResNet blocks
  -> wave_upsampler stages [ConvTranspose1d -> (k - f) / 2 trim -> Snake ->
     ResNet], Linear -> Snake
  -> istft_head Linear -> log_mag | phase

Activations are [B, T, features] (a [T] call runs as B = 1).  `n_real`
[B] masks each row's bucket padding all through the forward (attention
keys, GroupNorm statistics, conv inputs), so a padded decode equals an
unpadded one and rows never see each other; the batch dimension takes the
place of the JAX package's `jax.vmap` over streams.  Every matmul and convolution is full f32:
`codec_decode_spec` runs under `exact_f32`, which turns TF32 off for cuBLAS
and cuDNN (cuDNN convolutions default to TF32 on the GPU) and keeps cuDNN
to its deterministic algorithms (the same codes, the same bits).  Fast mode
(`CodecConfig.fast`, `EngineConfig.codec_fast` or MIOTTS_CODEC_FAST=1, the
JAX package's switches) allows TF32 instead, the H100's counterpart of the
TPU's default-precision bf16-input matmul, in every matmul and convolution
after the prenet.  The prenet and the iSTFT stay exact f32: TF32 in the
prenet's matmuls alone moved the synthetic full-size codec's audio by
2.1e-2 relative RMS, everything after it together by 5.7e-3 (a CPU
emulation of TF32 rounding that gave the H100's 2.4e-2 for the whole
codec).  Per-layer weights are lists of dicts, iterated in Python.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.istft import make_synthesis_basis


@dataclass(frozen=True)
class CodecConfig:
    """Hyperparameters, read from GGUF KV with the reference defaults."""
    sample_rate: int = 44100
    n_fft: int = 392
    hop_length: int = 98
    samples_per_token: int = 1764
    head_out_dim: int = 394

    prenet_layers: int = 6
    prenet_dim: int = 768
    prenet_heads: int = 12
    prenet_ff: int = 2048
    prenet_window: int = 65

    decoder_layers: int = 8
    decoder_dim: int = 512
    decoder_heads: int = 8
    decoder_ff: int = 1536
    decoder_window: int = 65
    adaln_dim: int = 128

    resnet_blocks: int = 2
    resnet_groups: int = 32
    upsampler_stages: int = 2

    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    group_norm_eps: float = 1e-6

    up_factors: tuple[int, ...] = (3, 3)
    up_kernels: tuple[int, ...] = (7, 7)
    # TF32 matmuls and convolutions after the prenet (not in the prenet, not
    # in the iSTFT); exact f32 by default so that parity paths stay exact
    fast: bool = False

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def total_upsample(self) -> int:
        """STFT frames per code: 2 (wave_upsample) x prod(up_factors)."""
        t = 2
        for f in self.up_factors:
            t *= f
        return t

    @classmethod
    def from_gguf(cls, reader) -> "CodecConfig":
        g = lambda k, d: int(reader.kv.get(k, d))
        gf = lambda k, d: float(reader.kv.get(k, d))
        n_up = g("miocodec.wave_upsampler_layers", 2)
        factors = (3,) * n_up
        kernels = (7,) * n_up
        # the reference stores factors / kernel sizes as GGUF tensors
        if reader.has_tensor("miocodec.wave_upsampler.factors"):
            factors = tuple(int(v) for v in np.asarray(
                reader.tensor_np("miocodec.wave_upsampler.factors")).reshape(-1)[:n_up])
        if reader.has_tensor("miocodec.wave_upsampler.kernel_sizes"):
            kernels = tuple(int(v) for v in np.asarray(
                reader.tensor_np("miocodec.wave_upsampler.kernel_sizes")).reshape(-1)[:n_up])
        return cls(
            sample_rate=g("miocodec.sample_rate", 44100),
            n_fft=g("miocodec.n_fft", 392),
            hop_length=g("miocodec.hop_length", 98),
            samples_per_token=g("miocodec.samples_per_token", 1764),
            head_out_dim=g("embedding_length_out", 394),
            prenet_layers=g("miocodec.prenet_layers", 6),
            prenet_dim=g("miocodec.prenet_dim", 768),
            prenet_heads=g("miocodec.prenet_heads", 12),
            prenet_ff=g("miocodec.prenet_ff", 2048),
            prenet_window=g("miocodec.prenet_window", 65),
            decoder_layers=g("miocodec.decoder_layers", 8),
            decoder_dim=g("miocodec.decoder_dim", 512),
            decoder_heads=g("miocodec.decoder_heads", 8),
            decoder_ff=g("miocodec.decoder_ff", 1536),
            decoder_window=g("miocodec.decoder_window", 65),
            adaln_dim=g("miocodec.decoder_adanorm_dim", 128),
            resnet_blocks=g("miocodec.resnet_blocks", 2),
            resnet_groups=g("miocodec.resnet_groups", 32),
            upsampler_stages=n_up,
            rope_theta=gf("miocodec.rope_theta", 10000.0),
            norm_eps=gf("miocodec.norm_eps", 1e-5),
            group_norm_eps=gf("miocodec.group_norm_eps", 1e-6),
            up_factors=factors,
            up_kernels=kernels,
        )


@contextlib.contextmanager
def exact_f32(tf32: bool = False):
    """Full-f32 matmuls and convolutions (TF32 off for cuBLAS and cuDNN),
    restored on exit — the counterpart of JAX's Precision.HIGHEST — and
    cuDNN's deterministic algorithms: its default transposed convolution
    gave decodes of the same codes that differed by ~6e-6 from call to call
    on the H100, and a stream's paths must give the same bits.  `tf32`
    (the codec's fast mode) allows TF32 instead, deterministic all the
    same; either way the flags are restored on exit, so an exact decode
    after a fast one gives its earlier bits."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = old


def codec_fast(cfg: CodecConfig) -> bool:
    """Fast mode for this decode: cfg.fast, or MIOTTS_CODEC_FAST set (read
    at every decode, as the JAX package reads it at every trace)."""
    return cfg.fast or bool(os.environ.get("MIOTTS_CODEC_FAST"))


# ---------------------------------------------------------------------------
# Primitive ops ([B, T, features] activations, [B, T] f32 validity mask)
# ---------------------------------------------------------------------------

def _linear(x, w, b=None):
    """y = x @ w.T + b with w [out, in] (GGUF Linear layout)."""
    y = x @ w.T
    return y if b is None else y + b


def _layer_norm(x, w, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * w
    return y if b is None else y + b


def _rope_interleaved(x, pos, theta):
    """ggml NORMAL-mode RoPE: rotate adjacent pairs (2i, 2i+1) by
    pos * theta^(-2i/d).  x [B, T, H, d]; pos [T]."""
    d = x.shape[-1]
    inv_freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = pos[:, None].to(torch.float32) * inv_freq[None, :]
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x2 = x.reshape(*x.shape[:-1], d // 2, 2)
    xe, xo = x2[..., 0], x2[..., 1]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos],
                       dim=-1).reshape(x.shape)


def _local_attention(x, p, pos, mask_bias, n_head, theta):
    """Multi-head attention with interleaved RoPE and an additive
    [B, T, T] band + key-validity bias."""
    B, T, dim = x.shape
    hd = dim // n_head
    q = _rope_interleaved(_linear(x, p["wq"]).reshape(B, T, n_head, hd), pos,
                          theta)
    k = _rope_interleaved(_linear(x, p["wk"]).reshape(B, T, n_head, hd), pos,
                          theta)
    v = _linear(x, p["wv"]).reshape(B, T, n_head, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    probs = torch.softmax(scores + mask_bias[:, None], dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, dim)
    return _linear(out, p["wo"])


def _swiglu(x, p):
    return _linear(F.silu(_linear(x, p["w_gate"])) * _linear(x, p["w_up"]),
                   p["w_down"])


def _adaln3(cond, w, b):
    """SiLU(cond) -> Linear -> (shift, scale, gate); cond [B, 1, adaln]
    broadcasts over time."""
    h = _linear(F.silu(cond), w, b)
    dim = h.shape[-1] // 3
    return h[..., :dim], h[..., dim:2 * dim], h[..., 2 * dim:]


def _adaln_norm(x, shift, scale, eps):
    """norm(x) * (1 + scale) + shift, norm without affine."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + scale) + shift


def _masked_group_norm(x, w, b, n_groups, eps, mask):
    """GroupNorm over (seq, channels/group) with statistics over each row's
    valid positions only.  x [B, T, C], mask [B, T] f32."""
    B, T, C = x.shape
    g = x.reshape(B, T, n_groups, C // n_groups)
    m = mask[:, :, None, None]
    count = (torch.clamp(mask.sum(dim=1), min=1.0)
             * (C // n_groups))[:, None, None, None]
    mu = (g * m).sum(dim=(1, 3), keepdim=True) / count
    var = ((g - mu).square() * m).sum(dim=(1, 3), keepdim=True) / count
    return ((g - mu) * torch.rsqrt(var + eps)).reshape(B, T, C) * w + b


def _conv1d_same(x, w, b, mask):
    """Conv1d k=3, stride 1, pad 1 on [B, T, C] with torch weight
    [out, in, k]; padded positions are zeroed first (the reference's zero
    boundary)."""
    x = x * mask[..., None]
    return F.conv1d(x.transpose(1, 2), w, b, padding=1).transpose(1, 2)


def _conv_transpose1d(x, w, b, stride, mask):
    """ConvTranspose1d on [B, T, C_in] with torch weight [in, out, k],
    VALID padding: output length (T - 1) * stride + k."""
    x = x * mask[..., None]
    return F.conv_transpose1d(x.transpose(1, 2), w, b,
                              stride=stride).transpose(1, 2)


def _snake(x, log_alpha, log_beta):
    """x + sin^2(exp(a) x) / exp(b), channelwise log-scale parameters."""
    s = torch.sin(x * torch.exp(log_alpha))
    return x + s * s / torch.exp(log_beta)


def _resnet_block(x, p, n_groups, eps, mask):
    """GN -> SiLU -> Conv -> GN -> SiLU -> Conv + residual."""
    r = x
    x = F.silu(_masked_group_norm(x, p["norm1_w"], p["norm1_b"], n_groups,
                                  eps, mask))
    x = _conv1d_same(x, p["conv1_w"], p["conv1_b"], mask)
    x = F.silu(_masked_group_norm(x, p["norm2_w"], p["norm2_b"], n_groups,
                                  eps, mask))
    x = _conv1d_same(x, p["conv2_w"], p["conv2_b"], mask)
    return x + r


def _decoder_layer(x, p, cond, pos, bias, n_head, theta, eps):
    """One wave_decoder AdaLN-Zero layer."""
    sh, sc, g = _adaln3(cond, p["attn_cond_w"], p["attn_cond_b"])
    h = _local_attention(_adaln_norm(x, sh, sc, eps), p, pos, bias, n_head,
                         theta)
    x = x + h * g
    sh, sc, g = _adaln3(cond, p["ffn_cond_w"], p["ffn_cond_b"])
    return x + _swiglu(_adaln_norm(x, sh, sc, eps), p) * g


def _band_mask_bias(T: int, window: int, mask) -> torch.Tensor:
    """[B, T, T]: 0 inside |i - j| <= window // 2 with key j valid, else
    -1e9 (not -inf: a padded query row with no valid key would softmax to
    NaN).  mask [B, T]."""
    i = torch.arange(T, device=mask.device)
    band = (i[:, None] - i[None, :]).abs() <= window // 2
    valid = mask[:, None, :] > 0.5
    return torch.where(band[None] & valid, 0.0, -1e9).to(torch.float32)


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def _codec_forward(params: dict, codes, voice_emb, cfg: CodecConfig, n_real):
    """codes [B, T]; voice_emb [B, adaln]; n_real [B] int64."""
    dev = codes.device
    B, T = codes.shape
    steps = torch.arange(T, device=dev)

    def valid(length, real):
        return (torch.arange(length, device=dev)[None, :]
                < real[:, None]).to(torch.float32)

    mask_t = valid(T, n_real)
    eps = cfg.norm_eps
    gn_eps = cfg.group_norm_eps
    cond = voice_emb[:, None, :]                               # [B, 1, adaln]

    x = params["token_embd"][codes.long()]                     # [B, T, 768]

    bias_t = _band_mask_bias(T, cfg.prenet_window, mask_t)
    with exact_f32():       # in fast mode too: see the module docstring
        for p in params["prenet_blocks"]:
            h = _layer_norm(x, p["attn_norm_w"], p["attn_norm_b"], eps)
            x = x + _local_attention(h, p, steps, bias_t, cfg.prenet_heads,
                                     cfg.rope_theta)
            h = _layer_norm(x, p["ffn_norm_w"], p["ffn_norm_b"], eps)
            x = x + _swiglu(h, p)
        x = _layer_norm(x, params["prenet_norm_w"], params["prenet_norm_b"],
                        eps)
        x = _linear(x, params["prenet_out_w"], params["prenet_out_b"])

    x = _conv_transpose1d(x, params["upsample_w"], params["upsample_b"], 2,
                          mask_t)
    S = 2 * T
    s_real = 2 * n_real
    mask_s = valid(S, s_real)

    for p in params["prior_blocks"]:
        x = _resnet_block(x, p, cfg.resnet_groups, gn_eps, mask_s)

    pos_s = torch.arange(S, device=dev)
    bias_s = _band_mask_bias(S, cfg.decoder_window, mask_s)
    for p in params["decoder_blocks"]:
        x = _decoder_layer(x, p, cond, pos_s, bias_s, cfg.decoder_heads,
                           cfg.rope_theta, eps)

    nc = _linear(F.silu(cond), params["norm_cond_w"], params["norm_cond_b"])
    dd = cfg.decoder_dim
    x = _adaln_norm(x, nc[..., :dd], nc[..., dd:2 * dd], eps)

    for p in params["post_blocks"]:
        x = _resnet_block(x, p, cfg.resnet_groups, gn_eps, mask_s)

    cur_real = s_real
    for stage in range(cfg.upsampler_stages):
        f = cfg.up_factors[stage]
        trim = (cfg.up_kernels[stage] - f) // 2
        p = params["upsampler_stages"][stage]
        x = _conv_transpose1d(x, p["up_w"], p["up_b"], f,
                              valid(x.shape[1], cur_real))
        if trim > 0:
            x = x[:, trim:x.shape[1] - trim]
        cur_real = cur_real * f
        x = _snake(x, p["snake_a"], p["snake_b"])
        x = _resnet_block(x, p["resnet"], cfg.resnet_groups, gn_eps,
                          valid(x.shape[1], cur_real))

    x = _linear(x, params["upsampler_out_w"], params["upsampler_out_b"])
    x = _snake(x, params["upsampler_out_snake_a"],
               params["upsampler_out_snake_b"])

    x = _linear(x, params["istft_head_w"], params["istft_head_b"])
    nf = cfg.n_freq
    return x[..., :nf], x[..., nf:2 * nf]


@torch.inference_mode()
def codec_decode_spec(params: dict, codes, voice_emb, cfg: CodecConfig,
                      n_real=None):
    """codes i32[T] and voice_emb f32[adaln_dim] -> (log_mag, phase)
    [S_final, n_freq]; or a batch: codes [B, T], voice_emb [B, adaln_dim],
    n_real [B] -> [B, S_final, n_freq] each.  Exact f32, or TF32 after the
    prenet in fast mode (`codec_fast`).  `n_real` (int,
    0-d or [B] tensor) marks how many leading codes of each row are real;
    the rest is masked bucket padding."""
    single = codes.dim() == 1
    if single:
        codes, voice_emb = codes[None], voice_emb[None]
    B, T = codes.shape
    if n_real is None:
        n_real = T
    n_real = torch.as_tensor(n_real, device=codes.device).long().reshape(-1)
    n_real = n_real.expand(B)
    with exact_f32(tf32=codec_fast(cfg)):
        log_mag, phase = _codec_forward(params, codes, voice_emb, cfg, n_real)
    if single:
        return log_mag[0], phase[0]
    return log_mag, phase


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

_PRENET_KEYS = {
    "attn_norm_w": "attn_norm.weight", "attn_norm_b": "attn_norm.bias",
    "wq": "attn_q.weight", "wk": "attn_k.weight", "wv": "attn_v.weight",
    "wo": "attn_output.weight", "ffn_norm_w": "ffn_norm.weight",
    "ffn_norm_b": "ffn_norm.bias", "w_gate": "ffn_gate.weight",
    "w_up": "ffn_up.weight", "w_down": "ffn_down.weight",
}
_DECODER_KEYS = {
    "attn_cond_w": "attn_cond.weight", "attn_cond_b": "attn_cond.bias",
    "ffn_cond_w": "ffn_cond.weight", "ffn_cond_b": "ffn_cond.bias",
    "wq": "attn_q.weight", "wk": "attn_k.weight", "wv": "attn_v.weight",
    "wo": "attn_output.weight", "w_gate": "ffn_gate.weight",
    "w_up": "ffn_up.weight", "w_down": "ffn_down.weight",
}
_RESNET_KEYS = {
    "norm1_w": "norm1.weight", "norm1_b": "norm1.bias",
    "conv1_w": "conv1.weight", "conv1_b": "conv1.bias",
    "norm2_w": "norm2.weight", "norm2_b": "norm2.bias",
    "conv2_w": "conv2.weight", "conv2_b": "conv2.bias",
}


def load_codec_params(reader, cfg: CodecConfig | None = None,
                      device="cpu") -> tuple[dict, CodecConfig]:
    """Codec weights from a GGUF reader (reference tensor names) as f32
    tensors on `device`; per-layer weights are lists of dicts."""
    if cfg is None:
        cfg = CodecConfig.from_gguf(reader)

    def t(name):
        return torch.from_numpy(
            np.ascontiguousarray(reader.tensor_f32(name), np.float32)).to(device)

    def block(prefix, keys):
        return {k: t(prefix + v) for k, v in keys.items()}

    params: dict = {
        "token_embd": t("token_embd"),
        "prenet_blocks": [block(f"wave_prenet.blk.{i}.", _PRENET_KEYS)
                          for i in range(cfg.prenet_layers)],
        "prenet_norm_w": t("wave_prenet.norm.weight"),
        "prenet_norm_b": t("wave_prenet.norm.bias"),
        "prenet_out_w": t("wave_prenet.output.weight"),
        "prenet_out_b": t("wave_prenet.output.bias"),
        "upsample_w": t("wave_upsample.weight"),
        "upsample_b": t("wave_upsample.bias"),
        "prior_blocks": [block(f"wave_prior.{b}.", _RESNET_KEYS)
                         for b in range(cfg.resnet_blocks)],
        "decoder_blocks": [block(f"wave_decoder.blk.{i}.", _DECODER_KEYS)
                           for i in range(cfg.decoder_layers)],
        "norm_cond_w": t("wave_decoder.norm_cond.weight"),
        "norm_cond_b": t("wave_decoder.norm_cond.bias"),
        "post_blocks": [block(f"wave_post.{b}.", _RESNET_KEYS)
                        for b in range(cfg.resnet_blocks)],
        "upsampler_stages": [{
            "up_w": t(f"wave_upsampler.up.{s}.weight"),
            "up_b": t(f"wave_upsampler.up.{s}.bias"),
            "snake_a": t(f"wave_upsampler.snake.{s}.alpha"),
            "snake_b": t(f"wave_upsampler.snake.{s}.beta"),
            "resnet": block(f"wave_upsampler.resblk.{s}.", _RESNET_KEYS),
        } for s in range(cfg.upsampler_stages)],
        "upsampler_out_w": t("wave_upsampler.out_proj.weight"),
        "upsampler_out_b": t("wave_upsampler.out_proj.bias"),
        "upsampler_out_snake_a": t("wave_upsampler.out_snake.alpha"),
        "upsampler_out_snake_b": t("wave_upsampler.out_snake.beta"),
        "istft_head_w": t("istft_head.out.weight"),
        "istft_head_b": t("istft_head.out.bias"),
    }
    for name, arr in zip(("istft_cos_basis", "istft_sin_basis", "istft_hann"),
                         make_synthesis_basis(cfg.n_fft)):
        params[name] = torch.from_numpy(arr).to(device)
    return params, cfg

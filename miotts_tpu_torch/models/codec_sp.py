"""Sequence-parallel MioCodec decode over a mesh axis (counterpart of
`miotts_tpu/models/codec_sp.py`).

Every op of the codec couples the sequence over a bounded reach, so the
sequence splits over the ranks of one mesh axis with exact semantics, each
rank decoding T / P codes:

  * local-window attention (|i - j| <= window // 2): a ring halo exchange
    of window // 2 positions of the normed inputs a layer (`ppermute`),
    keys = [left halo | local | right halo] at global positions for the
    RoPE and the band;
  * k = 3 convolutions: 1-position halos, a VALID convolution of the
    extended chunk, the ring's ends zeroed (the global zero boundary);
  * ConvTranspose1d (stride f, kernel k): the local VALID transposed
    convolution spills k - f samples past the chunk; each rank adds its
    left neighbour's tail to its head and its right neighbour's head to
    its tail, then keeps its trim-shifted window (equal shard lengths, the
    global trim);
  * GroupNorm: the masked statistics summed over the axis (`psum`), mean
    first, then the centred squares, as the single-device port's;
  * the iSTFT's overlap-add: the (win - hop)-sample spills of audio and
    window sum exchanged the same way before the normalisation.

Positions are global and padding (`n_real`) masks by global position as
on one device.  Everything runs in exact f32 (`exact_f32`; in fast mode
TF32 after the prenet, as `codec_decode_spec`).  Every rank returns the
whole audio (an all-gather of the chunks).

Constraints (the JAX package's asserts): T divisible by the axis size, and
each chunk at least the largest halo (window // 2 codes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.collective import ModelAxis, all_gather, ppermute, psum
from ..parallel.mesh import axis_size
from .codec import (CodecConfig, _adaln3, _adaln_norm, _layer_norm, _linear,
                    _rope_interleaved, _snake, _swiglu, codec_fast, exact_f32)


def _pos(ax: ModelAxis, chunk: int, device) -> torch.Tensor:
    """Global positions [chunk] of this rank's chunk."""
    return ax.rank * chunk + torch.arange(chunk, device=device)


def _ring_halos(x, halo: int, ax: ModelAxis):
    """(left halo, right halo) [halo, D] of x [C, D]: the tail of the left
    neighbour and the head of the right one.  The ring's ends receive the
    wrap-around, which callers mask by global position."""
    return ppermute(x[-halo:], 1, ax.group), ppermute(x[:halo], -1, ax.group)


def _resolve_overlaps(raw, out_len: int, spill: int, ax: ModelAxis):
    """Complete an overlap-add shard: `raw` covers global positions
    [g, g + out_len + spill), its head [0, spill) and its tail [out_len,
    out_len + spill) hold partial sums whose complements are the
    neighbours'.  Exchange both ways and add (nothing across the ring's
    ends)."""
    if spill <= 0:
        return raw
    from_left = ppermute(raw[out_len:], 1, ax.group)
    from_right = ppermute(raw[:spill], -1, ax.group)
    raw = raw.clone()
    if ax.rank > 0:
        raw[:spill] += from_left
    if ax.rank < ax.size - 1:
        raw[out_len:] += from_right
    return raw


def _sp_attention(x, p, n_head: int, theta: float, window: int, n_real: int,
                  ax: ModelAxis):
    """Local-window attention on a sequence shard with halo keys."""
    C, dim = x.shape
    halo = window // 2
    hd = dim // n_head
    pos = _pos(ax, C, x.device)
    lh, rh = _ring_halos(x, halo, ax)
    ext = torch.cat([lh, x, rh])                           # [C + 2 halo, D]
    kpos = pos[0] - halo + torch.arange(C + 2 * halo, device=x.device)
    q = _rope_interleaved(_linear(x, p["wq"]).reshape(C, n_head, hd), pos,
                          theta)
    k = _rope_interleaved(_linear(ext, p["wk"]).reshape(-1, n_head, hd),
                          kpos, theta)
    v = _linear(ext, p["wv"]).reshape(-1, n_head, hd)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    band = (pos[:, None] - kpos[None, :]).abs() <= halo
    valid = (kpos[None, :] >= 0) & (kpos[None, :] < n_real)
    bias = torch.where(band & valid, 0.0, -1e9).to(torch.float32)
    probs = torch.softmax(scores + bias[None], dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, v).reshape(C, dim)
    return _linear(out, p["wo"])


def _sp_group_norm(x, w, b, n_groups: int, eps: float, mask, ax: ModelAxis):
    """GroupNorm with the masked statistics summed over the axis."""
    C, ch = x.shape
    per = ch // n_groups
    g = x.reshape(C, n_groups, per)
    m = mask[:, None, None]
    s1 = psum(torch.cat([(g * m).sum(dim=(0, 2)), mask.sum().reshape(1)]),
              ax.group)
    count = torch.clamp(s1[-1], min=1.0) * per
    mu = s1[:-1] / count
    var = psum(((g - mu[None, :, None]).square() * m).sum(dim=(0, 2)),
               ax.group) / count
    y = (g - mu[None, :, None]) * torch.rsqrt(var[None, :, None] + eps)
    return y.reshape(C, ch) * w + b


def _sp_conv1d_same(x, w, b, mask, ax: ModelAxis):
    """k = 3 'same' convolution of a shard: 1-position halos (zero at the
    ring's ends), VALID on the extended chunk."""
    x = x * mask[:, None]
    lh, rh = _ring_halos(x, 1, ax)
    if ax.rank == 0:
        lh = torch.zeros_like(lh)
    if ax.rank == ax.size - 1:
        rh = torch.zeros_like(rh)
    ext = torch.cat([lh, x, rh])                           # [C + 2, ci]
    return F.conv1d(ext.T[None], w, b)[0].T


def _sp_conv_transpose(x, w, b, stride: int, kernel: int, mask, ax: ModelAxis):
    """ConvTranspose1d of a shard [C, ci] -> [C * stride, co], globally the
    VALID transposed convolution with its (kernel - stride) / 2 edge
    trim."""
    C = x.shape[0]
    x = x * mask[:, None]
    spill = kernel - stride
    trim = spill // 2
    raw = F.conv_transpose1d(x.T[None], w, None, stride=stride)[0].T
    out_len = C * stride
    raw = _resolve_overlaps(raw, out_len, spill, ax)
    y = raw[trim:trim + out_len]
    return y if b is None else y + b


def _sp_resnet_block(x, p, n_groups: int, eps: float, mask, ax: ModelAxis):
    r = x
    x = F.silu(_sp_group_norm(x, p["norm1_w"], p["norm1_b"], n_groups, eps,
                              mask, ax))
    x = _sp_conv1d_same(x, p["conv1_w"], p["conv1_b"], mask, ax)
    x = F.silu(_sp_group_norm(x, p["norm2_w"], p["norm2_b"], n_groups, eps,
                              mask, ax))
    x = _sp_conv1d_same(x, p["conv2_w"], p["conv2_b"], mask, ax)
    return x + r


def _sp_istft(re, im, cos_b, sin_b, hann, hop: int, frame_mask, ax: ModelAxis):
    """Overlap-add iSTFT of a frame shard with the audio and window-sum
    spills exchanged, then the trim-shifted window."""
    n_frames = re.shape[0]
    win = hann.shape[0]
    kf = win // hop
    n_pad = (win - hop) // 2
    spill = win - hop
    time = re @ cos_b + im @ sin_b
    fw = time * hann * frame_mask[:, None]
    w2 = (hann * hann).expand(n_frames, win) * frame_mask[:, None]
    out_len = n_frames * hop
    fw_b = fw.reshape(n_frames, kf, hop)
    w2_b = w2.reshape(n_frames, kf, hop)
    audio = re.new_zeros(((out_len + spill) // hop, hop))
    wsum = re.new_zeros(((out_len + spill) // hop, hop))
    for c in range(kf):
        audio[c:c + n_frames] += fw_b[:, c, :]
        wsum[c:c + n_frames] += w2_b[:, c, :]
    audio = _resolve_overlaps(audio.reshape(-1), out_len, spill, ax)
    wsum = _resolve_overlaps(wsum.reshape(-1), out_len, spill, ax)
    ok = wsum > 1e-8
    audio = torch.where(ok, audio / torch.where(ok, wsum,
                                                torch.ones_like(wsum)), audio)
    return audio[n_pad:n_pad + out_len]


def _sp_forward(params: dict, codes, voice_emb, n_real: int,
                cfg: CodecConfig, ax: ModelAxis):
    """This rank's audio [C * samples_per_token] of its C codes."""
    dev = codes.device
    C = codes.shape[0]
    eps, gn_eps = cfg.norm_eps, cfg.group_norm_eps

    def valid(length: int, real: int):
        return (_pos(ax, length, dev) < real).to(torch.float32)

    x = params["token_embd"][codes.long()]
    with exact_f32():       # the prenet stays exact in fast mode too
        for p in params["prenet_blocks"]:
            h = _layer_norm(x, p["attn_norm_w"], p["attn_norm_b"], eps)
            x = x + _sp_attention(h, p, cfg.prenet_heads, cfg.rope_theta,
                                  cfg.prenet_window, n_real, ax)
            h = _layer_norm(x, p["ffn_norm_w"], p["ffn_norm_b"], eps)
            x = x + _swiglu(h, p)
        x = _layer_norm(x, params["prenet_norm_w"], params["prenet_norm_b"],
                        eps)
        x = _linear(x, params["prenet_out_w"], params["prenet_out_b"])

    x = _sp_conv_transpose(x, params["upsample_w"], params["upsample_b"], 2,
                           2, valid(C, n_real), ax)
    s_real = 2 * n_real
    mask_s = valid(2 * C, s_real)
    for p in params["prior_blocks"]:
        x = _sp_resnet_block(x, p, cfg.resnet_groups, gn_eps, mask_s, ax)
    for p in params["decoder_blocks"]:
        sh, sc, g = _adaln3(voice_emb, p["attn_cond_w"], p["attn_cond_b"])
        h = _sp_attention(_adaln_norm(x, sh, sc, eps), p, cfg.decoder_heads,
                          cfg.rope_theta, cfg.decoder_window, s_real, ax)
        x = x + h * g
        sh, sc, g = _adaln3(voice_emb, p["ffn_cond_w"], p["ffn_cond_b"])
        x = x + _swiglu(_adaln_norm(x, sh, sc, eps), p) * g
    nc = _linear(F.silu(voice_emb), params["norm_cond_w"],
                 params["norm_cond_b"])
    dd = cfg.decoder_dim
    x = _adaln_norm(x, nc[:dd], nc[dd:2 * dd], eps)
    for p in params["post_blocks"]:
        x = _sp_resnet_block(x, p, cfg.resnet_groups, gn_eps, mask_s, ax)

    cur_real = s_real
    for stage in range(cfg.upsampler_stages):
        f, k = cfg.up_factors[stage], cfg.up_kernels[stage]
        p = params["upsampler_stages"][stage]
        x = _sp_conv_transpose(x, p["up_w"], p["up_b"], f, k,
                               valid(x.shape[0], cur_real), ax)
        cur_real = cur_real * f
        x = _snake(x, p["snake_a"], p["snake_b"])
        x = _sp_resnet_block(x, p["resnet"], cfg.resnet_groups, gn_eps,
                             valid(x.shape[0], cur_real), ax)
    x = _linear(x, params["upsampler_out_w"], params["upsampler_out_b"])
    x = _snake(x, params["upsampler_out_snake_a"],
               params["upsampler_out_snake_b"])
    x = _linear(x, params["istft_head_w"], params["istft_head_b"])
    nf = cfg.n_freq
    log_mag, phase = x[:, :nf], x[:, nf:2 * nf]
    frame_mask = valid(log_mag.shape[0], n_real * cfg.total_upsample)
    with exact_f32():
        mag = torch.clamp(torch.exp(log_mag), 0.0, 100.0)
        return _sp_istft(mag * torch.cos(phase), mag * torch.sin(phase),
                         params["istft_cos_basis"], params["istft_sin_basis"],
                         params["istft_hann"], cfg.hop_length, frame_mask, ax)


@torch.inference_mode()
def codec_decode_audio_sp(params: dict, codes, voice_emb, cfg: CodecConfig,
                          mesh, axis: str = "model",
                          n_real=None) -> torch.Tensor:
    """Sequence-parallel decode over `axis`: codes [T] (T divisible by the
    axis size, each rank's T / P codes at least window // 2) -> audio
    [T * samples_per_token] on every rank, the single-device
    `codec_decode_audio` up to the order of f32 sums.  `n_real` (int or
    0-d tensor, default T) marks the real codes of a padded bucket."""
    T = codes.shape[0]
    n = axis_size(mesh, axis)
    assert T % n == 0, (T, n)
    assert T // n >= max(cfg.prenet_window, cfg.decoder_window) // 2, \
        "per-device chunk smaller than the attention halo"
    ax = ModelAxis(mesh.get_group(axis), mesh.get_local_rank(axis), n)
    dev = params["token_embd"].device
    C = T // n
    codes = torch.as_tensor(codes, device=dev)[ax.rank * C:(ax.rank + 1) * C]
    emb = torch.as_tensor(voice_emb, dtype=torch.float32, device=dev)
    n_real = T if n_real is None else int(n_real)
    with exact_f32(tf32=codec_fast(cfg)):
        audio = _sp_forward(params, codes, emb, n_real, cfg, ax)
    return all_gather(audio, 0, ax.group)

"""Where the codec's fast mode loses accuracy: TF32 emulated on the CPU.

    python3 scripts/torch_codec_fast_error.py [--codes 64] [--rows 2]

Writes chip_smoke.py's full-size synthetic MioCodec (random weights from a
seed) into a temporary directory and decodes random codes exactly in f32,
then again with the inputs of some of the codec's matmuls and convolutions
rounded to TF32 (10-bit mantissa, round to nearest even: what the H100's
tensor cores do to f32 inputs when TF32 is allowed), one part of the codec
at a time: every matmul and convolution; the prenet's linears; the
decoder's; the attention products; the convolutions; and everything after
the prenet (what `CodecConfig.fast` allows).  Prints each variant's audio
error as a relative RMS against the exact decode, with the iSTFT exact.
A CPU emulation, not a device measurement: chip_smoke.py phase 22 (c)
measures the card's.  Needs no GPU; imports nothing of JAX."""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from miotts_tpu_torch.gguf import GGUFReader  # noqa: E402
from miotts_tpu_torch.models import codec as tc  # noqa: E402
from miotts_tpu_torch.models.synthetic import write_synthetic_codec  # noqa: E402
from miotts_tpu_torch.ops.istft import spec_to_audio_bucketed  # noqa: E402

F = torch.nn.functional
N_CODES = 12800            # chip_smoke.py's N_SPEECH


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (round to nearest even)."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def decode(params, cfg, codes, emb, linears=(), attention=(), conv=False):
    """Audio of `codes` with TF32 rounding on the linears whose weights are
    in `linears`, the attention products of the blocks in `attention`, and
    (with `conv`) every convolution; the rest exact."""
    lin, att, einsum = tc._linear, tc._local_attention, torch.einsum
    lin_ids = {id(w) for w in linears}
    att_ids = {id(p["wq"]) for p in attention}

    def linear(x, w, b=None):
        return lin(tf32(x), tf32(w), b) if id(w) in lin_ids else lin(x, w, b)

    def attend(x, p, *a):
        if id(p["wq"]) in att_ids:
            torch.einsum = lambda eq, *ops: einsum(eq, *map(tf32, ops))
        try:
            return att(x, p, *a)
        finally:
            torch.einsum = einsum

    fns = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                   if not k.startswith("__")})
    if conv:
        fns.conv1d = lambda x, w, b=None, **k: F.conv1d(tf32(x), tf32(w), b,
                                                        **k)
        fns.conv_transpose1d = lambda x, w, b=None, **k: F.conv_transpose1d(
            tf32(x), tf32(w), b, **k)
    tc._linear, tc._local_attention, tc.F = linear, attend, fns
    B, T = codes.shape
    n_real = torch.full((B,), T)
    try:
        with torch.no_grad():
            log_mag, phase = tc._codec_forward(params, codes, emb, cfg, n_real)
    finally:
        tc._linear, tc._local_attention, tc.F = lin, att, F
    with torch.no_grad():
        return spec_to_audio_bucketed(
            log_mag, phase, params["istft_cos_basis"],
            params["istft_sin_basis"], params["istft_hann"], cfg.hop_length,
            cfg.total_upsample, n_real).double()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--codes", type=int, default=64)
    ap.add_argument("--rows", type=int, default=2)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "codec.gguf")
        write_synthetic_codec(path, cfg=tc.CodecConfig(), n_codes=N_CODES,
                              seed=1)
        with GGUFReader(path) as r:
            params, cfg = tc.load_codec_params(r, device="cpu")
    rng = np.random.default_rng(7)
    codes = torch.from_numpy(rng.integers(0, N_CODES, (args.rows, args.codes))
                             .astype(np.int32))
    emb = torch.from_numpy((rng.standard_normal((args.rows, cfg.adaln_dim))
                            * 0.3).astype(np.float32))
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    prenet = ([p[k] for p in params["prenet_blocks"] for k in names]
              + [params["prenet_out_w"]])
    decoder = [p[k] for p in params["decoder_blocks"] for k in names]
    after = (decoder + [p[k] for p in params["decoder_blocks"]
                        for k in ("attn_cond_w", "ffn_cond_w")]
             + [params[k] for k in ("norm_cond_w", "upsampler_out_w",
                                    "istft_head_w")])
    blocks = params["prenet_blocks"] + params["decoder_blocks"]
    variants = {
        "all": dict(linears=prenet + after, attention=blocks, conv=True),
        "prenet linears": dict(linears=prenet),
        "decoder linears": dict(linears=decoder),
        "attention products": dict(attention=blocks),
        "convolutions": dict(conv=True),
        "after the prenet (fast mode)": dict(
            linears=after, attention=params["decoder_blocks"], conv=True),
    }
    ref = decode(params, cfg, codes, emb)
    scale = float(ref.pow(2).mean().sqrt())
    print(f"{args.rows} rows x {args.codes} random codes, full-size "
          f"synthetic codec, CPU emulation of TF32 input rounding")
    for name, kw in variants.items():
        err = float((decode(params, cfg, codes, emb, **kw) - ref)
                    .pow(2).mean().sqrt()) / scale
        print(f"  {name:30s} audio relative RMS {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Seeded model files: the LLM's quantized blocks, the codec's f32 weights
and a voice embedding, drawn on the device from `--seed` and written as
GGUF into anonymous memory files.

Quantized tensors are not made by quantizing floats.  Each format's blocks
are drawn directly, all tensors of one format in one buffer: random bytes
for the quantized values, then the block scales written over their fields
so that every weight has a spread of about 1 / sqrt(K) and every fp16
scale stays a normal number:
  * Q8_0 (34 bytes / 32): int8 values in [-127, 127], d = sigma / 73.6;
  * Q4_K (144 bytes / 256): 6-bit scales in [1, 33], mins round(1.875 sc)
    with dmin = 4 d, so that each 32-group's mean is about 0 (the 4-bit
    values average 7.5), d = sigma / 89.8;
  * Q6_K (210 bytes / 256): int8 scales in [1, 7], d = sigma / 82.6.
Every d also takes a factor in [0.75, 1.25] per block.  Float tensors
(norms, biases, the conv taps, the codec) come from one normal draw.

The files go to `os.memfd_create` memory files, read through
/proc/self/fd/<n>: a run writes nothing to disk for its weights.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from . import gguf_writer as gw

FORMATS = {"Q8_0": gw.GGML_Q8_0, "Q4_K": gw.GGML_Q4_K, "Q6_K": gw.GGML_Q6_K}
# rms of a block's values in units of d (see the module docstring)
_RMS_IN_D = {gw.GGML_Q8_0: 73.6, gw.GGML_Q4_K: 89.8, gw.GGML_Q6_K: 82.6}
N_BYTE_TOKENS, SPECIALS = 256, ("<|startoftext|>", "<|im_start|>",
                                "<|im_end|>")


@dataclass
class Shape:
    """The model as the program runs it, read from a configuration file."""
    arch: str
    n_layers: int
    dim: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ff: int
    n_vocab: int
    n_speech: int
    eps: float
    theta: float
    n_ctx: int
    qkv_bias: bool
    qk_norm: bool
    tie: bool
    conv_l: int
    layer_types: tuple | None       # "attn" / "conv" per layer, or None
    quant: dict = field(default_factory=dict)

    def fmt(self, role: str) -> int:
        return FORMATS[self.quant.get(role, self.quant["default"])]

    @property
    def attn_layers(self) -> list[int]:
        return [i for i in range(self.n_layers)
                if self.layer_types is None or self.layer_types[i] == "attn"]


def _lfm2_ff(c: dict) -> int:
    """LFM2's feed-forward width: with block_auto_adjust_ff_dim, 2/3 of
    intermediate_size times block_ffn_dim_multiplier, rounded up to
    block_multiple_of (HF Lfm2MLP)."""
    ff = c["intermediate_size"]
    if c.get("block_auto_adjust_ff_dim"):
        ff = int(2 * ff / 3)
        ff = int(c.get("block_ffn_dim_multiplier", 1.0) * ff)
        m = c.get("block_multiple_of", 256)
        ff = m * ((ff + m - 1) // m)
    return ff


def shape_of(c: dict) -> Shape:
    """A configuration file's dict -> Shape."""
    lfm2 = c["model_type"] == "lfm2"
    heads = c["num_attention_heads"]
    types = None
    if lfm2:
        types = tuple("attn" if t == "full_attention" else "conv"
                      for t in c["layer_types"])
    return Shape(
        arch=c["model_type"], n_layers=c["num_hidden_layers"],
        dim=c["hidden_size"], n_heads=heads,
        n_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        ff=_lfm2_ff(c) if lfm2 else c["intermediate_size"],
        n_vocab=c["vocab_size"], n_speech=c["n_speech_codes"],
        eps=float(c.get("norm_eps", c.get("rms_norm_eps", 1e-6))),
        theta=float(c["rope_theta"]), n_ctx=c["max_position_embeddings"],
        qkv_bias=not lfm2, qk_norm=lfm2,
        tie=bool(c.get("tie_embedding", c.get("tie_word_embeddings"))),
        conv_l=c.get("conv_L_cache", 3), layer_types=types,
        quant=dict(c["quant"]))


@dataclass
class Tensor:
    name: str
    shape: tuple          # numpy order: [rows, cols] for a matrix
    ggml_type: int
    payload: np.ndarray   # the stored bytes, uint8


@dataclass
class Model:
    """One seeded model file's contents: KV metadata and tensors, kept on
    the host after the draw (the reference reads the same bytes)."""
    kv: list
    tensors: dict         # name -> Tensor, in file order

    def write(self, f) -> None:
        w = gw.Writer()
        for key, value in self.kv:
            (w.array if isinstance(value, list) else w.kv)(key, value)
        for t in self.tensors.values():
            w.tensor(t.name, t.shape, t.ggml_type, t.payload)
        w.write(f)


def _half(x: torch.Tensor) -> torch.Tensor:
    """fp16 values as [n, 2] bytes."""
    return x.to(torch.float16).contiguous().view(torch.uint8).reshape(-1, 2)


def _blocks(fmt: int, sigmas: torch.Tensor, gen, dev) -> torch.Tensor:
    """[nb, block bytes] uint8 blocks of format `fmt` whose values have the
    per-block spread `sigmas` [nb]."""
    nb = sigmas.numel()
    size = gw.BLOCK[fmt][1]
    out = torch.randint(0, 256, (nb, size), dtype=torch.uint8, generator=gen,
                        device=dev)
    d = sigmas / _RMS_IN_D[fmt] * (0.75 + 0.5 * torch.rand(
        nb, generator=gen, device=dev))
    if fmt == gw.GGML_Q8_0:
        q = torch.randint(-127, 128, (nb, 32), dtype=torch.int8,
                          generator=gen, device=dev)
        out[:, 2:] = q.view(torch.uint8)
        out[:, :2] = _half(d)
    elif fmt == gw.GGML_Q4_K:
        sc = torch.randint(1, 34, (nb, 8), generator=gen, device=dev)
        mn = torch.round(1.875 * sc.float()).long()
        out[:, 0:2] = _half(d)
        out[:, 2:4] = _half(4.0 * d)
        packed = torch.empty((nb, 12), dtype=torch.long, device=dev)
        packed[:, 0:4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
        packed[:, 4:8] = (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6)
        packed[:, 8:12] = (sc[:, 4:] & 15) | ((mn[:, 4:] & 15) << 4)
        out[:, 4:16] = packed.to(torch.uint8)
    elif fmt == gw.GGML_Q6_K:
        out[:, 192:208] = torch.randint(1, 8, (nb, 16), dtype=torch.uint8,
                                        generator=gen, device=dev)
        out[:, 208:210] = _half(d)
    else:
        raise ValueError(f"no block maker for ggml type {fmt}")
    return out


def _draw(specs: list, gen, dev) -> dict:
    """specs: [(name, shape, ggml_type, sigma, offset)] -> {name: Tensor}.
    One draw per format: every quantized tensor of a format shares one
    block buffer (sigma = the weights' spread), every f32 tensor one normal
    draw (offset + sigma * N(0, 1)); one copy to the host each."""
    out = {}
    by_fmt: dict[int, list] = {}
    for s in specs:
        by_fmt.setdefault(s[2], []).append(s)
    for fmt, group in by_fmt.items():
        counts = [int(np.prod(s[1])) // gw.BLOCK[fmt][0] for s in group]
        reps = torch.tensor(counts, device=dev)
        sig = torch.repeat_interleave(
            torch.tensor([s[3] for s in group], dtype=torch.float32,
                         device=dev), reps)
        if fmt in (gw.GGML_F32, gw.GGML_I32):
            off = torch.repeat_interleave(
                torch.tensor([s[4] for s in group], dtype=torch.float32,
                             device=dev), reps)
            vals = off + sig * torch.randn(sig.numel(), generator=gen,
                                           device=dev)
            host = vals.cpu().numpy().view(np.uint8)
            per = 4
        else:
            host = _blocks(fmt, sig, gen, dev).cpu().numpy().reshape(-1)
            per = gw.BLOCK[fmt][1]
        pos = 0
        for s, n in zip(group, counts):
            out[s[0]] = Tensor(s[0], tuple(s[1]), fmt,
                               host[pos:pos + n * per])
            pos += n * per
    return {s[0]: out[s[0]] for s in specs}


def vocab(shape: Shape) -> tuple[list[str], list[int]]:
    """Byte tokens (the GPT-2 byte-to-unicode table), the chat specials and
    the <|s_N|> speech tokens, with their llama.cpp token types."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    b2u = dict(zip(bs, (chr(c) for c in cs)))
    tokens = [b2u[b] for b in range(N_BYTE_TOKENS)] + list(SPECIALS)
    tokens += [f"<|s_{i}|>" for i in range(shape.n_speech)]
    types = [1] * N_BYTE_TOKENS + [3] * len(SPECIALS) + [4] * shape.n_speech
    if len(tokens) != shape.n_vocab:
        raise ValueError(f"vocab {len(tokens)} != vocab_size {shape.n_vocab}")
    return tokens, types


def make_llm(shape: Shape, seed: int, device) -> Model:
    """The seeded LLM file (llama.cpp tensor names and tokenizer KVs)."""
    a, D = shape.arch, shape.dim
    qd, kvd = shape.n_heads * shape.head_dim, shape.n_kv_heads * shape.head_dim
    specs = []

    def mat(name, role, rows, cols):
        specs.append((name, (rows, cols), shape.fmt(role),
                      1.0 / np.sqrt(cols), 0.0))

    def vec(name, n, sigma, offset=0.0, cols=None):
        specs.append((name, (n,) if cols is None else (n, cols),
                      gw.GGML_F32, sigma, offset))

    mat("token_embd.weight", "token_embd", shape.n_vocab, D)
    for i in range(shape.n_layers):
        p = f"blk.{i}."
        vec(p + "attn_norm.weight", D, 0.1, 1.0)
        if shape.layer_types is not None and shape.layer_types[i] == "conv":
            vec(p + "shortconv.conv.weight", D, 0.5, cols=shape.conv_l)
            mat(p + "shortconv.in_proj.weight", "in_proj", 3 * D, D)
            mat(p + "shortconv.out_proj.weight", "out_proj", D, D)
        else:
            mat(p + "attn_q.weight", "attn_q", qd, D)
            mat(p + "attn_k.weight", "attn_k", kvd, D)
            mat(p + "attn_v.weight", "attn_v", kvd, D)
            mat(p + "attn_output.weight", "attn_output", D, qd)
            if shape.qkv_bias:
                for nm, n in (("attn_q", qd), ("attn_k", kvd),
                              ("attn_v", kvd)):
                    vec(p + nm + ".bias", n, 0.1)
            if shape.qk_norm:
                vec(p + "attn_q_norm.weight", shape.head_dim, 0.1, 1.0)
                vec(p + "attn_k_norm.weight", shape.head_dim, 0.1, 1.0)
        vec(p + "ffn_norm.weight", D, 0.1, 1.0)
        mat(p + "ffn_gate.weight", "ffn_gate", shape.ff, D)
        mat(p + "ffn_up.weight", "ffn_up", shape.ff, D)
        mat(p + "ffn_down.weight", "ffn_down", D, shape.ff)
    vec("output_norm.weight", D, 0.1, 1.0)
    if not shape.tie:
        mat("output.weight", "output", shape.n_vocab, D)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    tensors = _draw(specs, gen, device)
    tokens, types = vocab(shape)
    kv = [("general.architecture", a), (f"{a}.block_count", shape.n_layers),
          (f"{a}.embedding_length", D),
          (f"{a}.feed_forward_length", shape.ff),
          (f"{a}.attention.key_length", shape.head_dim),
          (f"{a}.attention.layer_norm_rms_epsilon", shape.eps),
          (f"{a}.context_length", shape.n_ctx),
          (f"{a}.rope.freq_base", shape.theta)]
    if shape.layer_types is None:
        kv += [(f"{a}.attention.head_count", shape.n_heads),
               (f"{a}.attention.head_count_kv", shape.n_kv_heads)]
    else:
        kv += [(f"{a}.attention.head_count",
                [shape.n_heads if t == "attn" else 0
                 for t in shape.layer_types]),
               (f"{a}.attention.head_count_kv",
                [shape.n_kv_heads if t == "attn" else 0
                 for t in shape.layer_types]),
               (f"{a}.shortconv.l_cache", shape.conv_l)]
    kv += [("tokenizer.ggml.model", "gpt2"), ("tokenizer.ggml.pre", "qwen2"),
           ("tokenizer.ggml.tokens", tokens),
           ("tokenizer.ggml.token_type", types),
           ("tokenizer.ggml.merges", []),
           ("tokenizer.ggml.eos_token_id", tokens.index("<|im_end|>"))]
    return Model(kv=kv, tensors=tensors)


# The codec's hyperparameters (MioCodec, the program's CodecConfig defaults)
CODEC = dict(sample_rate=44100, n_fft=392, hop_length=98,
             samples_per_token=1764, head_out_dim=394, prenet_layers=6,
             prenet_dim=768, prenet_heads=12, prenet_ff=2048,
             prenet_window=65, decoder_layers=8, decoder_dim=512,
             decoder_heads=8, decoder_ff=1536, decoder_window=65,
             adaln_dim=128, resnet_blocks=2, resnet_groups=32,
             upsampler_stages=2, up_factors=(3, 3), up_kernels=(7, 7),
             up_channels=(256, 128), rope_theta=10000.0, norm_eps=1e-5,
             group_norm_eps=1e-6)


def codec_specs(c: dict, n_codes: int) -> list:
    """(name, shape, ggml_type, sigma, offset) of every codec tensor, in the
    reference layout (`upstream src/miocodec.cpp` names)."""
    specs = []
    f32 = gw.GGML_F32

    def t(name, *shape, sigma=0.05, offset=0.0):
        specs.append((name, shape, f32, sigma, offset))

    def norm(name, n):
        t(name + ".weight", n, offset=1.0)
        t(name + ".bias", n)

    def resnet(p, ch):
        for k in (1, 2):
            t(p + f"norm{k}.weight", ch, offset=1.0)
            t(p + f"norm{k}.bias", ch)
            t(p + f"conv{k}.weight", ch, ch, 3)
            t(p + f"conv{k}.bias", ch)

    dp, dd = c["prenet_dim"], c["decoder_dim"]
    t("token_embd", n_codes, dp, sigma=0.5)
    for i in range(c["prenet_layers"]):
        p = f"wave_prenet.blk.{i}."
        norm(p + "attn_norm", dp)
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            t(p + nm + ".weight", dp, dp)
        norm(p + "ffn_norm", dp)
        t(p + "ffn_gate.weight", c["prenet_ff"], dp)
        t(p + "ffn_up.weight", c["prenet_ff"], dp)
        t(p + "ffn_down.weight", dp, c["prenet_ff"])
    norm("wave_prenet.norm", dp)
    t("wave_prenet.output.weight", dd, dp)
    t("wave_prenet.output.bias", dd)
    t("wave_upsample.weight", dd, dd, 2)
    t("wave_upsample.bias", dd)
    for b in range(c["resnet_blocks"]):
        resnet(f"wave_prior.{b}.", dd)
    for i in range(c["decoder_layers"]):
        p = f"wave_decoder.blk.{i}."
        for nm in ("attn_cond", "ffn_cond"):
            t(p + nm + ".weight", 3 * dd, c["adaln_dim"])
            t(p + nm + ".bias", 3 * dd)
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            t(p + nm + ".weight", dd, dd)
        t(p + "ffn_gate.weight", c["decoder_ff"], dd)
        t(p + "ffn_up.weight", c["decoder_ff"], dd)
        t(p + "ffn_down.weight", dd, c["decoder_ff"])
    t("wave_decoder.norm_cond.weight", 2 * dd, c["adaln_dim"])
    t("wave_decoder.norm_cond.bias", 2 * dd)
    for b in range(c["resnet_blocks"]):
        resnet(f"wave_post.{b}.", dd)
    ch = dd
    for s in range(c["upsampler_stages"]):
        out = c["up_channels"][s]
        t(f"wave_upsampler.up.{s}.weight", ch, out, c["up_kernels"][s])
        t(f"wave_upsampler.up.{s}.bias", out)
        t(f"wave_upsampler.snake.{s}.alpha", out, sigma=0.3)
        t(f"wave_upsampler.snake.{s}.beta", out, sigma=0.3)
        resnet(f"wave_upsampler.resblk.{s}.", out)
        ch = out
    t("wave_upsampler.out_proj.weight", dd, ch)
    t("wave_upsampler.out_proj.bias", dd)
    t("wave_upsampler.out_snake.alpha", dd, sigma=0.3)
    t("wave_upsampler.out_snake.beta", dd, sigma=0.3)
    # a quiet head: log-magnitudes near -2.5, so the audio stays well
    # inside [-1, 1] and no int16 sample clips
    nf = c["n_fft"] // 2 + 1
    t("istft_head.out.weight", c["head_out_dim"], dd, sigma=0.01)
    specs.append(("istft_head.out.bias.mag", (nf,), f32, 0.05, -2.5))
    specs.append(("istft_head.out.bias.phase", (c["head_out_dim"] - nf,),
                  f32, 0.5, 0.0))
    return specs


def make_codec(c: dict, n_codes: int, seed: int, device) -> Model:
    """The seeded f32 codec file; the config's sizes are written as KVs."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 1) % (1 << 63))
    drawn = _draw(codec_specs(c, n_codes), gen, device)
    mag = drawn.pop("istft_head.out.bias.mag")
    phase = drawn.pop("istft_head.out.bias.phase")
    bias = np.concatenate([mag.payload, phase.payload])
    drawn["istft_head.out.bias"] = Tensor(
        "istft_head.out.bias", (c["head_out_dim"],), gw.GGML_F32, bias)
    tensors = {
        "miocodec.wave_upsampler.factors": Tensor(
            "miocodec.wave_upsampler.factors", (len(c["up_factors"]),),
            gw.GGML_I32, np.asarray(c["up_factors"], np.int32).view(np.uint8)),
        "miocodec.wave_upsampler.kernel_sizes": Tensor(
            "miocodec.wave_upsampler.kernel_sizes", (len(c["up_kernels"]),),
            gw.GGML_I32, np.asarray(c["up_kernels"], np.int32).view(np.uint8)),
        **drawn}
    renamed = {"head_out_dim": "embedding_length_out",
               "adaln_dim": "miocodec.decoder_adanorm_dim",
               "upsampler_stages": "miocodec.wave_upsampler_layers"}
    kv = [("general.architecture", "miocodec")]
    kv += [(renamed.get(key, f"miocodec.{key}"), value)
           for key, value in c.items()
           if key not in ("up_factors", "up_kernels", "up_channels")]
    return Model(kv=kv, tensors=tensors)


def make_voice(dim: int, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 2) % (1 << 63))
    return (0.3 * torch.randn(dim, generator=gen, device=device)).cpu().numpy()


@contextmanager
def memory_file(model: Model, label: str):
    """The model written to an anonymous memory file; yields a path that
    opens it (/proc/self/fd/<n>) while the context is open."""
    fd = os.memfd_create(f"portbench-{label}")
    try:
        with os.fdopen(os.dup(fd), "wb") as f:
            model.write(f)
        yield f"/proc/self/fd/{fd}"
    finally:
        os.close(fd)

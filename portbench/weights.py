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

The LLM's tensors and metadata are its architecture's
(archs/<model_type>.py).  A matrix's format is the configuration's
`quant` for its role, else quant["default"]; quant["mix"] names a
per-layer rule (MIXES: llama.cpp's Q4_K_M) for the roles it chooses.

The files go to `os.memfd_create` memory files, read through
/proc/self/fd/<n>: a run writes nothing to disk for its weights.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import gguf_writer as gw

FORMATS = {"Q8_0": gw.GGML_Q8_0, "Q4_K": gw.GGML_Q4_K, "Q6_K": gw.GGML_Q6_K}
F32 = "F32"            # the role of a tensor stored as f32, unquantized
# rms of a block's values in units of d (see the module docstring)
_RMS_IN_D = {gw.GGML_Q8_0: 73.6, gw.GGML_Q4_K: 89.8, gw.GGML_Q6_K: 82.6}
N_BYTE_TOKENS, SPECIALS = 256, ("<|startoftext|>", "<|im_start|>",
                                "<|im_end|>")
PB = Path(__file__).resolve().parent


@dataclass
class Shape:
    """The model as the program runs it, read from a configuration file:
    the sizes every architecture has, which the judge and the readers use,
    and in `sizes` what one architecture adds (archs/<model_type>.py)."""
    arch: str                       # the configuration's model_type
    n_layers: int
    dim: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_vocab: int
    n_speech: int
    eps: float
    theta: float
    n_ctx: int
    tie: bool
    quant: dict
    attn_layers: list               # the layers that attend over a cache
    sizes: dict = field(default_factory=dict)
    impl: object = field(default=None, repr=False, compare=False)


def arch(model_type: str, root: Path = PB):
    """The architecture module of `model_type`: <root>/archs/<model_type>.py,
    else the benchmark's own archs/<model_type>.py."""
    path = root / "archs" / f"{model_type}.py"
    if not path.is_file():
        own = PB / "archs" / f"{model_type}.py"
        if not own.is_file():
            raise FileNotFoundError(
                f"model_type {model_type!r} has no architecture file: "
                f"{path} is missing")
        path = own
    if path.parent == PB / "archs":
        return importlib.import_module(f"portbench.archs.{model_type}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.archs.{model_type}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def archs(root: Path = PB) -> list:
    """The architecture files found under <root>/archs, by model_type."""
    return sorted(p.stem for p in (root / "archs").glob("*.py")
                  if p.stem != "__init__")


def shape_of(c: dict, root: Path = PB) -> Shape:
    """A configuration file's dict -> Shape, by its model_type's
    architecture file."""
    mod = arch(c["model_type"], root)
    s = mod.shape_of(c)
    s.impl = mod
    return s


def shape_from(c: dict, attn_layers: list, **sizes) -> Shape:
    """The sizes every architecture reads from a config.json alike, with
    the architecture's own `sizes`."""
    heads = c["num_attention_heads"]
    return Shape(
        arch=c["model_type"], n_layers=c["num_hidden_layers"],
        dim=c["hidden_size"], n_heads=heads,
        n_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        n_vocab=c["vocab_size"], n_speech=c["n_speech_codes"],
        eps=float(c.get("norm_eps", c.get("rms_norm_eps", 1e-6))),
        theta=float(c["rope_theta"]), n_ctx=c["max_position_embeddings"],
        tie=bool(c.get("tie_embedding", c.get("tie_word_embeddings"))),
        quant=dict(c["quant"]), attn_layers=list(attn_layers), sizes=sizes)


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp's use_more_bits: the first and last eighth of n layers
    and every third layer between them."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def _mix_kind(role: str, tie: bool) -> str | None:
    """The kind of tensor llama.cpp's per-layer mixes choose by (tensor
    names matched as llama_tensor_get_type matches them)."""
    if role == "attn_v":
        return "attn_v"
    if role.startswith("ffn_down"):
        return "ffn_down"
    if role == "output" or (tie and role == "token_embd"):
        return "head"
    return None


def _q4_k_m(kind: str, i: int, n: int) -> str:
    """llama.cpp's Q4_K_M for the i-th of n tensors of a kind: attn_v and
    ffn_down in Q6_K where use_more_bits, else Q4_K; the head in Q6_K."""
    return "Q6_K" if kind == "head" or use_more_bits(i, n) else "Q4_K"


# per-layer quantization rules, by the name a configuration's quant gives
# under "mix"; roles the rule does not choose take their own format or
# the default
MIXES = {"Q4_K_M": _q4_k_m}


def resolve(s: Shape, specs: list) -> list:
    """An architecture's (name, shape, role, sigma, offset) in file order ->
    (name, shape, ggml_type, sigma, offset): role F32 as f32; a role that
    the quant's mix chooses by its index among the tensors of its kind;
    any other by quant[role], else quant["default"]."""
    mix = MIXES[s.quant["mix"]] if "mix" in s.quant else None
    kinds = [_mix_kind(sp[2], s.tie) if mix and sp[2] != F32 else None
             for sp in specs]
    total, seen = Counter(k for k in kinds if k), Counter()
    out = []
    for (name, shape, role, sigma, offset), kind in zip(specs, kinds):
        if role == F32:
            fmt = gw.GGML_F32
        elif kind:
            if role in s.quant:
                raise ValueError(f"quant gives {role} a format and the mix "
                                 f"{s.quant['mix']} chooses it too")
            fmt = FORMATS[mix(kind, seen[kind], total[kind])]
            seen[kind] += 1
        else:
            fmt = FORMATS[s.quant.get(role, s.quant["default"])]
        out.append((name, shape, fmt, sigma, offset))
    return out


def mat(name: str, role: str, rows: int, cols: int) -> tuple:
    """A weight matrix [rows, cols] whose values spread 1 / sqrt(cols)."""
    return (name, (rows, cols), role, 1.0 / np.sqrt(cols), 0.0)


def vec(name: str, n: int, sigma: float, offset: float = 0.0,
        cols: int | None = None) -> tuple:
    """An f32 tensor [n] (or [n, cols]): offset + sigma * N(0, 1)."""
    return (name, (n,) if cols is None else (n, cols), F32, sigma, offset)


def attention_specs(p: str, s: Shape, bias: bool = False,
                    qk_norm: bool = False) -> list:
    """A GQA block's tensors (after its norm), in llama.cpp's order."""
    qd, kvd = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    out = [mat(p + "attn_q.weight", "attn_q", qd, s.dim),
           mat(p + "attn_k.weight", "attn_k", kvd, s.dim),
           mat(p + "attn_v.weight", "attn_v", kvd, s.dim),
           mat(p + "attn_output.weight", "attn_output", s.dim, qd)]
    if bias:
        out += [vec(p + nm + ".bias", n, 0.1)
                for nm, n in (("attn_q", qd), ("attn_k", kvd),
                              ("attn_v", kvd))]
    if qk_norm:
        out += [vec(p + "attn_q_norm.weight", s.head_dim, 0.1, 1.0),
                vec(p + "attn_k_norm.weight", s.head_dim, 0.1, 1.0)]
    return out


def ffn_specs(p: str, s: Shape, ff: int) -> list:
    """A SwiGLU feed-forward's norm and matrices."""
    return [vec(p + "ffn_norm.weight", s.dim, 0.1, 1.0),
            mat(p + "ffn_gate.weight", "ffn_gate", ff, s.dim),
            mat(p + "ffn_up.weight", "ffn_up", ff, s.dim),
            mat(p + "ffn_down.weight", "ffn_down", s.dim, ff)]


def base_kv(s: Shape, ff: int) -> list:
    """The metadata KVs every architecture writes alike."""
    a = s.impl.GGUF_ARCH
    return [(f"{a}.block_count", s.n_layers), (f"{a}.embedding_length", s.dim),
            (f"{a}.feed_forward_length", ff),
            (f"{a}.attention.key_length", s.head_dim),
            (f"{a}.attention.layer_norm_rms_epsilon", s.eps),
            (f"{a}.context_length", s.n_ctx), (f"{a}.rope.freq_base", s.theta)]


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


def llm_specs(s: Shape) -> list:
    """The LLM file's tensors, (name, shape, ggml_type, sigma, offset) in
    file order: token_embd, the architecture's layers, output_norm and an
    untied head."""
    specs = [mat("token_embd.weight", "token_embd", s.n_vocab, s.dim)]
    specs += s.impl.tensor_specs(s)
    specs.append(vec("output_norm.weight", s.dim, 0.1, 1.0))
    if not s.tie:
        specs.append(mat("output.weight", "output", s.n_vocab, s.dim))
    return resolve(s, specs)


def llm_kv(s: Shape) -> list:
    """The LLM file's metadata: its architecture's KVs, then the
    tokenizer's."""
    tokens, types = vocab(s)
    return ([("general.architecture", s.impl.GGUF_ARCH)] + s.impl.gguf_kv(s)
            + [("tokenizer.ggml.model", "gpt2"),
               # the pre-tokenizer's regex (the program's tokenizer keys on
               # it), whatever the architecture
               ("tokenizer.ggml.pre", "qwen2"),
               ("tokenizer.ggml.tokens", tokens),
               ("tokenizer.ggml.token_type", types),
               ("tokenizer.ggml.merges", []),
               ("tokenizer.ggml.eos_token_id", tokens.index("<|im_end|>"))])


def make_llm(shape: Shape, seed: int, device) -> Model:
    """The seeded LLM file (llama.cpp tensor names and tokenizer KVs)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return Model(kv=llm_kv(shape), tensors=_draw(llm_specs(shape), gen,
                                                 device))


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

"""Synthetic GGUF model writers (random weights, real container layout).

Tests and `chip_smoke.py` build their own GGUF files with the exact tensor names/shapes the reference models
use (codec names per `upstream src/miocodec.cpp:598-737`, LLM names
per the llama.cpp GGUF conventions).  Benchmarks use full-size configs so
compute shapes match the real models; tests shrink dimensions.
"""

from __future__ import annotations

import numpy as np

from ..gguf import GGUFWriter, GGML_F32, GGML_I32, GGML_Q6_K
from .codec import CodecConfig
from .llm import LLMConfig


def synthetic_codec_config(tiny: bool = True) -> CodecConfig:
    if tiny:
        return CodecConfig(
            prenet_layers=2, prenet_dim=64, prenet_heads=4, prenet_ff=96,
            prenet_window=9,
            decoder_layers=2, decoder_dim=32, decoder_heads=2, decoder_ff=48,
            decoder_window=9, adaln_dim=16,
            resnet_blocks=2, resnet_groups=4, upsampler_stages=2,
            up_factors=(3, 3), up_kernels=(7, 7),
        )
    return CodecConfig()  # full reference size


def write_synthetic_codec(path: str, cfg: CodecConfig | None = None,
                          n_codes: int = 256, seed: int = 0,
                          up_channels: tuple[int, ...] | None = None) -> CodecConfig:
    """Write a codec GGUF with random weights in the reference layout.

    `up_channels`: channel sizes after each upsampler stage; the final one
    must match the out_proj input dim (128 in the real model).
    """
    if cfg is None:
        cfg = synthetic_codec_config(tiny=True)
    rng = np.random.default_rng(seed)
    d_pre = cfg.prenet_dim
    d_dec = cfg.decoder_dim
    if up_channels is None:
        if d_dec == 512:
            up_channels = (256, 128)
        else:
            up_channels = tuple(max(cfg.resnet_groups, d_dec // (2 ** (s + 1)))
                                for s in range(cfg.upsampler_stages))

    def rnd(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = GGUFWriter(path)
    w.add_kv("general.architecture", "miocodec")
    w.add_kv("miocodec.sample_rate", cfg.sample_rate)
    w.add_kv("miocodec.n_fft", cfg.n_fft)
    w.add_kv("miocodec.hop_length", cfg.hop_length)
    w.add_kv("miocodec.samples_per_token", cfg.samples_per_token)
    w.add_kv("embedding_length_out", cfg.head_out_dim)
    w.add_kv("miocodec.prenet_layers", cfg.prenet_layers)
    w.add_kv("miocodec.prenet_dim", cfg.prenet_dim)
    w.add_kv("miocodec.prenet_heads", cfg.prenet_heads)
    w.add_kv("miocodec.prenet_ff", cfg.prenet_ff)
    w.add_kv("miocodec.prenet_window", cfg.prenet_window)
    w.add_kv("miocodec.decoder_layers", cfg.decoder_layers)
    w.add_kv("miocodec.decoder_dim", cfg.decoder_dim)
    w.add_kv("miocodec.decoder_heads", cfg.decoder_heads)
    w.add_kv("miocodec.decoder_ff", cfg.decoder_ff)
    w.add_kv("miocodec.decoder_window", cfg.decoder_window)
    w.add_kv("miocodec.decoder_adanorm_dim", cfg.adaln_dim)
    w.add_kv("miocodec.resnet_blocks", cfg.resnet_blocks)
    w.add_kv("miocodec.resnet_groups", cfg.resnet_groups)
    w.add_kv("miocodec.wave_upsampler_layers", cfg.upsampler_stages)
    w.add_kv("miocodec.rope_theta", cfg.rope_theta)
    w.add_kv("miocodec.norm_eps", cfg.norm_eps)
    w.add_kv("miocodec.group_norm_eps", cfg.group_norm_eps)

    w.add_tensor("miocodec.wave_upsampler.factors",
                 np.asarray(cfg.up_factors, np.int32), GGML_I32)
    w.add_tensor("miocodec.wave_upsampler.kernel_sizes",
                 np.asarray(cfg.up_kernels, np.int32), GGML_I32)

    w.add_tensor("token_embd", rnd(n_codes, d_pre, scale=0.5), GGML_F32)

    for i in range(cfg.prenet_layers):
        p = f"wave_prenet.blk.{i}."
        w.add_tensor(p + "attn_norm.weight", np.ones(d_pre, np.float32) + rnd(d_pre))
        w.add_tensor(p + "attn_norm.bias", rnd(d_pre))
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            w.add_tensor(p + nm + ".weight", rnd(d_pre, d_pre))
        w.add_tensor(p + "ffn_norm.weight", np.ones(d_pre, np.float32) + rnd(d_pre))
        w.add_tensor(p + "ffn_norm.bias", rnd(d_pre))
        w.add_tensor(p + "ffn_gate.weight", rnd(cfg.prenet_ff, d_pre))
        w.add_tensor(p + "ffn_up.weight", rnd(cfg.prenet_ff, d_pre))
        w.add_tensor(p + "ffn_down.weight", rnd(d_pre, cfg.prenet_ff))

    w.add_tensor("wave_prenet.norm.weight", np.ones(d_pre, np.float32) + rnd(d_pre))
    w.add_tensor("wave_prenet.norm.bias", rnd(d_pre))
    w.add_tensor("wave_prenet.output.weight", rnd(d_dec, d_pre))
    w.add_tensor("wave_prenet.output.bias", rnd(d_dec))

    # torch ConvTranspose1d weight [in, out, k]
    w.add_tensor("wave_upsample.weight", rnd(d_dec, d_dec, 2))
    w.add_tensor("wave_upsample.bias", rnd(d_dec))

    def resnet(prefix, ch):
        w.add_tensor(prefix + "norm1.weight", np.ones(ch, np.float32) + rnd(ch))
        w.add_tensor(prefix + "norm1.bias", rnd(ch))
        w.add_tensor(prefix + "conv1.weight", rnd(ch, ch, 3))
        w.add_tensor(prefix + "conv1.bias", rnd(ch))
        w.add_tensor(prefix + "norm2.weight", np.ones(ch, np.float32) + rnd(ch))
        w.add_tensor(prefix + "norm2.bias", rnd(ch))
        w.add_tensor(prefix + "conv2.weight", rnd(ch, ch, 3))
        w.add_tensor(prefix + "conv2.bias", rnd(ch))

    for b in range(cfg.resnet_blocks):
        resnet(f"wave_prior.{b}.", d_dec)

    for i in range(cfg.decoder_layers):
        p = f"wave_decoder.blk.{i}."
        w.add_tensor(p + "attn_cond.weight", rnd(3 * d_dec, cfg.adaln_dim))
        w.add_tensor(p + "attn_cond.bias", rnd(3 * d_dec))
        w.add_tensor(p + "ffn_cond.weight", rnd(3 * d_dec, cfg.adaln_dim))
        w.add_tensor(p + "ffn_cond.bias", rnd(3 * d_dec))
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            w.add_tensor(p + nm + ".weight", rnd(d_dec, d_dec))
        w.add_tensor(p + "ffn_gate.weight", rnd(cfg.decoder_ff, d_dec))
        w.add_tensor(p + "ffn_up.weight", rnd(cfg.decoder_ff, d_dec))
        w.add_tensor(p + "ffn_down.weight", rnd(d_dec, cfg.decoder_ff))

    w.add_tensor("wave_decoder.norm_cond.weight", rnd(2 * d_dec, cfg.adaln_dim))
    w.add_tensor("wave_decoder.norm_cond.bias", rnd(2 * d_dec))

    for b in range(cfg.resnet_blocks):
        resnet(f"wave_post.{b}.", d_dec)

    in_ch = d_dec
    for s in range(cfg.upsampler_stages):
        out_ch = up_channels[s]
        w.add_tensor(f"wave_upsampler.up.{s}.weight",
                     rnd(in_ch, out_ch, cfg.up_kernels[s]))
        w.add_tensor(f"wave_upsampler.up.{s}.bias", rnd(out_ch))
        w.add_tensor(f"wave_upsampler.snake.{s}.alpha", rnd(out_ch, scale=0.3))
        w.add_tensor(f"wave_upsampler.snake.{s}.beta", rnd(out_ch, scale=0.3))
        resnet(f"wave_upsampler.resblk.{s}.", out_ch)
        in_ch = out_ch

    w.add_tensor("wave_upsampler.out_proj.weight", rnd(d_dec, in_ch))
    w.add_tensor("wave_upsampler.out_proj.bias", rnd(d_dec))
    w.add_tensor("wave_upsampler.out_snake.alpha", rnd(d_dec, scale=0.3))
    w.add_tensor("wave_upsampler.out_snake.beta", rnd(d_dec, scale=0.3))

    w.add_tensor("istft_head.out.weight", rnd(cfg.head_out_dim, d_dec))
    w.add_tensor("istft_head.out.bias", rnd(cfg.head_out_dim))

    w.write()
    return cfg


# ---------------------------------------------------------------------------
# Synthetic LLM
# ---------------------------------------------------------------------------

def make_synthetic_vocab(n_speech: int = 64) -> tuple[list[str], list[int]]:
    """Byte-level vocab (256 byte tokens) + chat specials + speech tokens.

    Mirrors the MioTTS vocab structure: `<|s_N|>` tokens are user-defined
    single tokens."""
    from ..text.tokenizer import (
        TOKEN_TYPE_CONTROL, TOKEN_TYPE_NORMAL, TOKEN_TYPE_USER_DEFINED,
        _byte_to_unicode,
    )
    b2u = _byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    types = [TOKEN_TYPE_NORMAL] * 256
    for sp in ("<|startoftext|>", "<|im_start|>", "<|im_end|>"):
        tokens.append(sp)
        types.append(TOKEN_TYPE_CONTROL)
    for i in range(n_speech):
        tokens.append(f"<|s_{i}|>")
        types.append(TOKEN_TYPE_USER_DEFINED)
    return tokens, types


def synthetic_llm_config(n_speech: int = 64, tiny: bool = True,
                         arch: str = "qwen2") -> LLMConfig:
    from .llm import _ARCH_TABLE
    n_vocab = 256 + 3 + n_speech
    toggles = _ARCH_TABLE[arch]
    if tiny:
        return LLMConfig(arch=arch, n_layers=2, dim=64, n_heads=4,
                         n_kv_heads=2, head_dim=16, ff_dim=128,
                         n_vocab=n_vocab, n_ctx=256, **toggles)
    return LLMConfig(arch=arch, n_vocab=n_vocab, **toggles)


def synthetic_lfm2moe_config(n_speech: int = 64) -> LLMConfig:
    """A tiny lfm2moe: dim 64, layers conv / attn / conv / conv, the first
    dense (ff 128), then 8 experts of width 64, 2 a token."""
    from .llm import _ARCH_TABLE, MoeLLMConfig
    return MoeLLMConfig(arch="lfm2moe", n_layers=4, dim=64, n_heads=4,
                     n_kv_heads=2, head_dim=16, ff_dim=128,
                        n_vocab=256 + 3 + n_speech, n_ctx=256,
                        layer_types=("conv", "attn", "conv", "conv"),
                        conv_l_cache=3, n_experts=8, n_experts_used=2,
                        expert_ff_dim=64, n_dense_layers=1,
                        **_ARCH_TABLE["lfm2moe"])


def write_synthetic_llm(path: str, cfg: LLMConfig | None = None,
                        quant_type: int = GGML_F32, seed: int = 0,
                        n_speech: int = 64,
                        weights: dict | None = None,
                        mixed_k: bool = False) -> LLMConfig:
    """Write an LLM GGUF (llama.cpp tensor naming + tokenizer KVs).

    `weights`: optional {gguf_name: np.ndarray} overriding random init (used
    by the HF-parity test to export a torch model's weights).

    `mixed_k`: reproduce llama.cpp's Q4_K_M per-tensor mix — attn_v and
    ffn_down in Q6_K while the rest uses `quant_type` — so loader fusion
    sees heterogeneous formats like real downloaded files.

    An expert model (a MoeLLMConfig) writes llama.cpp's lfm2moe tensors in
    its expert layers: the f32 router ffn_gate_inp [E, dim] and bias
    exp_probs_b [E], and the stacks ffn_{gate,up}_exps [E, F, dim] and
    ffn_down_exps [E, dim, F] in `quant_type`."""
    if cfg is None:
        cfg = synthetic_llm_config(n_speech=n_speech)
    else:
        n_speech = cfg.n_vocab - 256 - 3
    rng = np.random.default_rng(seed)
    tokens, types = make_synthetic_vocab(n_speech)
    assert len(tokens) == cfg.n_vocab, (len(tokens), cfg.n_vocab)

    def rnd(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    W: dict[str, np.ndarray] = weights or {}

    def get(name, *shape, scale=0.05, ones=False):
        if name in W:
            return np.asarray(W[name], np.float32)
        if ones:
            return np.ones(shape, np.float32)
        return rnd(*shape, scale=scale)

    w = GGUFWriter(path)
    a = cfg.arch
    # the JAX package's LLMConfig (some callers pass one) has no experts
    moe_layers = getattr(cfg, "moe_layer_idx", ())
    w.add_kv("general.architecture", a)
    w.add_kv(f"{a}.block_count", cfg.n_layers)
    w.add_kv(f"{a}.embedding_length", cfg.dim)
    w.add_kv(f"{a}.feed_forward_length", cfg.ff_dim)
    if cfg.layer_types is not None:
        # hybrid: per-layer head counts, 0 = conv layer (llama.cpp LFM2)
        w.add_array(f"{a}.attention.head_count",
                    [cfg.n_heads if t == "attn" else 0 for t in cfg.layer_types])
        w.add_array(f"{a}.attention.head_count_kv",
                    [cfg.n_kv_heads if t == "attn" else 0 for t in cfg.layer_types])
        w.add_kv(f"{a}.shortconv.l_cache", cfg.conv_l_cache)
    else:
        w.add_kv(f"{a}.attention.head_count", cfg.n_heads)
        w.add_kv(f"{a}.attention.head_count_kv", cfg.n_kv_heads)
    w.add_kv(f"{a}.attention.key_length", cfg.head_dim)
    w.add_kv(f"{a}.attention.layer_norm_rms_epsilon", cfg.rms_eps)
    w.add_kv(f"{a}.context_length", cfg.n_ctx)
    w.add_kv(f"{a}.rope.freq_base", cfg.rope_theta)
    if moe_layers:
        w.add_kv(f"{a}.expert_count", cfg.n_experts)
        w.add_kv(f"{a}.expert_used_count", cfg.n_experts_used)
        w.add_kv(f"{a}.expert_feed_forward_length", cfg.expert_ff_dim)
        w.add_kv(f"{a}.leading_dense_block_count", cfg.n_dense_layers)
        w.add_kv(f"{a}.expert_gating_func", 2)
        w.add_kv(f"{a}.expert_weights_norm", cfg.expert_norm)
        w.add_kv(f"{a}.expert_weights_scale", float(cfg.expert_scale))
    w.add_kv("tokenizer.ggml.model", "gpt2")
    w.add_kv("tokenizer.ggml.pre", "qwen2")
    w.add_array("tokenizer.ggml.tokens", tokens)
    w.add_array("tokenizer.ggml.token_type", types)
    w.add_array("tokenizer.ggml.merges", [])
    w.add_kv("tokenizer.ggml.eos_token_id", tokens.index("<|im_end|>"))

    qd = cfg.head_dim * cfg.n_heads
    kvd = cfg.head_dim * cfg.n_kv_heads

    def mat(name, out_d, in_d, qtype=quant_type):
        w.add_tensor(name, get(name, out_d, in_d), qtype)

    def ffn(p, i):
        w.add_tensor(p + "ffn_norm.weight",
                     get(p + "ffn_norm.weight", cfg.dim, ones=True), GGML_F32)
        if i in moe_layers:
            E, F = cfg.n_experts, cfg.expert_ff_dim
            w.add_tensor(p + "ffn_gate_inp.weight",
                         get(p + "ffn_gate_inp.weight", E, cfg.dim), GGML_F32)
            w.add_tensor(p + "exp_probs_b.bias",
                         get(p + "exp_probs_b.bias", E), GGML_F32)
            for nm, shape in (("ffn_gate_exps", (E, F, cfg.dim)),
                              ("ffn_up_exps", (E, F, cfg.dim)),
                              ("ffn_down_exps", (E, cfg.dim, F))):
                w.add_tensor(p + nm + ".weight",
                             get(p + nm + ".weight", *shape), quant_type)
            return
        mat(p + "ffn_gate.weight", cfg.ff_dim, cfg.dim)
        mat(p + "ffn_up.weight", cfg.ff_dim, cfg.dim)
        mat(p + "ffn_down.weight", cfg.dim, cfg.ff_dim,
            qtype=GGML_Q6_K if mixed_k else quant_type)

    # Embeddings stay f32 (gathered, not matmul'ed through qdot).
    w.add_tensor("token_embd.weight", get("token_embd.weight", cfg.n_vocab, cfg.dim,
                                          scale=0.2), GGML_F32)
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight",
                     get(p + "attn_norm.weight", cfg.dim, ones=True), GGML_F32)
        if cfg.layer_types is not None and cfg.layer_types[i] == "conv":
            w.add_tensor(p + "shortconv.conv.weight",
                         get(p + "shortconv.conv.weight", cfg.dim,
                             cfg.conv_l_cache), GGML_F32)
            mat(p + "shortconv.in_proj.weight", 3 * cfg.dim, cfg.dim)
            mat(p + "shortconv.out_proj.weight", cfg.dim, cfg.dim)
            ffn(p, i)
            continue
        mat(p + "attn_q.weight", qd, cfg.dim)
        mat(p + "attn_k.weight", kvd, cfg.dim)
        mat(p + "attn_v.weight", kvd, cfg.dim,
            qtype=GGML_Q6_K if mixed_k else quant_type)
        mat(p + "attn_output.weight", cfg.dim, qd)
        if cfg.qkv_bias:
            w.add_tensor(p + "attn_q.bias", get(p + "attn_q.bias", qd), GGML_F32)
            w.add_tensor(p + "attn_k.bias", get(p + "attn_k.bias", kvd), GGML_F32)
            w.add_tensor(p + "attn_v.bias", get(p + "attn_v.bias", kvd), GGML_F32)
        if cfg.qk_norm:
            w.add_tensor(p + "attn_q_norm.weight",
                         get(p + "attn_q_norm.weight", cfg.head_dim, ones=True), GGML_F32)
            w.add_tensor(p + "attn_k_norm.weight",
                         get(p + "attn_k_norm.weight", cfg.head_dim, ones=True), GGML_F32)
        ffn(p, i)

    w.add_tensor("output_norm.weight",
                 get("output_norm.weight", cfg.dim, ones=True), GGML_F32)
    if not cfg.tie_embedding:
        mat("output.weight", cfg.n_vocab, cfg.dim)
    w.write()
    return cfg

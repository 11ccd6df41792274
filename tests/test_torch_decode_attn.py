"""The port's batched decode attention (K6's plain version, the path CPU
tensors take) against the JAX package's Pallas kernel in interpret mode;
the port's `_attend_bkernel` flash merge against JAX's; and the port's
`_attend` over an int8 cache (the prefill) against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jl
from miotts_tpu.ops.decode_attn import decode_attention_batched as jax_k6
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.ops.decode_attn import decode_attention_batched
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

# (B, H, H_kv, D, S); JAX's int8 tile is S at these sizes (no halving)
SHAPES = [(8, 4, 2, 64, 128), (8, 12, 4, 64, 256), (4, 8, 2, 80, 128)]


def _mk(B, H, H_kv, D, S, seed=0):
    """q and a cache from numpy; staggered fills with an idle row (fill 0)
    and a q_pos below fill."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
    fill = rng.integers(1, S + 1, B).astype(np.int32)
    fill[1] = 0
    q_pos = fill.copy()
    q_pos[2] = fill[2] // 2
    return q, k, v, fill, q_pos


def _quant(k):
    kq, ks = jl._kv_quantize(jnp.asarray(k))
    return np.asarray(kq), np.asarray(ks)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k6_float_matches_jax(shape, stats):
    """f32 cache: rel err <= 1e-5 for the output (or acc, m, l)."""
    q, k, v, fill, q_pos = _mk(*shape)
    want = jax_k6(*(jnp.asarray(a) for a in (q, k, v, fill, q_pos)),
                  b_tile=4, interpret=True, return_stats=stats)
    got = decode_attention_batched(*_t(q, k, v, fill, q_pos),
                                   return_stats=stats)
    if not stats:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel_err(g.numpy(), np.asarray(w)) < 1e-5


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k6_int8_matches_jax(shape, stats):
    """int8 cache at S <= 512 (one quantization tile on both sides): within
    1e-2 of the row scale (a quantized probability may flip one step of 127
    at a .5 boundary where exp differs in the last bit)."""
    q, k, v, fill, q_pos = _mk(*shape, seed=1)
    kq, ks = _quant(k)
    vq, vs = _quant(v)
    want = jax_k6(*(jnp.asarray(a) for a in (q, kq, vq, fill, q_pos, ks, vs)),
                  b_tile=4, interpret=True, return_stats=stats)
    got = decode_attention_batched(*_t(q, kq, vq, fill, q_pos, ks, vs),
                                   return_stats=stats)
    if not stats:
        got, want = (got,), (want,)
    out_g, out_w = got[0].numpy(), np.asarray(want[0])
    row_scale = np.abs(out_w).max(axis=-1, keepdims=True) + 1e-30
    assert np.max(np.abs(out_g - out_w) / row_scale) < 1e-2
    if stats:
        assert rel_err(got[1].numpy(), np.asarray(want[1])) < 1e-6
        assert rel_err(got[2].numpy(), np.asarray(want[2])) < 1e-5


def _serve_inputs(seed=13):
    B, H, H_kv, D, S, W = 8, 8, 2, 80, 128, 12
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    fill = np.asarray([S, 100, 7, 120, 0, 33, 128, 65], np.int32)
    valid = rng.integers(0, 2, (B, W)).astype(bool)
    valid[:, 0] = True
    return dict(q=f(B, 1, H, D), k=f(B, H_kv, S, D), v=f(B, H_kv, S, D),
                k_buf=f(B, H_kv, W, D), v_buf=f(B, H_kv, W, D),
                buf_valid=valid, k_cur=f(B, 1, H_kv, D),
                v_cur=f(B, 1, H_kv, D), fill=fill, q_pos=fill[:, None])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("with_buf", [True, False])
def test_attend_bkernel_matches_jax(quantized, with_buf):
    """The flash merge of K6's (acc, m, l) with the chunk-buffer columns
    (some invalid) and the current-token column, float and int8, against
    JAX's `_attend_bkernel` on its interpret-mode kernel."""
    x = _serve_inputs()
    ks = vs = None
    k, v = x["k"], x["v"]
    if quantized:
        (k, ks), (v, vs) = _quant(k), _quant(v)
    buf = ((x["k_buf"], x["v_buf"], x["buf_valid"]) if with_buf
           else (None, None, None))
    want = jl._attend_bkernel(
        *(None if a is None else jnp.asarray(a)
          for a in (x["q"], k, v, x["fill"], x["q_pos"], ks, vs, x["k_cur"],
                    x["v_cur"], *buf)), interpret=True)
    got = tl._attend_bkernel(*_t(x["q"], k, v, x["fill"], x["q_pos"], ks, vs,
                                 x["k_cur"], x["v_cur"], *buf))
    want = np.asarray(want)
    if quantized:
        row_scale = np.abs(want).max(axis=-1, keepdims=True) + 1e-30
        assert np.max(np.abs(got.numpy() - want) / row_scale) < 1e-2
    else:
        assert rel_err(got.numpy(), want) < 1e-5


def test_attend_int8_prefill_matches_jax():
    """`_attend` over an int8 cache (k_scale / v_scale factored into the
    score and probability matrices), a causal multi-query prefill."""
    B, S_q, H, H_kv, D, S = 2, 8, 4, 2, 16, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S_q, H, D)).astype(np.float32)
    (k, ks), (v, vs) = (_quant(rng.standard_normal((B, H_kv, S, D))
                               .astype(np.float32)) for _ in range(2))
    q_pos = np.broadcast_to(np.arange(S_q), (B, S_q)).astype(np.int32)
    fill = np.asarray([S_q, S_q], np.int32)
    want = jl._attend(*(jnp.asarray(a) for a in (q, k, v, fill, q_pos, ks,
                                                  vs)))
    got = tl._attend(*_t(q, k, v, fill, q_pos, ks, vs))
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5

"""The port's single-query decode attention (K5's plain version, the path
CPU tensors take) against the JAX package's Pallas kernel `decode_attention`
in interpret mode, as tests/test_decode_attn.py runs it, and against JAX's
XLA `_attend` at S_q == 1 with no current-token column (the route the
hybrid decode takes).  f32, bf16 and int8 caches; one and two JAX tiles of
keys (S = 128, 1024); q_pos below fill - 1; a row with fill 0; GQA ratios 1
and 4.  Tolerance 1e-5 of the output scale: both sides compute in f32, and
differ only in summation order and where the softmax is tiled."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jl
from miotts_tpu.ops.decode_attn import decode_attention as jax_k5
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.ops import decode_attn as tda
from torch_port_util import few_torch_threads, rel_err  # noqa: F401

TOL = 1e-5
# (B, H, H_kv, D, S): GQA rep 4 at one and two JAX tiles, MHA (rep 1)
SHAPES = [(3, 8, 2, 64, 128), (2, 8, 2, 64, 1024), (3, 4, 4, 64, 128)]


def _mk(B, H, H_kv, D, S, mode, seed=0):
    """q and a cache from numpy: staggered fills with the last row idle
    (fill 0), one q_pos below fill - 1, the rest at fill - 1 (the hybrid
    decode's q_pos).  bf16 values are rounded once and handed to both
    sides; int8 is the cache write's quantization (JAX's _kv_quantize)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, H_kv, S, D)).astype(np.float32)
    fill = rng.integers(S // 2, S + 1, B).astype(np.int32)
    fill[-1] = 0
    q_pos = fill - 1
    q_pos[0] = fill[0] // 3
    ks = vs = None
    if mode == "int8":
        (k, ks), (v, vs) = (tuple(np.asarray(a) for a in
                                  jl._kv_quantize(jnp.asarray(x)))
                            for x in (k, v))
    elif mode == "bf16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    return q, k, v, fill, q_pos, ks, vs


def _torch(*arrays):
    """numpy (bf16 included) -> torch, bf16 staying bf16."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        elif a.dtype.name == "bfloat16":
            out.append(torch.from_numpy(a.astype(np.float32)).bfloat16())
        else:
            out.append(torch.from_numpy(np.array(a)))
    return out


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_interpret_kernel(shape, mode):
    x = _mk(*shape, mode)
    want = np.asarray(jax_k5(*(None if a is None else jnp.asarray(a)
                               for a in x), interpret=True))
    got = tda.decode_attention(*_torch(*x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) < TOL
    # a row with no valid key returns 0, as the kernel
    assert (got[-1] == 0).all() and np.all(want[-1] == 0)


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
def test_port_attend_route_matches_jax_xla_attend(shape, mode):
    """The port's `_attend` at S_q == 1 without k_cur (K5's route) against
    JAX's default XLA `_attend` on the same call, every row with a valid
    key (the XLA softmax over all-masked scores is uniform, not 0)."""
    q, k, v, fill, q_pos, ks, vs = _mk(*shape, mode, seed=1)
    fill[-1] = q_pos[-1] = 1
    args = (q[:, None], k, v, fill, q_pos[:, None], ks, vs)
    want = np.asarray(jl._attend(*(None if a is None else jnp.asarray(a)
                                   for a in args)))
    got = tl._attend(*_torch(*args))
    assert rel_err(got.numpy(), want) < TOL


def test_plain_reads_a_strided_layer_view():
    """A layer of a stacked [L, B, H_kv, S, D] cache cut to its first S
    keys (what the batched path passes at attn_len): the same result as a
    contiguous copy."""
    q, k, v, fill, q_pos, _, _ = _mk(2, 8, 2, 64, 128, "f32", seed=2)
    rng = np.random.default_rng(3)
    stack = rng.standard_normal((2, 2, 2, 256, 64)).astype(np.float32)
    stack[1, :, :, :128] = k
    kt = torch.from_numpy(stack)[1, :, :, :128]
    assert not kt.is_contiguous()
    qt, vt, ft, pt = _torch(q, v, fill, q_pos)
    got = tda.decode_attention(qt, kt, vt, ft, pt)
    want = tda.decode_attention(qt, torch.from_numpy(k), vt, ft, pt)
    assert rel_err(got.numpy(), want.numpy()) < 1e-6

"""The batched decode-attention CUDA kernel (miotts_tpu_torch/ops/csrc/
decode_attn.cu) against its plain torch version.  Imports nothing of JAX,
so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_attn_cuda.py

The `cuda`-marked tests skip without a GPU; the wrapper's input checks run
everywhere (they raise before any build or launch).

Tolerances, relative to the output scale: f32 1e-5 (summation order);
bf16 1e-2 (p is rounded to bf16 at the tile's running max, which differs
between the tiled kernel and the plain loop only in where it rounds);
int8 1e-2 of the row scale (one step of 127 of a quantized probability may
flip where exp differs in the last bit)."""

import pytest
import torch

from miotts_tpu_torch.models.llm import _kv_quantize
from miotts_tpu_torch.ops import decode_attn as tda

# (B, H, H_kv, D, S): 0.1B serving, 2.6B flagship, 1.7B head dim, LFM2-1.2B
# serving (16 slots, the attn_len buckets)
SHAPES = [(64, 12, 4, 64, 128), (64, 12, 4, 64, 256), (64, 12, 4, 64, 512),
          (64, 32, 8, 80, 256), (64, 32, 8, 80, 512), (128, 32, 8, 80, 256),
          (16, 16, 8, 128, 1024), (16, 32, 8, 64, 128), (16, 32, 8, 64, 256)]
TOL = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2}


def _inputs(B, H, H_kv, D, S, mode, seed=0, s_alloc=None):
    """Random q / cache on the card, staggered fills with a few idle rows
    (fill 0) and a q_pos below fill; with `s_alloc` the cache is the first
    S positions of an [L=2, B, H_kv, s_alloc, D] stack (layer 1), the
    strided view batched serving passes at attn_len."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = "cuda"
    s_alloc = s_alloc or S
    q = torch.randn((B, H, D), generator=g, device=dev)
    k = torch.randn((2, B, H_kv, s_alloc, D), generator=g, device=dev)
    v = torch.randn((2, B, H_kv, s_alloc, D), generator=g, device=dev)
    fill = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    fill[::7] = 0
    q_pos = fill.clone()
    q_pos[3::5] = fill[3::5] // 2
    ks = vs = None
    if mode == "int8":
        k, ks = _kv_quantize(k)
        v, vs = _kv_quantize(v)
        ks, vs = ks[1, :, :, :S], vs[1, :, :, :S]
    elif mode == "bf16":
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    return q, k[1, :, :, :S], v[1, :, :, :S], fill, q_pos, ks, vs


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def test_wrapper_rejects_cpu_tensors():
    q = torch.zeros((2, 4, 64))
    kv = torch.zeros((2, 2, 16, 64))
    with pytest.raises(ValueError, match="GPU"):
        tda._decode_attention_cuda(q, kv, kv, torch.zeros(2, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32), None,
                                   None, False)


@pytest.mark.parametrize("bad", ["head_dim", "rep", "scales"])
def test_wrapper_rejects_bad_shapes(bad):
    D, H = (48, 4) if bad == "head_dim" else (64, 4 if bad != "rep" else 36)
    q = torch.zeros((2, H, D))
    kv = torch.zeros((2, 2, 16, D))
    ks = torch.zeros((2, 2, 16)) if bad == "scales" else None
    with pytest.raises(ValueError):
        tda._decode_attention_cuda(q, kv, kv, torch.zeros(2, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32), ks, ks,
                                   False)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_gpu(shape, mode):
    """Both output forms at the serving shapes; launches are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(*shape, mode)
    for stats in (False, True):
        before = tda.decode_attention_batched.kernel_launches
        got = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                           return_stats=stats)
        torch.cuda.synchronize()
        assert tda.decode_attention_batched.kernel_launches == before + 1
        want = tda.decode_attention_batched_plain(q, k, v, fill, q_pos, ks,
                                                  vs, return_stats=stats)
        if not stats:
            got, want = (got,), (want,)
        else:
            # an idle row returns the empty flash state
            idle = fill == 0
            assert (got[1][idle] == -1e9).all() and (got[2][idle] == 0).all()
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32 and g_.shape == w_.shape
            assert torch.isfinite(g_).all()
        assert _rel(got[0], want[0]) < TOL[mode]
        if stats:
            assert _rel(got[2], want[2]) < TOL[mode]
            live = fill > 0
            assert _rel(got[1][live], want[1][live]) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_kernel_reads_a_strided_attn_len_view(mode):
    """The first 256 positions of a 1024-position layer slice: the kernel
    takes the view's strides (no copy) and matches the plain version on a
    contiguous copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(64, 12, 4, 64, 256, mode,
                                           s_alloc=1024)
    assert not k.is_contiguous()
    got = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs)
    want = tda.decode_attention_batched_plain(
        q, k.contiguous(), v.contiguous(), fill, q_pos,
        None if ks is None else ks.contiguous(),
        None if vs is None else vs.contiguous())
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL[mode]

"""The single-query decode-attention CUDA kernel (miotts_tpu_torch/ops/
csrc/decode_attn_single.cu) against its plain torch version.  Imports
nothing of JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_attn_single_cuda.py

The `cuda`-marked tests skip without a GPU; the wrapper's input checks run
everywhere (they raise before any build or launch).

Tolerance 1e-5 of the output scale in every cache type: kernel and plain
version both compute in f32 from the same inputs, so only the summation
order and `exp` differ."""

import pytest
import torch

from miotts_tpu_torch.models.llm import _kv_quantize
from miotts_tpu_torch.ops import decode_attn as tda

# (label, B, H, H_kv, D, S): the LFM2-1.2B decode (B = 1, 32/8 heads of
# 64) at three cache buckets and with 4 staggered rows, the 0.1B heads
# (12/4), head dims 80 and 128
SHAPES = [("lfm2", 1, 32, 8, 64, 256), ("lfm2", 1, 32, 8, 64, 512),
          ("lfm2", 1, 32, 8, 64, 1024), ("lfm2", 4, 32, 8, 64, 512),
          ("0.1b", 1, 12, 4, 64, 256), ("0.1b", 4, 12, 4, 64, 256),
          ("d80", 2, 32, 8, 80, 512), ("d128", 2, 16, 8, 128, 256)]
TOL = 1e-5


def _inputs(B, H, H_kv, D, S, mode, seed=0, s_alloc=None):
    """Random q / cache on the card.  B = 1: fill 3/4 of S less 2 (~190
    keys at S = 256) and q_pos = fill - 1, the hybrid decode's q_pos.
    B > 1: staggered fills, row 1 idle (fill 0), row 0's q_pos below
    fill - 1.  The cache is layer 1 of an [L=2, B, H_kv, s_alloc, D] stack
    cut to S keys (the strided view the model passes)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = "cuda"
    s_alloc = s_alloc or S
    q = torch.randn((B, H, D), generator=g, device=dev)
    k = torch.randn((2, B, H_kv, s_alloc, D), generator=g, device=dev)
    v = torch.randn((2, B, H_kv, s_alloc, D), generator=g, device=dev)
    if B == 1:
        fill = torch.full((1,), S * 3 // 4 - 2, dtype=torch.int32, device=dev)
        q_pos = fill - 1
    else:
        fill = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        fill[1] = 0
        q_pos = fill - 1
        q_pos[0] = fill[0] // 2
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
        tda._decode_attention_single_cuda(
            q, kv, kv, torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), None, None)


@pytest.mark.parametrize("bad", ["head_dim", "rep", "scales", "int8_alone"])
def test_wrapper_rejects_bad_inputs(bad):
    D, H = (48, 4) if bad == "head_dim" else (64, 4 if bad != "rep" else 36)
    q = torch.zeros((2, H, D))
    kv = torch.zeros((2, 2, 16, D),
                     dtype=torch.int8 if bad == "int8_alone" else torch.float32)
    ks = torch.zeros((2, 2, 16)) if bad == "scales" else None
    with pytest.raises(ValueError):
        tda._decode_attention_single_cuda(
            q, kv, kv, torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), ks, ks)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_gpu(shape, mode):
    """Every phase-(a) shape of chip_smoke.py; launches are counted, an
    idle row returns 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(*shape[1:], mode)
    before = tda.decode_attention.kernel_launches
    got = tda.decode_attention(q, k, v, fill, q_pos, ks, vs)
    torch.cuda.synchronize()
    assert tda.decode_attention.kernel_launches == before + 1
    want = tda.decode_attention_plain(q, k, v, fill, q_pos, ks, vs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert _rel(got, want) < TOL
    assert (got[fill == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_kernel_reads_a_strided_view(mode):
    """The first 256 positions of a 1024-position layer slice: the kernel
    takes the view's strides (no copy) and matches the plain version on a
    contiguous copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(4, 32, 8, 64, 256, mode,
                                           s_alloc=1024)
    assert not k.is_contiguous()
    got = tda.decode_attention(q, k, v, fill, q_pos, ks, vs)
    want = tda.decode_attention_plain(
        q, k.contiguous(), v.contiguous(), fill, q_pos,
        None if ks is None else ks.contiguous(),
        None if vs is None else vs.contiguous())
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL

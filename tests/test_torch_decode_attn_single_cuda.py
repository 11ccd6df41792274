"""The single-query decode-attention CUDA kernel (miotts_tpu_torch/ops/
csrc/decode_attn_single.cu) against its plain torch version.  Imports
nothing of JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_attn_single_cuda.py

The `cuda`-marked tests skip without a GPU; the wrapper's input checks run
everywhere (they raise before any build or launch).

Tolerance 1e-5 of the output scale in every cache type: kernel and plain
version both compute in f32 from the same inputs, so only the summation
order and `exp` differ.  The same holds for the kernel on one rank against
its plan's cluster split (`_single_plan`), and for every cluster size 1-8;
a second call gives the same bits, and a bf16 q the bits of its f32
upcast (the kernel upcasts it exactly)."""

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


@pytest.mark.parametrize("ranks", [0, 9])
def test_wrapper_rejects_a_plan_outside_a_portable_cluster(ranks):
    """1..8 ranks (the portable cluster size); checked before anything
    else, so it raises here on the CPU too."""
    q = torch.zeros((1, 32, 64))
    kv = torch.zeros((1, 8, 256, 64))
    with pytest.raises(ValueError, match="ranks"):
        tda._decode_attention_single_cuda(
            q, kv, kv, torch.full((1,), 190, dtype=torch.int32),
            torch.full((1,), 189, dtype=torch.int32), None, None,
            plan=tda.AttnPlan(ranks=ranks))


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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_one_rank_matches_the_plan_and_repeats_bit_for_bit(shape, mode):
    """The plan's split against one rank (1e-5: f32 sums in another
    order), and a second call of each equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    inp = _inputs(*shape[1:], mode)
    one = tda.AttnPlan(ranks=1)
    got = tda.decode_attention(*inp)
    again = tda.decode_attention(*inp)
    got1 = tda.decode_attention(*inp, plan=one)
    again1 = tda.decode_attention(*inp, plan=one)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got1, again1)
    assert _rel(got, got1) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", range(1, 9))
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_every_cluster_size_matches_plain(mode, ranks):
    """Cluster sizes 1-8 over rows of 0, 3, 9 and 301 valid keys (fewer
    keys than ranks, empty shares, an idle row), 512 keys a row at most."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(4, 32, 8, 64, 512, mode)
    fill.copy_(torch.tensor([301, 0, 3, 9], dtype=torch.int32))
    q_pos.copy_(fill - 1)
    got = tda.decode_attention(q, k, v, fill, q_pos, ks, vs,
                               plan=tda.AttnPlan(ranks=ranks))
    want = tda.decode_attention_plain(q, k, v, fill, q_pos, ks, vs)
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL
    assert (got[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_bf16_q_gives_the_bits_of_its_f32_upcast(mode):
    """The kernel upcasts a bf16 q itself (exactly): the same bits as the
    f32 q the wrapper no longer makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(1, 32, 8, 64, 1024, mode)
    q = q.bfloat16()
    got = tda.decode_attention(q, k, v, fill, q_pos, ks, vs)
    want = tda.decode_attention(q.float(), k, v, fill, q_pos, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

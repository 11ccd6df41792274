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
flip where exp differs in the last bit).  The kernel under its plan's
cluster split against itself on one rank: 1e-5 (the same p, f32 sums in
another order); int8's accumulator and row maxima are the same bits (the
same p_i8, integer sums)."""

import pytest
import torch

from miotts_tpu_torch.models.llm import _kv_quantize
from miotts_tpu_torch.ops import decode_attn as tda

# (B, H, H_kv, D, S): 0.1B serving, 2.6B flagship, 1.7B head dim, LFM2-1.2B
# serving (16 slots, the attn_len buckets, long rows), groups of 5 and 8
# query rows (the kernel's 8-row instantiation)
SHAPES = [(64, 12, 4, 64, 128), (64, 12, 4, 64, 256), (64, 12, 4, 64, 512),
          (64, 32, 8, 80, 256), (64, 32, 8, 80, 512), (128, 32, 8, 80, 256),
          (16, 16, 8, 128, 1024), (16, 32, 8, 64, 128), (16, 32, 8, 64, 256),
          (16, 32, 8, 64, 1024), (16, 32, 8, 64, 2048), (64, 32, 8, 80, 1024),
          (8, 64, 8, 64, 512), (4, 40, 8, 128, 1024)]   # 8 and 5 rows a group
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


def _row_rel(got, want) -> float:
    """Largest difference relative to each output row's own scale."""
    got, want = got.double(), want.double()
    scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())


def _boundary_fills(B, S, ranks):
    """B fills that end exactly on a rank's boundary and one key past one:
    the valid keys n of the row's last tile a multiple of 4 * ranks (every
    rank's share full) or one more, a whole tile and one key into the next;
    and one idle row."""
    ends = set()
    for t0 in range(0, S, tda.S_TILE):
        for n in (4 * ranks, 8 * ranks, tda.S_TILE):
            for extra in (0, 1):
                if 0 < t0 + n + extra <= S:
                    ends.add(t0 + n + extra)
    ends = sorted(ends)
    fill = [ends[i % len(ends)] for i in range(B - 1)] + [0]
    return torch.tensor(fill, dtype=torch.int32, device="cuda")


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


# (B, H, H_kv, D, S) whose float plan splits a tile: 0.1B serving, LFM2 16-slot
# serving at its 256-key bucket and at long rows; RANK_SHAPES adds shapes
# the plan keeps on one rank (forced splits there): the 2.6B at S = 1024,
# LFM2's 128-key bucket
SPLIT_SHAPES = [(64, 12, 4, 64, 256), (64, 12, 4, 64, 512),
                (16, 32, 8, 64, 256), (16, 32, 8, 64, 1024),
                (16, 32, 8, 64, 2048)]
RANK_SHAPES = SPLIT_SHAPES + [(64, 32, 8, 80, 1024), (16, 32, 8, 64, 128)]


def _plan(shape, mode="bf16"):
    B, _, H_kv, _, S = shape
    return tda._attn_plan(B, H_kv, S,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count, mode == "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_rank_boundary_fills_match_plain_on_gpu(shape, mode):
    """Fills that end exactly on a rank's share and one key past it, under
    the float plan's split (more than one rank at these shapes; an int8
    cache's plan keeps S = 256 on one rank, so it is given the split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    plan = _plan(shape)
    assert plan.ranks > 1
    q, k, v, _, _, ks, vs = _inputs(*shape, mode, seed=3)
    fill = _boundary_fills(shape[0], shape[4], plan.ranks)
    q_pos = fill.clone()
    for stats in (False, True):
        got = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                           return_stats=stats, plan=plan)
        want = tda.decode_attention_batched_plain(q, k, v, fill, q_pos, ks,
                                                  vs, return_stats=stats)
        torch.cuda.synchronize()
        g0, w0 = (got[0], want[0]) if stats else (got, want)
        assert torch.isfinite(g0).all()
        if mode == "int8":
            assert _row_rel(g0, w0) < TOL[mode]
        else:
            assert _rel(g0, w0) < TOL[mode]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape", RANK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_split_matches_one_rank_on_gpu(shape, mode):
    """The plan's ranks (and every cluster size 1-8) against one rank on the
    same inputs: output within 1e-5 (of the row scale for int8); int8's acc
    and m the same bits (p_i8 identical, integer rank sums), float m too;
    every split within the mode's tolerance of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(*shape, mode, seed=5)
    one = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                       return_stats=True,
                                       plan=tda.AttnPlan(ranks=1))
    one_out = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                           plan=tda.AttnPlan(ranks=1))
    want = tda.decode_attention_batched_plain(q, k, v, fill, q_pos, ks, vs)
    for ranks in sorted({_plan(shape, mode).ranks, 2, 3, 5, 8}):
        plan = tda.AttnPlan(ranks=ranks)
        acc, m, l = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                                 return_stats=True, plan=plan)
        out = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                           plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(m, one[1])
        if mode == "int8":
            assert torch.equal(acc, one[0])
            assert _row_rel(out, one_out) < 1e-5
            assert _row_rel(out, want) < TOL[mode]
        else:
            assert _rel(acc, one[0]) < 1e-5 and _rel(out, one_out) < 1e-5
            assert _rel(out, want) < TOL[mode]
        assert _rel(l, one[2]) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape", [(64, 12, 4, 64, 256), (16, 32, 8, 64, 2048),
                                   (64, 32, 8, 80, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_second_call_is_bit_identical_on_gpu(shape, mode):
    """No atomics across blocks, sums in a fixed order: two calls give the
    same bits, both output forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(*shape, mode, seed=7)
    for stats in (False, True):
        a = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                         return_stats=stats)
        b = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                         return_stats=stats)
        torch.cuda.synchronize()
        for x, y in zip(a if stats else (a,), b if stats else (b,)):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_split_reads_a_strided_attn_len_view(mode):
    """LFM2 serving's attn_len view (256 of 1024 positions) under the float
    plan's split of more than one rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    plan = _plan((16, 32, 8, 64, 256))
    assert plan.ranks > 1
    q, k, v, fill, q_pos, ks, vs = _inputs(16, 32, 8, 64, 256, mode,
                                           s_alloc=1024)
    assert not k.is_contiguous()
    got = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                       plan=plan)
    want = tda.decode_attention_batched_plain(
        q, k.contiguous(), v.contiguous(), fill, q_pos,
        None if ks is None else ks.contiguous(),
        None if vs is None else vs.contiguous())
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL[mode]


def test_wrapper_rejects_a_bad_plan():
    """A cluster of more than 8 ranks (the portable size) or none raises
    before any build or launch."""
    q = torch.zeros((2, 4, 64))
    kv = torch.zeros((2, 2, 16, 64))
    z = torch.zeros(2, dtype=torch.int32)
    for ranks in (0, 9):
        with pytest.raises(ValueError, match="ranks"):
            tda._decode_attention_cuda(q, kv, kv, z, z, None, None, False,
                                       tda.AttnPlan(ranks=ranks))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_int8_query_quantized_in_kernel_as_plain_on_gpu(q_dtype):
    """The kernel quantizes q itself with quantize_query's bits on a CUDA
    tensor: every row's max score m equals the plain version's bit for bit,
    and the output is within 1e-5 of each row's scale (a bf16 or f32 q)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v, fill, q_pos, ks, vs = _inputs(64, 12, 4, 64, 512, "int8",
                                           seed=11)
    q = q.to(q_dtype)
    acc, m, l = tda.decode_attention_batched(q, k, v, fill, q_pos, ks, vs,
                                             return_stats=True)
    acc_p, m_p, l_p = tda.decode_attention_batched_plain(
        q, k, v, fill, q_pos, ks, vs, return_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(m, m_p)
    out = acc / l.clamp(min=1e-20)[..., None]
    want = acc_p / l_p.clamp(min=1e-20)[..., None]
    assert _row_rel(out, want) < 1e-5

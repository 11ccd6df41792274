"""The kernels at the tensor-parallel shard shapes (K1's row-parallel
linears at P = 2, with K1v and K3 on the bf16 routes, K6 and K5 on a
rank's heads) against their plain versions, their plans at those shapes, and two ranks on one card.  Imports
nothing of JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_cuda.py

The `cuda`-marked tests skip without a GPU; the plans are checked
everywhere.  Tolerances: K1 1e-5 (f32 x) / 1e-2 (bf16 x) of the output
scale, K1v and K3 1e-2 (bf16 x), each kernel's f32 output (out_f32) 1e-5
and rounded its bf16 output bit for bit; K6 1e-2 on a bf16 cache (its bf16 p) and
1e-5 on an f32 one, K5 1e-5; the two ranks' logits 1e-5 of their scale
against one process's, tokens identical."""

from functools import partial

import numpy as np
import pytest
import torch

from miotts_tpu_torch.models.llm import LLMConfig
from miotts_tpu_torch.ops import decode_attn as tda
from miotts_tpu_torch.ops import qmat

# (label, K, N, group, format) of one rank's row-parallel shard at P = 2:
# the 0.1B-Q8_0 and the 2.6B-Q4_K_M (the fused QKV's Q4_K + Q6_K mix is
# g16 with mins)
K1_SHARDS = [("0.1b wqkv", 384, 1280, 32, "q8_0"),
             ("0.1b wo", 384, 768, 32, "q8_0"),
             ("0.1b w_gateup", 384, 4096, 32, "q8_0"),
             ("0.1b w_down", 1024, 768, 32, "q8_0"),
             ("2.6b wqkv", 1280, 3840, 16, "mins"),
             ("2.6b wo", 1280, 2560, 32, "q4_k"),
             ("2.6b w_gateup", 1280, 16384, 32, "q4_k"),
             ("2.6b w_down", 4096, 2560, 16, "q6_k")]
# (B, H, H_kv, D, S): K6 on the 0.1B's and the 2.6B's local heads, K5 on
# LFM2-1.2B's
K6_SHARDS = [(64, 6, 2, 64, 256), (64, 16, 4, 80, 256)]
K5_SHARDS = [(1, 16, 4, 64, 256)]
H100_SMS = 132


@pytest.mark.parametrize("case", K1_SHARDS, ids=lambda c: c[0])
def test_k1_plans_at_shard_shapes(case):
    """The GEMV's and the tile's plans cover K in whole quant groups
    (stages) with 1..8 splits, on the H100's 132 SMs."""
    _, K, N, g, _ = case
    p = qmat._gemv_plan(K, N, g, H100_SMS)
    assert 1 <= p.splits <= qmat.GEMV_MAX_SPLITS and p.k_split % g == 0
    assert (p.splits - 1) * p.k_split < K <= p.splits * p.k_split
    for m in (2, 16, 64):
        t = qmat._tile_plan(m, K, N, g, H100_SMS)
        assert t.k_split % qmat.TILE_BK == 0 and t.splits >= 1
        assert (t.splits - 1) * t.k_split < K <= t.splits * t.k_split


@pytest.mark.parametrize("shape", K6_SHARDS + K5_SHARDS,
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_plans_at_shard_heads(shape):
    B, _, H_kv, _, S = shape
    plan = (tda._single_plan(B, H_kv, S, H100_SMS) if B == 1
            else tda._attn_plan(B, H_kv, S, H100_SMS, False))
    assert 1 <= plan.ranks <= 8


def _qtensor(K, N, g, fmt, gen):
    lo, hi = {"q8_0": (-127, 128), "q6_k": (-32, 32), "mins": (0, 16),
              "q4_k": (0, 16)}[fmt]
    vals = torch.randint(lo, hi, (K, N), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)
    scales = (torch.rand((K // g, N), generator=gen, device="cuda") + 0.5) \
        / (hi * K ** 0.5)
    mins = (None if fmt in ("q8_0", "q6_k") else
            torch.rand((K // g, N), generator=gen, device="cuda") / K ** 0.5)
    qt = qmat.QTensor(values=vals, scales=scales, mins=mins, group=g, n_out=N)
    return qt.pack4() if fmt == "q4_k" else qt


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("case", K1_SHARDS, ids=lambda c: c[0])
def test_k1_at_shard_shapes(case, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _, K, N, g, fmt = case
    gen = torch.Generator(device="cuda")
    gen.manual_seed(K + N)
    qt = _qtensor(K, N, g, fmt, gen)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = torch.randn((m, K), generator=gen, device="cuda").to(dtype)
        before = qmat.qdot.kernel_launches
        got = qmat.qdot(x, qt)
        torch.cuda.synchronize()
        assert qmat.qdot.kernel_launches == before + 1
        assert _rel(got.float(), qmat.qdot_plain(x, qt).float()) < tol
        assert torch.equal(qmat.qdot(x, qt), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("case", K1_SHARDS, ids=lambda c: c[0])
def test_bf16_routes_at_shard_shapes(case, m):
    """K1v (both modes) at M = 1 and 64 and K3 at M = 1, bf16 x: the kernels
    a bf16 engine's row-parallel linears take on those routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _, K, N, g, fmt = case
    gen = torch.Generator(device="cuda")
    gen.manual_seed(K + N + m)
    qt = _qtensor(K, N, g, fmt, gen)
    x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
    runs = [(qmat.qdot_bf16, partial(qmat.qdot_bf16_plain, mode=mode),
             mode) for mode in qmat.BF16_MODES[1:]]
    if m == 1:
        runs.append((qmat.qdot_group, qmat.qdot_group_plain, None))
    for fn, plain, mode in runs:
        call = fn if mode is None else partial(fn, mode=mode)
        counter = fn.kernel_launches
        got = call(x, qt)
        torch.cuda.synchronize()
        assert fn.kernel_launches == counter + 1
        assert _rel(got.float(), plain(x, qt).float()) < 1e-2
        assert torch.equal(call(x, qt), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("case", K1_SHARDS, ids=lambda c: c[0])
def test_out_f32_at_shard_shapes(case, m):
    """Each kernel's f32 output (`out_f32`, a row-parallel shard's partial)
    at bf16 x: K1, K1v (both modes), K2 (packed), K3 and K4 (M = 1).  One
    launch a call; the f32 sum within 1e-5 of the plain version's, and
    rounded to bf16 the kernel's bf16 output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _, K, N, g, fmt = case
    gen = torch.Generator(device="cuda")
    gen.manual_seed(K + N + m + 1)
    qt = _qtensor(K, N, g, fmt, gen)
    x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
    runs = [(qmat.qdot, qmat._qdot_cuda, qmat.qdot_plain, {})]
    runs += [(qmat.qdot_bf16, qmat._qdot_bf16_cuda, qmat.qdot_bf16_plain,
              dict(mode=mode)) for mode in qmat.BF16_MODES[1:]]
    if qt.packed:
        runs.append((qmat.qdot_split, qmat._qdot_split_cuda,
                     qmat.qdot_split_plain, {}))
    if m == 1:
        runs += [(qmat.qdot_group, qmat._qdot_group_cuda,
                  qmat.qdot_group_plain, {}),
                 (qmat.qdot_w8a8, qmat._qdot_w8a8_cuda, qmat.qdot_w8a8_plain,
                  {})]
    for counter, kern, plain, kw in runs:
        name = "packed_launches" if (counter is qmat.qdot_w8a8
                                     and qt.packed) else "kernel_launches"
        before = getattr(counter, name)
        y32 = kern(x, qt, out_f32=True, **kw)
        y = kern(x, qt, **kw)
        torch.cuda.synchronize()
        assert getattr(counter, name) == before + 2
        assert y32.dtype == torch.float32 and y.dtype == torch.bfloat16
        assert _rel(y32, plain(x, qt, out_f32=True, **kw)) < 1e-5
        assert torch.equal(y32.to(torch.bfloat16), y)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("shape", K6_SHARDS, ids=lambda s: "x".join(map(str, s)))
def test_k6_on_local_heads(shape, mode):
    """K6 on a rank's heads: a bf16 cache (the bf16 engine's, 1e-2) and an
    f32 one (the f32 engine's sharded batcher, 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    B, H, H_kv, D, S = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    dt, tol = ((torch.bfloat16, 1e-2) if mode == "bf16"
               else (torch.float32, 1e-5))
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, H_kv, S, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, H_kv, S, D), generator=g, device="cuda").to(dt)
    fill = torch.randint(1, S + 1, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    before = tda.decode_attention_batched.kernel_launches
    got = tda.decode_attention_batched(q, k, v, fill, fill)
    torch.cuda.synchronize()
    assert tda.decode_attention_batched.kernel_launches == before + 1
    assert _rel(got, tda.decode_attention_batched_plain(q, k, v, fill,
                                                        fill)) < tol
    assert torch.equal(tda.decode_attention_batched(q, k, v, fill, fill), got)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("shape", K5_SHARDS, ids=lambda s: "x".join(map(str, s)))
def test_k5_on_local_heads(shape, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    B, H, H_kv, D, S = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, H_kv, S, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, H_kv, S, D), generator=g, device="cuda").to(dt)
    fill = torch.full((B,), S * 3 // 4, dtype=torch.int32, device="cuda")
    before = tda.decode_attention.kernel_launches
    got = tda.decode_attention(q, k, v, fill, fill - 1)
    torch.cuda.synchronize()
    assert tda.decode_attention.kernel_launches == before + 1
    assert _rel(got, tda.decode_attention_plain(q, k, v, fill, fill - 1)) < 1e-5
    assert torch.equal(tda.decode_attention(q, k, v, fill, fill - 1), got)


@pytest.mark.cuda
def test_two_ranks_on_one_card(tmp_path):
    """Two ranks (gloo on one card, NCCL where each has a GPU), mesh
    (1, 2): a Q8_0 model's greedy tokens equal one process's on the card,
    its logits within 1e-5 of their scale; the ring dot within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from miotts_tpu_torch.gguf import GGML_Q8_0
    from miotts_tpu_torch.models.synthetic import write_synthetic_llm
    from miotts_tpu_torch.parallel.launch import launch
    import torch_parallel_workers as W
    path = str(tmp_path / "llm.gguf")
    write_synthetic_llm(path, cfg=LLMConfig(
        arch="qwen2", n_layers=2, dim=256, n_heads=8, n_kv_heads=2,
        head_dim=32, ff_dim=512, n_vocab=256 + 3 + 64, n_ctx=256,
        rope_style="neox", qkv_bias=True, qk_norm=False),
        quant_type=GGML_Q8_0, seed=2)
    toks = np.random.default_rng(0).integers(0, 323, (2, 12))
    params, cfg = W._load(path)
    want = W.prefill_decode(W._to_cuda(params), cfg, toks)
    for res in launch(W.cuda_tp_rank, 2, (path, toks), device="cuda",
                      timeout=300):
        np.testing.assert_array_equal(res["tokens"], want["tokens"])
        err = np.abs(res["logits"] - want["logits"]).max() \
            / np.abs(want["logits"]).max()
        assert err < 1e-5 and res["ring"] < 1e-5

"""The bandwidth-floor probes' CUDA kernels (miotts_tpu_torch/ops/csrc/
dma_floor.cu: K7 `attn_dma_floor`, K8 `qdot_dma_floor`) against their plain
torch versions.  Imports nothing of JAX, so it runs on a GPU machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dma_floor_cuda.py

Every test is `cuda`-marked and skips without a GPU (the wrappers' plan
checks on the CPU are in tests/test_torch_dma_floor.py).

K7 is bit for bit the plain version on every plan (rank 0 sums each
output row's tiles from 0 in t order, as the plain version does, whatever
the split); K8 within 1e-6 of the output scale (f32 sums of the tiles,
and of the splits in rank order, in another order than torch's sum), and
a second call gives the same bits (no workspace, no atomics)."""

import pytest
import torch

from miotts_tpu_torch.ops import decode_attn as tda
from miotts_tpu_torch.ops import qmat as tq

TOL = 1e-6
# chip_smoke.py's phase 18: K7 at phase 10's and phase 6's shapes (label,
# B, H, H_kv, D, S), K8 at bench_qmat.py's 2.6B shapes and the 0.1B /
# LFM2-1.2B Q8_0 linears (K, N)
K7_SHAPES = [
    ("lfm2", 1, 32, 8, 64, 256), ("lfm2", 1, 32, 8, 64, 512),
    ("lfm2", 1, 32, 8, 64, 1024), ("lfm2", 1, 32, 8, 64, 2048),
    ("lfm2", 4, 32, 8, 64, 512), ("0.1b", 1, 12, 4, 64, 256),
    ("d80", 2, 32, 8, 80, 512),
    ("0.1b", 64, 12, 4, 64, 128), ("0.1b", 64, 12, 4, 64, 256),
    ("0.1b", 64, 12, 4, 64, 512), ("2.6b", 64, 32, 8, 80, 256),
    ("2.6b", 64, 32, 8, 80, 512), ("2.6b", 128, 32, 8, 80, 256),
    ("lfm2", 16, 32, 8, 64, 128), ("lfm2", 16, 32, 8, 64, 256),
    ("lfm2", 16, 32, 8, 64, 1024), ("lfm2", 16, 32, 8, 64, 2048),
    ("2.6b", 64, 32, 8, 80, 1024)]
K8_SHAPES = [(2560, 3840), (2560, 2560), (2560, 16384), (8192, 2560),
             (768, 1280), (768, 768), (768, 4096), (2048, 768), (768, 13059),
             (2048, 6144), (2048, 2048), (2048, 3072), (2048, 16384),
             (8192, 2048), (2048, 13059)]


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _kv(B, H_kv, S, D, dtype, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    if dtype == torch.int8:
        return tuple(torch.randint(-127, 128, (B, H_kv, S, D), generator=g,
                                   device="cuda", dtype=torch.int32)
                     .to(torch.int8) for _ in range(2))
    return tuple(torch.randn((B, H_kv, S, D), generator=g, device="cuda")
                 .to(dtype) for _ in range(2))


def _q8(K, N, seed=0):
    """Q8_0's layout: int8 values, g32, f32 scales in [0.01, 0.03)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return tq.QTensor(
        values=torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                             dtype=torch.int32).to(torch.int8),
        scales=torch.rand((K // 32, N), generator=g, device="cuda") * 0.02
        + 0.01, mins=None, group=32, n_out=N)


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp(min=1e-30))


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", K7_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_attn_dma_floor_matches_plain_at_probe_shapes_on_gpu(shape):
    """Every phase-18 shape (bf16 cache) on its plan (`_single_plan`) and
    on one rank: bit for bit the plain version, a second call too."""
    _gpu()
    _, B, _, H_kv, D, S = shape
    k, v = _kv(B, H_kv, S, D, torch.bfloat16, seed=S + B)
    want = tda.dma_floor_plain(k, v)
    got = tda.dma_floor(k, v)
    again = tda.dma_floor(k, v)
    one = tda.dma_floor(k, v, tda.AttnPlan(ranks=1))
    torch.cuda.synchronize()
    assert got.shape == (B, H_kv, 8, D) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    assert torch.equal(one, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=str)
@pytest.mark.parametrize("S,D", [(200, 64), (1100, 80), (1536, 64),
                                 (2048, 80), (8, 64)])
def test_attn_dma_floor_every_cluster_size_on_gpu(S, D, dtype, ranks):
    """Cluster sizes 1-8 on rows that end mid-chunk (S = 200), trailing
    rows left unread (S = 1100: two 512-row tiles, 76 rows past them),
    D = 80 rows of 160 / 320 / 80 bytes, and more ranks than rows (S = 8):
    bit for bit the plain version."""
    _gpu()
    k, v = _kv(2, 3, S, D, dtype, seed=S + ranks)
    got = tda.dma_floor(k, v, tda.AttnPlan(ranks=ranks))
    torch.cuda.synchronize()
    assert torch.equal(got, tda.dma_floor_plain(k, v))


@pytest.mark.cuda
def test_attn_dma_floor_counts_one_launch_a_call_on_gpu():
    _gpu()
    k, v = _kv(1, 8, 256, 64, torch.bfloat16)
    before = tda.dma_floor.kernel_launches
    tda.dma_floor(k, v)
    tda.dma_floor(k, v, tda.AttnPlan(ranks=3))
    assert tda.dma_floor.kernel_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [0, 9])
def test_attn_dma_floor_refuses_a_plan_outside_one_to_eight_on_gpu(ranks):
    _gpu()
    k, v = _kv(1, 8, 256, 64, torch.bfloat16)
    before = tda.dma_floor.kernel_launches
    with pytest.raises(ValueError, match="ranks"):
        tda.dma_floor(k, v, tda.AttnPlan(ranks=ranks))
    assert tda.dma_floor.kernel_launches == before


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("K,N", K8_SHAPES, ids=lambda x: str(x))
def test_qdot_dma_floor_matches_plain_at_probe_shapes_on_gpu(K, N):
    """Every phase-18 shape on its plan (`_gemv_plan`) and on one split:
    within 1e-6 of the plain version; a second call bit for bit."""
    _gpu()
    qt = _q8(K, N, seed=K + N)
    want = tq.qdot_dma_floor_plain(qt)
    got = tq.qdot_dma_floor(qt)
    again = tq.qdot_dma_floor(qt)
    one = tq.qdot_dma_floor(qt, tq.GemvPlan(splits=1, k_split=K))
    torch.cuda.synchronize()
    assert got.shape == (1, N) and got.dtype == torch.float32
    assert _rel(got, want) < TOL and _rel(one, want) < TOL
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("K,N", [(8192, 2560), (4096, 1039), (2048, 13059),
                                 (2560, 784)])
def test_qdot_dma_floor_every_split_count_on_gpu(K, N, splits):
    """Plans of 1-8 splits (whole quant groups, the last split ragged),
    aligned rows (N = 2560; 784 = 24 blocks of 32 columns and a block of
    16) and unaligned ones (N = 1039, 13059: rows read as the 16-byte
    pieces that cover them, the tensor's last piece cut short): within
    1e-6 of plain, a second call bit for bit."""
    _gpu()
    groups = K // 32
    per = -(-groups // splits)
    plan = tq.GemvPlan(splits=-(-groups // per), k_split=per * 32)
    qt = _q8(K, N, seed=splits)
    got = tq.qdot_dma_floor(qt, plan)
    again = tq.qdot_dma_floor(qt, plan)
    torch.cuda.synchronize()
    assert _rel(got, tq.qdot_dma_floor_plain(qt)) < TOL
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_qdot_dma_floor_counts_one_launch_a_call_on_gpu():
    _gpu()
    qt = _q8(2560, 2560)
    before = tq.qdot_dma_floor.kernel_launches
    tq.qdot_dma_floor(qt)
    tq.qdot_dma_floor(qt, tq.GemvPlan(splits=2, k_split=1280))
    assert tq.qdot_dma_floor.kernel_launches == before + 2


@pytest.mark.cuda
def test_qdot_dma_floor_refuses_bad_plans_on_gpu():
    """0 or 9 splits raise before a launch; a split that does not cover K
    exactly is refused by the kernel's checks (a RuntimeError, no launch
    counted)."""
    _gpu()
    qt = _q8(2560, 2560)
    before = tq.qdot_dma_floor.kernel_launches
    for splits in (0, 9):
        with pytest.raises(ValueError, match="splits"):
            tq.qdot_dma_floor(qt, tq.GemvPlan(splits=splits, k_split=320))
    for plan in (tq.GemvPlan(splits=2, k_split=640),     # covers 1280 of K
                 tq.GemvPlan(splits=3, k_split=1280),    # a split past K
                 tq.GemvPlan(splits=2, k_split=1290)):   # not whole groups
        with pytest.raises(RuntimeError):
            tq.qdot_dma_floor(qt, plan)
    assert tq.qdot_dma_floor.kernel_launches == before

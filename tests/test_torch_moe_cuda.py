"""The expert kernels (ops/csrc/moe.cu) against their plain versions on the
card, at LFM2-8B-A1B's widths (dim 2048, 32 experts of 1792, 4 a token)
and a small shape: routing (ids, weights, the routed order, the counters;
ties to the lowest index), the grouped gate/up and down products at M = 1,
64 and a prefill wave of 1000 rows, the combine, experts that no row
chose, and a captured graph replayed twice.  Imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_cuda.py

The `cuda`-marked tests skip without a GPU."""

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf import GGML_Q8_0
from miotts_tpu_torch.ops import moe

# (dim, expert width, experts, top-k)
CELL = (2048, 1792, 32, 4)
SMALL = (256, 128, 8, 2)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _stack(rng, E, N, K, device):
    """A random Q8_0 stack [E, N, K] through the loader's repack: values
    in [-127, 127], scales spreading each weight about 1 / sqrt(K)."""
    raw = np.empty((E, N, K // 32, 34), np.uint8)
    raw[..., 2:] = rng.integers(-127, 128, (E, N, K // 32, 32),
                                dtype=np.int8).view(np.uint8)
    d = (rng.uniform(0.75, 1.25, (E, N, K // 32)) / 73.6
         / np.sqrt(K)).astype(np.float16)
    raw[..., :2] = d.view(np.uint8).reshape(E, N, K // 32, 2)
    return moe.stack_from_raw(raw.reshape(-1), GGML_Q8_0, (E, N, K), device)


def _layer(shape, seed, bias_sigma=0.05):
    D, F, E, k = shape
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return moe.MoeLayer(
        router=t(rng.standard_normal((E, D)) / np.sqrt(D)),
        bias=t(rng.standard_normal(E) * bias_sigma),
        gateup=_stack(rng, E, 2 * F, D, dev), down=_stack(rng, E, D, F, dev),
        top_k=k, scale=1.0, norm=True,
        counters=torch.zeros(2, dtype=torch.int64, device=dev))


def _x(M, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((M, D), generator=g, device="cuda").to(torch.bfloat16)


def _same_routing(a, b):
    for f in ("ids", "offsets", "order", "pos"):
        assert torch.equal(getattr(a, f).long(), getattr(b, f).long()), f
    torch.testing.assert_close(a.wts, b.wts, rtol=2e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SMALL, CELL], ids=["small", "cell"])
@pytest.mark.parametrize("M", [1, 64, 1000])
def test_kernels_match_their_plain_versions(shape, M):
    """Routing exactly (the same top-k on the same logits; weights to
    f32 rounding: sigmoid's exp differs in its last bit); act within one
    bf16 rounding of the plain version (the f32 sums differ in order);
    y from the same act within 1e-5 of its scale; the combine from the
    same y bit for bit (the same IEEE products and sums in j order)."""
    _need_gpu()
    D, F, E, k = shape
    layer = _layer(shape, seed=M)
    x = _x(M, D, seed=M + 1)
    logits = x.float() @ layer.router.T
    counters = torch.zeros(2, dtype=torch.int64, device="cuda")
    rt = moe.moe_route(logits, layer.bias, k, 1.0, True, counters)
    want = moe.moe_route_plain(logits, layer.bias, k, 1.0, True)
    _same_routing(rt, want)
    used = int((torch.bincount(rt.ids.reshape(-1).long(), minlength=E) > 0)
               .sum())
    assert counters.tolist() == [M * k, used]

    act = moe.moe_gateup(x, layer.gateup, rt)
    act_p = moe.moe_gateup_plain(x, layer.gateup, rt)
    scale = act_p.float().abs().max()
    assert (act.float() - act_p.float()).abs().max() <= scale * 2 ** -7
    y = moe.moe_down(act, layer.down, rt)
    y_p = moe.moe_down_plain(act, layer.down, rt)
    assert (y - y_p).abs().max() <= 1e-5 * y_p.abs().max()
    out = moe.moe_combine(y, rt, torch.bfloat16)
    assert torch.equal(out, moe.moe_combine_plain(y, rt, torch.bfloat16))


@pytest.mark.cuda
def test_ties_go_to_the_lowest_index_and_unchosen_experts_are_skipped():
    """Equal scores pick the lowest experts; a bias of +5 on experts 3 and
    7 sends every row there (the other experts get no row, their blocks
    return at once); the output still equals the plain version's."""
    _need_gpu()
    D, F, E, k = SMALL
    layer = _layer(SMALL, seed=5)
    M = 64
    logits = torch.zeros((M, E), device="cuda")
    rt = moe.moe_route(logits, torch.zeros(E, device="cuda"), k, 1.0, True)
    assert rt.ids.tolist() == [[0, 1]] * M
    layer.bias = torch.zeros(E, device="cuda")
    layer.bias[3] = layer.bias[7] = 5.0
    x = _x(M, D, seed=9)
    out = moe.moe_ffn(x, layer)
    assert layer.counters.tolist() == [M * k, 2]
    logits = x.float() @ layer.router.T
    rt_p = moe.moe_route_plain(logits, layer.bias, k, 1.0, True)
    assert set(rt_p.ids.reshape(-1).tolist()) == {3, 7}
    want = moe.moe_combine_plain(
        moe.moe_down_plain(moe.moe_gateup_plain(x, layer.gateup, rt_p),
                           layer.down, rt_p), rt_p, torch.bfloat16)
    assert (out.float() - want.float()).abs().max() <= (
        2 ** -6 * want.float().abs().max())


@pytest.mark.cuda
def test_a_captured_graph_replays_the_same_bits():
    """moe_ffn at the cell's widths and M = 64 captured in a CUDA graph:
    two replays on the same input give the same bits as the eager call,
    and each adds its pairs and experts to the counters."""
    _need_gpu()
    D, F, E, k = CELL
    layer = _layer(CELL, seed=21)
    x = _x(64, D, seed=22)
    eager = moe.moe_ffn(x, layer)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe.moe_ffn(x, layer)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    launches = moe.moe_gateup.kernel_launches
    with torch.cuda.graph(graph):
        out = moe.moe_ffn(x, layer)
    assert moe.moe_gateup.kernel_launches == launches + 1
    layer.counters.zero_()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, out) and torch.equal(first, eager)
    pairs, reads = layer.counters.tolist()
    assert pairs == 2 * 64 * k and 0 < reads <= 2 * E

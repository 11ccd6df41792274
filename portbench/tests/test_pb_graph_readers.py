"""The readers of the batcher's CUDA graph counters on made-up windows:
graph_step_share and qdot_all_roofline, and None from a program without
the counters."""

import pytest

from portbench import flops
from portbench.harness import LayerContext
from portbench.metrics import graph_step_share, qdot_all_roofline, qdot_roofline
from portbench.trace import TraceView

H100 = flops.peak("NVIDIA H100 80GB HBM3")
WB = 3686400                       # a 2560 x 2560 weight's bytes


def _ctx(stage, qdot_calls, device):
    view = TraceView(window_s=1.0)
    view.device = device
    view.launches = view.runtime = []
    return LayerContext(shape=None, n_slots=64, chunk_steps=20, peak=H100,
                        trace=view, stage=stage, chunks=[], prefills=[],
                        qdot_calls=qdot_calls, audio_s=0.0)


GRAPHED = {"device_steps": 40, "graph_steps": 40,
           "graph_qdot_flops": 2 * 64 * 2560 * 2560 * 40,
           "graph_qdot_bytes": (WB + 2 * 64 * 5120) * 40}
KERNELS = [("void qtile::qdot_tile_kernel<64>", 0, 30_000, 1),
           ("void qtile::qdot_tile_kernel<1024>", 40_000, 50_000, 2),
           ("void decode_attn_kernel<bf16>", 60_000, 61_000, 3)]


def test_qdot_all_roofline_counts_eager_and_replayed_linears():
    """The eager call's least time plus that of the replays' summed work,
    over both qdot kernels' 40 us."""
    prefill = (1024, 2560, 2560, WB)
    ctx = _ctx(GRAPHED, [prefill], KERNELS)
    least = (flops.least_time(*flops.linear(*prefill), H100)
             + flops.least_time(GRAPHED["graph_qdot_flops"],
                                GRAPHED["graph_qdot_bytes"], H100))
    assert qdot_all_roofline.read(ctx) == pytest.approx(100 * least / 40e-6)
    # the accepted reader sees the eager call alone
    assert qdot_roofline.read(ctx) == pytest.approx(
        100 * flops.least_time(*flops.linear(*prefill), H100) / 40e-6)
    assert graph_step_share.read(ctx) == 100.0


def test_without_replays_it_is_qdot_roofline():
    stage = {"device_steps": 40, "graph_steps": 0, "graph_qdot_flops": 0,
             "graph_qdot_bytes": 0}
    ctx = _ctx(stage, [(64, 2560, 2560, WB)] * 3, KERNELS)
    assert qdot_all_roofline.read(ctx) == pytest.approx(
        qdot_roofline.read(ctx))
    assert graph_step_share.read(ctx) == 0.0


@pytest.mark.parametrize("stage", [{"device_steps": 40}, {}],
                         ids=["parent", "empty"])
def test_a_program_without_the_counters_gives_none(stage):
    ctx = _ctx(stage, [(64, 2560, 2560, WB)], KERNELS)
    assert qdot_all_roofline.read(ctx) is None
    assert graph_step_share.read(ctx) is None


def test_no_qdot_kernel_or_an_unknown_weight_gives_none():
    assert qdot_all_roofline.read(_ctx(GRAPHED, [], KERNELS[2:])) is None
    assert qdot_all_roofline.read(
        _ctx(GRAPHED, [(1024, 2560, 2560, None)], KERNELS)) is None

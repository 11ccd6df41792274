"""Where the w8a8 route's GPU and CPU paths part (PyTorch/CUDA port).

    python3 scripts/torch_w8a8_flips.py

Needs one CUDA GPU.  Writes a 2-layer model of the 2.6B-Q4_K_M widths (the
port's writer, seed 0, llama.cpp's Q4_K_M mix), runs a 45-token prefill and
one decode step under MIOTTS_QDOT_GEMV=w8a8 on the card (the K4 kernels)
and on the CPU (their plain versions), and prints, for every K4 call of the
step: how far its input differs between the two, how many of the input's
int8 quantization steps differ (rounding-tie flips), and how far its output
differs.  First it holds each K4 kernel against the CPU plain version on
one identical input, where the two agree to summation order.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from miotts_tpu_torch.gguf import GGML_Q4_K, GGUFReader  # noqa: E402
from miotts_tpu_torch.models.llm import (LLMConfig, init_kv_cache,  # noqa: E402
                                         llm_decode_step, llm_prefill,
                                         load_llm_params)
from miotts_tpu_torch.models.synthetic import write_synthetic_llm  # noqa: E402
from miotts_tpu_torch.ops import qmat  # noqa: E402


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def rms(a, b) -> float:
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_w8a8_flips: CUDA is not available", file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)
    for k, n, packed in ((2560, 3840, False), (2560, 2560, True)):
        vals = torch.randint(0, 16, (k, n), generator=gen, dtype=torch.int32)
        group = 32 if packed else 16
        qt = qmat.QTensor(values=vals.to(torch.int8),
                          scales=torch.rand(k // group, n, generator=gen) / 100,
                          mins=torch.rand(k // group, n, generator=gen) / 100,
                          group=group, n_out=n)
        qt = qt.pack4() if packed else qt
        x = torch.randn(1, k, generator=gen)
        got = qmat.qdot_w8a8(x.cuda(), qt.to("cuda")).cpu()
        print(f"same input, {'packed' if packed else 'int8'} {k}x{n}: kernel "
              f"vs CPU plain rel err {rel(got, qmat.qdot_w8a8_plain(x, qt)):.2e}")

    seen = {"cuda": [], "cpu": []}
    plain_entry = qmat.qdot_w8a8

    def recording(x, w):
        y = plain_entry(x, w)
        seen[x.device.type].append((x.cpu(), y.cpu(), w.group, w.shape))
        return y
    recording.kernel_launches = recording.packed_launches = 0
    qmat.qdot_w8a8 = recording

    cfg = LLMConfig(arch="qwen2", n_layers=2, dim=2560, n_heads=32,
                    n_kv_heads=8, head_dim=80, ff_dim=8192,
                    n_vocab=256 + 3 + 12800, n_ctx=2048, rope_theta=1e6,
                    rope_style="neox", qkv_bias=True)
    toks = torch.zeros((1, 64), dtype=torch.int64)
    toks[0, :45] = (torch.arange(45) * 37 + 11) % cfg.n_vocab
    route = qmat.QdotRoute(gemv="w8a8")
    logits = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "q4km2.gguf")
        write_synthetic_llm(path, cfg=cfg, quant_type=GGML_Q4_K, seed=0,
                            mixed_k=True)
        with GGUFReader(path) as r:
            for dev in ("cuda", "cpu"):
                params, _ = load_llm_params(r, cfg, dtype=torch.float32,
                                            device=dev)
                params = qmat.with_route(params, route)
                cache = init_kv_cache(cfg, 1, 128, dtype=torch.float32,
                                      device=dev)
                last, cache = llm_prefill(params, toks.to(dev),
                                          torch.tensor([45]), cache, cfg)
                step, _ = llm_decode_step(params, torch.tensor([1234],
                                                               device=dev),
                                          cache, cfg)
                logits[dev] = (last.cpu(), step.cpu())
    print(f"logits, card vs CPU: prefill (K1) rel err "
          f"{rel(logits['cuda'][0], logits['cpu'][0]):.2e}, decode step "
          f"(K4) {rel(logits['cuda'][1], logits['cpu'][1]):.2e}")
    for i, (g, c) in enumerate(zip(seen["cuda"], seen["cpu"])):
        xq_g, _ = qmat.quantize_groups(g[0], g[2])
        xq_c, _ = qmat.quantize_groups(c[0], c[2])
        print(f"K4 call {i} (layer {i // 4 if i < 8 else 'head'}, N x K = "
              f"{g[3][0]} x {g[3][1]}): input rel diff {rel(g[0], c[0]):.2e}, "
              f"flipped int8 steps {int((xq_g != xq_c).sum())} of "
              f"{xq_g.numel()}, output rel diff {rel(g[1], c[1]):.2e} "
              f"(RMS {rms(g[1], c[1]):.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

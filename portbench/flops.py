"""The yardstick's peaks and the operations and bytes of the work the
benchmark asks for, computed from shapes the benchmark made.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity), which
assume the card's full 700 W.  A kernel's least time is the larger of its
operations over the bf16 tensor-core peak and its bytes over the HBM
bandwidth, each input byte read once and each output byte written once.
Quantized weights count at their GGUF size (the format the benchmark drew,
not the program's repacked layout).
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}
ACT_BYTES = 2          # bf16 activations


def peak(kind: str) -> dict | None:
    return PEAKS.get(kind)


def least_time(flops: float, nbytes: float, pk: dict) -> float:
    return max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"])


def linear(M: int, K: int, N: int, weight_bytes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of y [M, N] = x [M, K] @ W^T, x and y in bf16."""
    return 2 * M * K * N, weight_bytes + ACT_BYTES * M * (K + N)


def attention_step(keys: list, n_heads: int, n_kv_heads: int,
                   head_dim: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one batched single-query attention over the cache:
    keys[b] cached positions for slot b; q read in bf16, k and v in bf16,
    the flash state (acc [H, D], m and l [H]) written in f32."""
    B, total = len(keys), sum(keys)
    flops = 4 * n_heads * head_dim * total
    nbytes = (2 * ACT_BYTES * n_kv_heads * head_dim * total
              + ACT_BYTES * B * n_heads * head_dim
              + 4 * B * n_heads * (head_dim + 2))
    return flops, nbytes


def attention_params(s) -> int:
    """A GQA block's q, k, v and output projections."""
    D, hd = s.dim, s.head_dim
    return D * (s.n_heads * hd + 2 * s.n_kv_heads * hd) + s.n_heads * hd * D


def matmul_params(s) -> int:
    """Parameters a token meets in matrix products: every linear and the
    output head (tied or not), as its architecture counts them; the
    embedding gather is none."""
    return s.impl.matmul_params(s)


def token_flops(s, position: int) -> int:
    """Model FLOPs of one token at `position` (0-based): 2 x matmul
    parameters, attention over position + 1 keys in each attention layer
    (scores and values), and the architecture's other work (the conv
    taps of each conv layer)."""
    return (2 * matmul_params(s)
            + 4 * s.n_heads * s.head_dim * (position + 1) * len(s.attn_layers)
            + s.impl.extra_token_flops(s))


def span_flops(s, start: int, count: int) -> int:
    """token_flops summed over positions start .. start + count - 1."""
    if count <= 0:
        return 0
    pos_sum = count * start + count * (count + 1) // 2
    return ((2 * matmul_params(s) + s.impl.extra_token_flops(s)) * count
            + 4 * s.n_heads * s.head_dim * len(s.attn_layers) * pos_sum)

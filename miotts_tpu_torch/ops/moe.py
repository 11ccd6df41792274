"""The sparse-expert feed-forward of an lfm2moe model: sigmoid routing over
E experts with a selection bias, top-k, normalised weights, and a SwiGLU
expert per choice over Q8_0 expert stacks.

It has no counterpart in the JAX package: no TPU kernel computes it.  For
the normed input h [M, D] of an expert layer (HF's
Lfm2MoeSparseMoeBlock, llama.cpp's build_moe_ffn with sigmoid gating):

  r = h W_g^T in f32 (the router [E, D], f32; plain torch, as the tied head)
  s = sigmoid(r); the chosen experts are the top k of s + b (the bias only
      selects; ties go to the lowest expert index), in that order
  w_j = s_j / max(sum_j s_j, 2^-14) * scale   (the sum in choice order;
      llama.cpp's clamp to the least normal f16, where HF adds 1e-6: the
      sum of k sigmoids is far above either, so they agree to f32 rounding)
  out = sum_j w_j down_j(silu(gate_j h) * up_j h), in bf16 (x's dtype)

Four steps, each a CUDA kernel (ops/csrc/moe.cu) on a CUDA tensor and its
plain torch version on a CPU tensor, each with a launch counter:

  moe_route    top-k, weights, and each expert's pairs p = row * k + j in
               p order (`order`, from `offsets[e]`; `pos[p]` a pair's
               place there); adds the pairs and the experts chosen to the
               layer's int64 `counters` [2]
  moe_gateup   act[q] = bf16(silu(g) * u) of the pair at place q, g and u
               the f32 products of its row with the fused gate/up stack
  moe_down     y[q] = the f32 product of act[q] with the down stack
  moe_combine  out[row] = bf16(sum_j w[row, j] * y[pos[row, j]]), j in order

Every shape is fixed by M, so the four launches sit in a CUDA graph, and
nothing waits on the host.  An expert no row chose is never read.

Expert stacks (`ExpertStack`) hold Q8_0 as the kernels read it: int8
values [E, N, K] with each 64 of K in the mma fragment order FRAG_K, and
the blocks' f16 scales [E, K/32, N] (34 bytes a block of 32, the GGUF's
own).  `stack_from_raw` repacks a GGUF tensor in one vectorised pass on
the device.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.reader import GGML_Q8_0, ggml_type_name

# held[..., c * 64 + q] = w[..., c * 64 + FRAG_K[q]]: lane t of an mma quad
# reads bytes 16 t .. 16 t + 15 of a 64-deep chunk, word s of them the
# k = 16 s + {2t, 2t + 1, 2t + 8, 2t + 9} of its B fragments (ops/csrc/moe.cu)
FRAG_K = [16 * s + 2 * t + (i & 1) + 8 * (i >> 1)
          for t in range(4) for s in range(4) for i in range(4)]
_UNFRAG_K = [FRAG_K.index(k) for k in range(64)]
NORM_FLOOR = 6.103515625e-5          # 2^-14, the least normal f16
# rows a block of the grouped kernels takes: 16 at M <= 64 (decode), else 64
DECODE_ROWS = 64


@dataclass
class ExpertStack:
    """E Q8_0 matrices [N, K] (the GGUF Linear layout) as the kernels read
    them: values int8 [E, N, K], each 64 of K in FRAG_K order; scales f16
    [E, K/32, N]."""
    values: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.values.shape)

    def dequant(self, e: int) -> torch.Tensor:
        """Expert e's weight, f32 [N, K]."""
        _, n, k = self.shape
        v = self.values[e].reshape(n, k // 64, 64)[
            ..., torch.tensor(_UNFRAG_K, device=self.values.device)]
        s = self.scales[e].T.float().repeat_interleave(32, dim=1)
        return v.reshape(n, k).float() * s


@dataclass
class MoeLayer:
    """An expert layer's weights: router f32 [E, D], selection bias f32
    [E], the fused gate/up stack [E, 2F, D] (gate rows first), the down
    stack [E, D, F]; `counters` int64 [2] (pairs computed, experts read),
    one tensor shared by every expert layer of a model."""
    router: torch.Tensor
    bias: torch.Tensor
    gateup: ExpertStack
    down: ExpertStack
    top_k: int
    scale: float
    norm: bool
    counters: torch.Tensor


def check_stack(ggml_type: int, shape: tuple) -> None:
    """Raise ValueError for an expert tensor the kernels cannot take: a
    format other than Q8_0, or a K that is not a multiple of 64."""
    if ggml_type != GGML_Q8_0:
        raise ValueError(f"expert stacks are Q8_0 only, got "
                         f"{ggml_type_name(ggml_type)}")
    if len(shape) != 3 or shape[2] % 64:
        raise ValueError(f"an expert stack is [E, N, K] with K a multiple "
                         f"of 64, got {tuple(shape)}")


def stack_from_raw(raw: np.ndarray, ggml_type: int, shape: tuple,
                   device) -> ExpertStack:
    """A GGUF expert tensor (numpy shape [E, N, K]) -> ExpertStack on
    `device`: the bytes copied once, the blocks' scales and values split
    and the values put in FRAG_K order on the device (check_stack's
    limits)."""
    check_stack(ggml_type, shape)
    E, N, K = shape
    with warnings.catch_warnings():
        # the mmap'd payload is read-only; it is only copied from
        warnings.simplefilter("ignore", UserWarning)
        blocks = torch.from_numpy(raw).to(device, copy=True).view(
            E, N, K // 32, 34)
    scales = blocks[..., :2].contiguous().view(torch.float16)[..., 0]
    vals = blocks[..., 2:].reshape(E, N, K // 64, 64)[
        ..., torch.tensor(FRAG_K, device=blocks.device)]
    return ExpertStack(values=vals.reshape(E, N, K).view(torch.int8),
                       scales=scales.transpose(1, 2).contiguous())


def concat_stacks(a: ExpertStack, b: ExpertStack) -> ExpertStack:
    """a's rows, then b's, in each expert (the gate/up fusion)."""
    return ExpertStack(values=torch.cat([a.values, b.values], dim=1),
                       scales=torch.cat([a.scales, b.scales], dim=2))


@dataclass
class Routing:
    """moe_route's outputs: ids / wts [M, k] (int32 / f32), offsets [E + 1],
    order and pos [M k] (int32)."""
    ids: torch.Tensor
    wts: torch.Tensor
    offsets: torch.Tensor
    order: torch.Tensor
    pos: torch.Tensor

    @property
    def rows(self) -> int:
        return self.ids.shape[0]


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def moe_route_plain(logits: torch.Tensor, bias: torch.Tensor, top_k: int,
                    scale: float, norm: bool,
                    counters: torch.Tensor | None = None) -> Routing:
    """The routing of logits [M, E] (f32), as moe_route_kernel."""
    M, E = logits.shape
    s = torch.sigmoid(logits.float())
    ids = torch.sort(s + bias.float(), dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    sw = s.gather(1, ids)
    total = sw[:, 0]
    for j in range(1, top_k):
        total = total + sw[:, j]
    if norm:
        sw = sw / total.clamp(min=NORM_FLOOR)[:, None]
    wts = sw * scale
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    counts = torch.bincount(flat, minlength=E)
    offsets = torch.zeros(E + 1, dtype=torch.int64, device=logits.device)
    offsets[1:] = torch.cumsum(counts, 0)
    if counters is not None:
        counters += torch.stack([counters.new_tensor(flat.numel()),
                                 (counts > 0).sum().to(counters.dtype)])
    i32 = torch.int32
    return Routing(ids=ids.to(i32), wts=wts, offsets=offsets.to(i32),
                   order=order.to(i32), pos=pos.to(i32))


def _expert_rows(rt: Routing):
    """(expert, places [a, b)) of each expert with rows (host loop: the
    plain versions only)."""
    off = rt.offsets.tolist()
    return [(e, off[e], off[e + 1]) for e in range(len(off) - 1)
            if off[e + 1] > off[e]]


def moe_gateup_plain(x: torch.Tensor, stack: ExpertStack,
                     rt: Routing) -> torch.Tensor:
    """act [M k, F] in x's dtype: silu(g) * u of each pair in routed order,
    g and u the f32 products of its row with its expert's gate and up."""
    F_ = stack.shape[1] // 2
    k = rt.ids.shape[1]
    act = torch.zeros((rt.order.numel(), F_), dtype=x.dtype, device=x.device)
    for e, a, b in _expert_rows(rt):
        rows = x[rt.order[a:b].long() // k].float()
        gu = rows @ stack.dequant(e).T
        act[a:b] = (F.silu(gu[:, :F_]) * gu[:, F_:]).to(x.dtype)
    return act


def moe_down_plain(act: torch.Tensor, stack: ExpertStack,
                   rt: Routing) -> torch.Tensor:
    """y [M k, D] f32: each pair's act times its expert's down."""
    y = torch.zeros((act.shape[0], stack.shape[1]), dtype=torch.float32,
                    device=act.device)
    for e, a, b in _expert_rows(rt):
        y[a:b] = act[a:b].float() @ stack.dequant(e).T
    return y


def moe_combine_plain(y: torch.Tensor, rt: Routing,
                      dtype) -> torch.Tensor:
    """out [M, D] in `dtype`: sum_j w[row, j] y[pos[row, j]], j in order."""
    M, k = rt.ids.shape
    pos = rt.pos.long().reshape(M, k)
    out = torch.zeros((M, y.shape[1]), dtype=torch.float32, device=y.device)
    for j in range(k):
        out = out + rt.wts[:, j:j + 1] * y[pos[:, j]]
    return out.to(dtype)


# ---------------------------------------------------------------------------
# The kernels' wrappers: CUDA tensors launch (or raise), CPU tensors take
# the plain versions
# ---------------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, fn: str) -> None:
    if err:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def _lib():
    from ._build import load_kernels
    return load_kernels()["moe"]


def _mt(M: int) -> int:
    """m16 tiles of rows a grouped block takes."""
    return 1 if M <= DECODE_ROWS else 4


def moe_route(logits: torch.Tensor, bias: torch.Tensor, top_k: int,
              scale: float, norm: bool,
              counters: torch.Tensor | None = None) -> Routing:
    """The routing of logits [M, E] f32 (see the module docstring)."""
    if not logits.is_cuda:
        return moe_route_plain(logits, bias, top_k, scale, norm, counters)
    M, E = logits.shape
    dev, i32 = logits.device, torch.int32
    if counters is None:
        counters = torch.zeros(2, dtype=torch.int64, device=dev)
    if logits.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("moe_route takes f32 logits and bias")
    rt = Routing(ids=torch.empty((M, top_k), dtype=i32, device=dev),
                 wts=torch.empty((M, top_k), dtype=torch.float32, device=dev),
                 offsets=torch.empty(E + 1, dtype=i32, device=dev),
                 order=torch.empty(M * top_k, dtype=i32, device=dev),
                 pos=torch.empty(M * top_k, dtype=i32, device=dev))
    _raise_on(_lib().moe_route_launch(
        logits.contiguous().data_ptr(), bias.contiguous().data_ptr(), M, E,
        top_k, float(scale), int(norm), rt.ids.data_ptr(), rt.wts.data_ptr(),
        rt.offsets.data_ptr(), rt.order.data_ptr(), rt.pos.data_ptr(),
        counters.data_ptr(), _stream(logits)), "moe_route_launch")
    moe_route.kernel_launches += 1
    return rt


def _checked(x: torch.Tensor, stack: ExpertStack, k: int, name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 activations, got {x.dtype}")
    if stack.values.dtype != torch.int8 or stack.scales.dtype != torch.float16:
        raise ValueError(f"{name} takes a Q8_0 ExpertStack")
    if x.shape[-1] != k or not x.is_contiguous():
        raise ValueError(f"{name}: x {tuple(x.shape)} against K {k}")


def moe_gateup(x: torch.Tensor, stack: ExpertStack,
               rt: Routing) -> torch.Tensor:
    """act [M k, F]: the routed pairs' silu(gate) * up (moe_gateup_plain)."""
    if not x.is_cuda:
        return moe_gateup_plain(x, stack, rt)
    E, N, K = stack.shape
    _checked(x, stack, K, "moe_gateup")
    M, k = rt.ids.shape
    act = torch.empty((M * k, N // 2), dtype=torch.bfloat16, device=x.device)
    _raise_on(_lib().moe_gateup_launch(
        x.data_ptr(), stack.values.data_ptr(), stack.scales.data_ptr(),
        rt.offsets.data_ptr(), rt.order.data_ptr(), act.data_ptr(), M, K,
        N // 2, E, k, _mt(M), _stream(x)), "moe_gateup_launch")
    moe_gateup.kernel_launches += 1
    return act


def moe_down(act: torch.Tensor, stack: ExpertStack,
             rt: Routing) -> torch.Tensor:
    """y [M k, D] f32: the routed pairs' down products (moe_down_plain)."""
    if not act.is_cuda:
        return moe_down_plain(act, stack, rt)
    E, N, K = stack.shape
    _checked(act, stack, K, "moe_down")
    M = rt.rows
    y = torch.empty((act.shape[0], N), dtype=torch.float32, device=act.device)
    _raise_on(_lib().moe_down_launch(
        act.data_ptr(), stack.values.data_ptr(), stack.scales.data_ptr(),
        rt.offsets.data_ptr(), y.data_ptr(), M, K, N, E, _mt(M),
        _stream(act)), "moe_down_launch")
    moe_down.kernel_launches += 1
    return y


def moe_combine(y: torch.Tensor, rt: Routing, dtype) -> torch.Tensor:
    """out [M, D]: each row's weighted sum of its pairs (moe_combine_plain)."""
    if not y.is_cuda:
        return moe_combine_plain(y, rt, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"moe_combine writes bf16, asked for {dtype}")
    M, k = rt.ids.shape
    N = y.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=y.device)
    _raise_on(_lib().moe_combine_launch(
        y.data_ptr(), rt.wts.data_ptr(), rt.pos.data_ptr(), out.data_ptr(),
        M, N, k, _stream(y)), "moe_combine_launch")
    moe_combine.kernel_launches += 1
    return out


def moe_ffn(h: torch.Tensor, layer: MoeLayer) -> torch.Tensor:
    """The expert layer's output [..., D] in h's dtype for the normed input
    h [..., D]: the router's f32 product, then the four steps."""
    lead, D = h.shape[:-1], h.shape[-1]
    x = h.reshape(-1, D).contiguous()
    logits = x.float() @ layer.router.T
    rt = moe_route(logits, layer.bias, layer.top_k, layer.scale, layer.norm,
                   layer.counters)
    act = moe_gateup(x, layer.gateup, rt)
    y = moe_down(act, layer.down, rt)
    return moe_combine(y, rt, x.dtype).reshape(*lead, D)


moe_route.kernel_launches = 0
moe_gateup.kernel_launches = 0
moe_down.kernel_launches = 0
moe_combine.kernel_launches = 0

"""Collectives over a mesh axis's process group, and the ring collective
matmuls (counterpart of `miotts_tpu/ops/collective.py`).

The primitives the sharded modules use:

  psum        all-reduce, sum (the row-parallel linears, GroupNorm's
              statistics)
  all_gather  the shards of every rank concatenated along a dim, in rank
              order (column-parallel outputs, the data axis's readback)
  ppermute    a ring shift by +-1 (the ring dots, the codec's halos)

Under NCCL they are the native calls.  Under gloo a CUDA tensor travels
through pinned host memory for what gloo cannot take on CUDA: send / recv
(the ring shift); its all-reduce and all-gather take CUDA tensors
(`scripts/torch_gloo_cuda_check.py` on the H100's torch 2.11).  The
transport is the group's backend's, decided when the group was made, never
a recovery from a failed call.

`ModelAxis` (a mesh axis as this rank sees it) and `Shard` (this rank's
slice of a weight and its kind) are the records the collectives are called
with: plain dataclasses, here so that a kernel module (ops/qmat.py) and the
models can read them without importing the mesh layer.

`ring_reduce_scatter_dot` / `ring_allreduce_dot` keep the JAX package's
schedule: the output is split into one chunk per rank, and at step s rank d
computes chunk j = (d + P - 1 - s) % P of its partial product while the
travelling accumulator's previous hop is in flight (`async_op` handles).
The products are plain f32 `torch.matmul`s, as the JAX package's are plain
`jnp.dot`s outside any Pallas kernel.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


# the layout records the sharded modules read (parallel/sharding.py makes
# them; models/llm.py and models/codec_sp.py read them)
@dataclass(frozen=True)
class ModelAxis:
    """The mesh's 'model' axis as this rank sees it."""
    group: Any          # torch.distributed ProcessGroup
    rank: int
    size: int


@dataclass(frozen=True)
class Shard:
    """This rank's slice of a weight cut over the model axis.

    kind "row": the contraction (input) dim is cut, `local` is [N, K / P]
    (logical); the product of this rank's K range is summed over the axis.
    kind "col": the output dim is cut, `local` is [N / P, K] (a bias:
    [N / P]); the outputs are gathered over the axis and the first `n_out`
    columns kept (a QTensor's 128-lane padding, carried over from the JAX
    package, is cut after the gather)."""
    local: Any          # QTensor or torch.Tensor
    kind: str
    axis: ModelAxis
    n_out: int


# what the collectives did: calls by transport (`host_staged`: a gloo
# group's CUDA tensor through pinned host memory, the ring shift's) and the
# host seconds spent in them (a blocking call waits for its inputs and the
# transfer; an NCCL call only enqueues).  Reset by the caller.
transport = {"host_staged": 0, "native": 0, "seconds": 0.0}


def _gloo_cuda(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (waits for it)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group's ranks (a new tensor, x unchanged)."""
    t0 = time.perf_counter()
    y = x.contiguous().clone()
    transport["native"] += 1
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    transport["seconds"] += time.perf_counter() - t0
    return y


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in group-rank order."""
    t0 = time.perf_counter()
    P = dist.get_world_size(group)
    xc = x.contiguous()
    transport["native"] += 1
    if dist.get_backend(group) == "nccl":
        buf = xc.new_empty((P,) + tuple(xc.shape))
        dist.all_gather_into_tensor(buf, xc, group=group)
        parts = list(buf.unbind(0))
    else:
        parts = [torch.empty_like(xc) for _ in range(P)]
        dist.all_gather(parts, xc, group=group)
    out = torch.cat(parts, dim=dim)
    transport["seconds"] += time.perf_counter() - t0
    return out


class _Hop:
    """An in-flight ring shift: wait() returns the received tensor."""

    def __init__(self, works, recv, device):
        self._works, self._recv, self._device = works, recv, device

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        out = self._recv.to(self._device)
        transport["seconds"] += time.perf_counter() - t0
        return out


def ppermute_start(x: torch.Tensor, shift: int, group) -> _Hop:
    """Start a ring shift: group rank r sends x to r + shift and receives
    from r - shift (mod P), through `dist.batch_isend_irecv`."""
    P = dist.get_world_size(group)
    r = dist.get_rank(group)
    xc = x.contiguous()
    if P == 1:
        return _Hop([], xc.clone(), x.device)
    t0 = time.perf_counter()
    staged = _gloo_cuda(xc, group)
    transport["host_staged" if staged else "native"] += 1
    send = _host(xc) if staged else xc
    recv = torch.empty_like(send)
    dst = dist.get_global_rank(group, (r + shift) % P)
    src = dist.get_global_rank(group, (r - shift) % P)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group)])
    transport["seconds"] += time.perf_counter() - t0
    return _Hop(works, recv, x.device)


def ppermute(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """x of group rank r - shift (mod P) (a ring shift by `shift`)."""
    return ppermute_start(x, shift, group).wait()


def ring_reduce_scatter_dot(x: torch.Tensor, w_local: torch.Tensor,
                            group) -> torch.Tensor:
    """Row-parallel matmul with a ring reduce-scatter.

    x [M, K_local] (this rank's slice of the contraction dim); w_local
    [K_local, N], N divisible by the group size P.  Returns this rank's
    fully reduced chunk [M, N // P] in f32 (rank d owns columns
    [d * N / P, (d + 1) * N / P)).  Chunk j visits ranks j + 1, j + 2, ...,
    j (mod P), collecting every rank's partial; each step starts the
    accumulator's hop, computes the next partial, then adds the arrival."""
    P = dist.get_world_size(group)
    d = dist.get_rank(group)
    N = w_local.shape[1]
    if N % P:
        raise ValueError(f"N={N} does not divide the axis size {P}")
    Nc = N // P
    xf = x.float()
    acc = None
    for s in range(P):
        j = (d + P - 1 - s) % P
        hop = ppermute_start(acc, 1, group) if s > 0 else None
        part = torch.matmul(xf, w_local[:, j * Nc:(j + 1) * Nc].float())
        acc = part if hop is None else hop.wait() + part
    return acc


def ring_allreduce_dot(x: torch.Tensor, w_local: torch.Tensor,
                       group) -> torch.Tensor:
    """Row-parallel matmul with an overlapped all-reduce: the ring
    reduce-scatter, then an all-gather of the chunks.  Equal to
    psum(x @ w_local) up to the order of the f32 sums; f32 [M, N]."""
    return all_gather(ring_reduce_scatter_dot(x, w_local, group), -1, group)

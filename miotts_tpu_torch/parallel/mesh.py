"""Process groups and the ('data', 'model') device mesh on
torch.distributed (counterpart of `miotts_tpu/parallel/mesh.py`).

One process per rank.  `data` multiplexes utterances (batch rows and
serving slots), `model` tensor-shards the LLM's weights and KV heads
(parallel/sharding.py) and the codec's sequence (models/codec_sp.py).

Each rank's device and the process group's backend are chosen up front,
from the host's GPU count and the world size, and logged; neither choice
is ever made because something failed:

  device   `cuda:local_rank` when the host has a GPU for every rank,
           `cuda:0` for every rank on a one-card host (local_rank modulo
           the card count in general), `cpu` when asked
  backend  NCCL when every rank has a GPU of its own; gloo otherwise (on
           the CPU, and for several ranks on one card: NCCL refuses two
           ranks of one communicator on one GPU)

Under gloo the collectives of `ops/collective.py` move a CUDA tensor
through pinned host memory for what gloo cannot take on CUDA (send / recv).
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

AXES = ("data", "model")


def log(msg: str) -> None:
    print(f"miotts: {msg}", file=sys.stderr, flush=True)


def pick_device(local_rank: int, device: str = "cuda") -> torch.device:
    """This rank's device: `cuda:local_rank % cards` (cuda:0 for every
    rank on a one-card host), or the CPU when `device` is "cpu"."""
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", local_rank % n)


def pick_backend(world_size: int, device: str = "cuda") -> str:
    """NCCL when every one of `world_size` ranks has a GPU of its own,
    gloo otherwise (the CPU, or several ranks on one card)."""
    if device != "cpu" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     init_method: str | None = None,
                     device: str = "cuda") -> str | None:
    """`dist.init_process_group` for this process (a no-op for a single
    process without an `init_method`, as the JAX package's).

    coordinator: "host:port" of rank 0's TCP store (`tcp://` is added), or
    `init_method` any torch init URL (`file://...`, `tcp://...`).  The
    backend defaults to `pick_backend(num_processes, device)`.  Returns the
    backend, or None when nothing was initialised."""
    n = num_processes or 1
    if n <= 1 and init_method is None:
        return None
    rank = process_id or 0
    backend = backend or pick_backend(n, device)
    if init_method is None:
        if coordinator is None:
            raise ValueError("init_distributed needs a coordinator or an "
                             "init_method")
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank)
    dev = ("cpu" if device == "cpu"
           else f"cuda:{torch.cuda.current_device()}")
    log(f"rank {rank}/{n}: backend {backend} ({init_method.split(':')[0]}), "
        f"device {dev}")
    return backend


def make_mesh(data: int | None = None, model: int | None = None,
              device_type: str | None = None):
    """A ('data', 'model') DeviceMesh over every rank of the process group.

    Defaults as the JAX package's: every rank on 'model' (tensor
    parallelism for one big model), or the split asked for; `data * model`
    must equal the world size.  `device_type` defaults to "cuda" under
    NCCL and "cpu" under gloo (the mesh only names the groups: a gloo
    group's CUDA tensors travel through host memory)."""
    n = dist.get_world_size()
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The size of a named mesh axis (`DeviceMesh.size` takes an index)."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]



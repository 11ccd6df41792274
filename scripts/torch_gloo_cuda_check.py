"""Which gloo collectives take CUDA tensors on this torch build: two ranks
on cuda:0 over gloo (the transport parallel/mesh.py picks for several ranks
on one card) try each call on a CUDA tensor and report what it did.  Also
runs an NCCL all-reduce at world size 1 in this process.

    python3 scripts/torch_gloo_cuda_check.py

Prints one JSON line: {"torch": ..., "card": ..., "gloo_cuda": {op: "ok" |
error}, "nccl_world1": "ok" | error}.  A probe: it reports errors instead
of raising them.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "batch_isend_irecv")


def _probe(rank: int, world: int, op: str) -> str:
    """One collective on a CUDA tensor: "ok" when it ran and gave the
    right values, "wrong values", or the error it raised."""
    import torch
    import torch.distributed as dist
    x = torch.full((4,), float(rank + 1), device="cuda")
    ranks = torch.arange(1, world + 1, dtype=torch.float32,
                         device="cuda").repeat_interleave(4)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y, torch.full_like(x, float(ranks[::4].sum()))

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y, torch.ones_like(x)

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts), ranks

    def all_gather_into_tensor():
        y = torch.empty((world * 4,), device="cuda")
        dist.all_gather_into_tensor(y, x)
        return y, ranks

    def batch_isend_irecv():
        y = torch.empty_like(x)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % world),
                dist.P2POp(dist.irecv, y, (rank - 1) % world)]):
            w.wait()
        return y, torch.full_like(x, float((rank - 1) % world + 1))

    try:
        got, want = locals()[op]()
        torch.cuda.synchronize()
        return "ok" if torch.equal(got, want) else "wrong values"
    except Exception as e:              # noqa: BLE001 - reported
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def main() -> int:
    import torch
    import torch.distributed as dist
    from miotts_tpu_torch.parallel.launch import launch
    res = {"torch": torch.__version__, "card": torch.cuda.get_device_name(0),
           "cards": torch.cuda.device_count()}
    res["gloo_cuda"] = {}
    for op in OPS:      # a launch each: a refused call may break its group
        try:
            res["gloo_cuda"][op] = launch(_probe, 2, (op,), device="cuda",
                                          backend="gloo", timeout=60)[0]
        except Exception as e:          # noqa: BLE001 - reported
            res["gloo_cuda"][op] = f"{type(e).__name__}: " \
                f"{str(e).strip().splitlines()[-1][:160]}"
    try:
        with tempfile.TemporaryDirectory() as d:
            dist.init_process_group("nccl", store=dist.FileStore(
                os.path.join(d, "s"), 1), rank=0, world_size=1)
            y = torch.ones(4, device="cuda")
            dist.all_reduce(y)
            torch.cuda.synchronize()
            dist.destroy_process_group()
        res["nccl_world1"] = "ok"
    except Exception as e:              # noqa: BLE001 - reported
        res["nccl_world1"] = f"{type(e).__name__}: {e}"
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run a function on N ranks of one host: one spawned process per rank,
each in its own process group, its result sent back to the caller.

The processes start with the `spawn` method (never a fork: a CUDA context
does not survive one) and OMP_NUM_THREADS=1.  The group starts from a
`file://` store in a fresh temporary directory, so concurrent launches
never race for a port.  A rank that raises fails the launch, and so does a
launch that outlives its timeout: every rank is then killed, and the
caller gets the error, never a partial result.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback


def _worker(fn, rank: int, world: int, init_method: str, device: str,
            backend: str | None, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import init_distributed, pick_device
    torch.set_num_threads(1)
    try:
        if device != "cpu":
            torch.cuda.set_device(pick_device(rank, device))
        init_distributed(num_processes=world, process_id=rank,
                         init_method=init_method, backend=backend,
                         device=device)
        out = fn(rank, world, *args)
        dist.barrier()
        results.put((rank, "ok", out))
    except BaseException:                       # noqa: BLE001 - reported
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world: int, args: tuple = (), device: str = "cpu",
           backend: str | None = None, timeout: float = 300.0) -> list:
    """fn(rank, world, *args) on `world` spawned ranks after
    init_distributed (backend: parallel/mesh.pick_backend's unless given;
    device "cpu" or "cuda"); returns the ranks' results in rank order.
    Raises RuntimeError with the rank's traceback when one raises, and
    TimeoutError when the launch passes `timeout` seconds; either way every
    rank is killed first."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="miotts_ranks_") as d:
        init = "file://" + os.path.join(d, "store")
        old = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            procs = [ctx.Process(target=_worker, daemon=True,
                                 args=(fn, r, world, init, device, backend,
                                       args, results))
                     for r in range(world)]
            for p in procs:
                p.start()
        finally:
            if old is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = old
        out: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} "
                                       f"did not finish in {timeout} s")
                try:
                    rank, status, val = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})")
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
                out[rank] = val
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    return [out[r] for r in range(world)]

"""Process-group start-up and cross-process helpers.

Counterpart of ``mvuld_tpu/parallel/distributed.py``. The JAX package
starts one process per host from ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``; the port starts one process per
rank from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``):

  torchrun --nproc-per-node N -m mvuld_tpu_torch.train.<trainer> ...

Without that environment every helper answers for a one-process world, so
each entry point can call them unconditionally.

``run_local_world`` starts such a world itself, on one host: ``world``
spawned processes on a free ``localhost`` port, each calling ``fn(rank,
world, *args)`` inside an initialised group, with a timeout on the group
and on the join so that a hung rank fails the call instead of blocking it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from mvuld_tpu_torch.parallel.collectives import barrier

TIMEOUT_S = 300


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(device="cpu",
                                 backend: Optional[str] = None) -> bool:
    """Initialise the default process group from torchrun's environment
    (``backend``: by default ``backend_for(device)``; a CUDA device becomes
    ``cuda:LOCAL_RANK``). Returns True if this call or an earlier one
    initialised it, False when the environment names no world."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return False
    backend = backend or backend_for(device)
    card = None
    if backend == "nccl":
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(card)
    dist.init_process_group(
        backend, init_method="env://",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ.get("RANK", "0")),
        timeout=datetime.timedelta(seconds=TIMEOUT_S), device_id=card)
    return True


def local_device(device):
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA device in a
    torchrun world whose backend is NCCL, else ``device`` as given."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and dist.is_initialized()
            and dist.get_backend() == dist.Backend.NCCL):
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def shard_manifest(items, rank: Optional[int] = None,
                   world: Optional[int] = None):
    """This rank's share of a host manifest (the DistributedSampler
    equivalent): rank i reads items[i::world]."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    return items[rank::world]


def free_port() -> int:
    """A TCP port on localhost that was free when asked (bound to port 0
    and read back)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, backend: str, timeout: float,
            fn: Callable, args: Sequence, results) -> None:
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
            barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:                  # reported to the parent, re-raised
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_local_world(fn: Callable, world: int, *args: Any,
                    backend: str = "gloo", timeout: float = TIMEOUT_S
                    ) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one ``backend`` group; returns the ranks' results in rank order.
    ``fn`` and ``args`` must pickle (a module-level function). Raises with
    the first failing rank's traceback, or when a rank has not finished
    within ``timeout`` seconds (then every rank is killed)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, backend,
                                               timeout, fn, args, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        deadline = time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_local_world: {world - len(out)} of "
                                   f"{world} ranks unfinished after "
                                   f"{timeout:.0f} s")
            try:
                rank, status, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"run_local_world: a rank exited with "
                                       f"{dead[0]} before reporting")
                continue
            if status != "ok":
                raise RuntimeError(f"run_local_world: rank {rank}:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [out[r] for r in range(world)]

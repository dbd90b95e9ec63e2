"""Multi-process bootstrap on ``torch.distributed``, and the launcher of k
ranks on one host.

Counterpart of :mod:`covo_mpc_tpu.parallel.distributed`. The port runs one
process per rank and one device per process (JAX runs one process per
host, driving every chip of it). :func:`initialize_distributed` keeps
JAX's launcher contract: ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID``, each read from the environment unless given. With one
process it is a no-op that returns 0; otherwise it calls
``dist.init_process_group`` with ``init_method="tcp://<address>"`` (an
address that is already a URL, such as ``file:///tmp/x``, is taken as it
is), the world size and the rank, and returns the rank. The backend is an
explicit argument: ``"nccl"`` for ranks that each hold a card of their
own, ``"gloo"`` on the CPU and for ranks that share one card (NCCL
refuses two ranks on one device).

:func:`run_ranks` starts k such processes on this host (the
multiprocessing ``forkserver`` method: one clean server process imports
the port once, and each rank is forked from it), each with the contract in its
environment, runs ``fn(rank, *args)`` in each after the group is up, and
returns their results in rank order; a rank that raises, or a launch that
outlives its timeout, raises in the caller after every process is
stopped. The CPU tests, ``chip_smoke.py``'s two ranks on one card and
``scripts/bench_mesh.py``'s widths above one rank launch through it.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import socket
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# what a rank imports before it runs: the port, and what torch.func's first
# use imports (seconds a process)
PRELOAD = ("covo_mpc_tpu_torch.parallel", "torch._dynamo", "torch.distributed.fsdp")


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> int:
    """``dist.init_process_group`` from the launcher contract (JAX:
    ``jax.distributed.initialize``); returns this process's rank. A no-op
    returning 0 when the job has one process. A group already up with the
    same world size is kept (its rank returned); another size raises."""
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return 0
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up, "
                               f"asked for {num_processes}")
        return dist.get_rank()
    if backend not in BACKENDS:
        raise ValueError(f"initialize_distributed: backend must be one of {BACKENDS} "
                         f"(nccl for a card a rank, gloo on the CPU or for ranks that "
                         f"share a card), got {backend!r}")
    if not address:
        raise ValueError("initialize_distributed: no COORDINATOR_ADDRESS")
    dist.init_process_group(backend, init_method=_init_method(address),
                            world_size=num_processes, rank=process_id)
    return process_id


def device_topology(device=None) -> dict:
    """Summary of the job's ranks and this rank's device for logs (JAX's
    keys): one device a process, so ``global_devices`` is the process
    count; ``backend`` is the group's (None without one)."""
    up = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if up else 1
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": count,
        "global_devices": count,
        "local_devices": 1,
        "device_kind": kind,
        "backend": dist.get_backend() if up else None,
    }


# --- k ranks on this host ---------------------------------------------------------


def free_port() -> int:
    """A TCP port the OS has just handed out on localhost (taken just before
    a launch, so parallel launches do not collide)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, address: str, backend: str, fn: Callable,
               args: tuple, results) -> None:
    os.environ.update({"COORDINATOR_ADDRESS": address, "NUM_PROCESSES": str(world),
                       "PROCESS_ID": str(rank)})
    try:
        torch.set_num_threads(1)
        initialize_distributed(backend=backend)
        # plain pickle: the tensors go by value, not as handles to this
        # process's memory (which end with it)
        out = pickle.dumps(fn(rank, *args))
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              timeout_s: float = 300.0, address: Optional[str] = None) -> list:
    """``fn(rank, *args)`` in ``world`` new processes, each a rank of one
    process group (``backend``), through the launcher contract; returns
    the ranks' results in rank order. ``fn`` and its arguments and results
    must pickle (``fn`` a module-level function). The rendezvous is a file
    in a fresh temporary directory unless ``address`` is given. Raises,
    after every process has stopped, if a rank raised (with its
    traceback), exited without a result, or the launch outlived
    ``timeout_s``."""
    ctx = multiprocessing.get_context("forkserver")
    # the server imports these once; each rank is forked from it (not from
    # the caller, whose threads a fork would not carry)
    ctx.set_forkserver_preload(list(PRELOAD))
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="covo_ranks_") as tmp:
        address = address or f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, address, backend, fn, args, results),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout_s
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {world - len(got)} of {world} ranks "
                                       f"gave no result within {timeout_s:.0f} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(f"run_ranks: a rank exited with {dead[0]} "
                                           "without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} of {world} failed:\n{out}")
                got[rank] = pickle.loads(out)
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]

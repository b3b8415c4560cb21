"""Process-group set-up for multi-process training (the JAX package's
``parallel/multihost.py``).

``initialize()`` joins the process group when its coordinates are known:
explicit arguments first, then the environment torchrun sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``).  With none of them it does nothing and returns False,
so one process on one device needs no set-up.  NCCL serves ranks on CUDA
devices (one card a rank), gloo ranks on the CPU; a group that fails to
form raises.  ``is_primary()`` says which process writes checkpoints,
exports and validation rows.

``spawn`` starts ranks of one machine as processes (the CPU tests, the
dry run and ``chip_smoke.py`` use it) and joins every one of them.
"""

import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from .. import resolve_device


def initialize(init_method=None, world_size=None, rank=None, local_rank=None,
               device="cuda", backend=None):
    """Join the process group; returns True once one is initialized (also
    when it already was), False when no coordinates are given.

    init_method: ``tcp://host:port`` (else MASTER_ADDR / MASTER_PORT);
    world_size, rank, local_rank: else WORLD_SIZE, RANK, LOCAL_RANK
    (local_rank defaults to 0).  device: the rank's device; a CUDA device
    without an index becomes ``cuda:<local_rank>``, which is made the
    current device.  backend: NCCL for a CUDA device, gloo for the CPU
    unless given (gloo also serves CUDA tensors, and two ranks that share
    one card need it: NCCL refuses duplicate GPUs)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if init_method is None and world_size is None and rank is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError(
            "multihost.initialize: incomplete coordinates (init_method="
            f"{init_method!r}, world_size={world_size!r}, rank={rank!r})")
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return True


def rank_device(device="cuda", local_rank=None):
    """This rank's device: ``device`` with a CUDA index filled in from
    ``local_rank`` (else LOCAL_RANK, else 0); raises where CUDA is asked
    for and absent."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", int(local_rank))
    return dev


def world():
    """(rank, world size), (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier():
    """Wait for every rank (nothing to wait for without a process
    group)."""
    if dist.is_initialized():
        dist.barrier()


def is_primary():
    """True on the process that writes checkpoints, exports and CSVs."""
    return world()[0] == 0


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, init_method, device, backend, args,
               errors):
    try:
        initialize(init_method, world_size, rank, local_rank=rank,
                   device=device, backend=backend)
        try:
            fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise


def spawn(fn, world_size, args=(), device="cuda", backend=None,
          timeout=600):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (the spawn start method), each in a process group on localhost over a
    free port, with ``device`` as every rank's device (``cuda`` puts rank
    i on ``cuda:i``, ``cuda:0`` every rank on one card, with gloo;
    ``cpu`` runs the ranks on the CPU).  Raises before starting any
    process where CUDA is asked for and absent.  ``fn`` must be
    importable by name.  Waits for every process; raises if any failed
    (the others, which may wait in a collective for it, are then
    terminated) or if they outlive ``timeout`` seconds."""
    resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    errors = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, init_method, device, backend, args, errors))
        for r in range(world_size)]
    reports = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            try:
                reports.append(errors.get(timeout=0.2))
            except queue.Empty:
                pass
            if any(p.exitcode for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawned ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
    while True:
        try:
            reports.append(errors.get(timeout=0.2))
        except queue.Empty:
            break
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if failed:
        raise RuntimeError(f"spawned ranks failed (rank, exit code): "
                           f"{failed}\n" + "\n".join(
                               "rank %d:\n%s" % r for r in reports))

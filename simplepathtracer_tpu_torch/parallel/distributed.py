"""Multi-process orchestration on ``torch.distributed`` (counterpart of the
JAX package's ``parallel/distributed.py``): starting the process group,
meshes that keep the samples axis within a node, and the pixel rows a
process owns.

Every process runs the same program (``torchrun --nproc_per_node=N``, one
process per GPU; or ``spawn_local`` on one host).  The render and gradient
code in ``sharding.py`` is already multi-process-safe: inputs are
replicated, outputs are split by tiles, and all randomness is keyed by
global (pixel, sample) ids, so the process count cannot change the image.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from .sharding import make_mesh, mesh_coords, mesh_shape

# The environment a launcher (torchrun) sets for every process.
_LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize_cluster(init_method: str | None = None, world_size: int | None = None,
                       rank: int | None = None, backend: str | None = None) -> None:
    """Start this process's ``torch.distributed`` process group.

    Does nothing if a group exists, or if neither the arguments nor the
    environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``, as torchrun
    sets them) configure a job: a single process without a launcher stays
    local.  ``init_method`` defaults to ``env://``.  ``backend`` is the
    caller's; without one, ``nccl`` where CUDA is available and ``gloo``
    on the CPU.  Nothing switches it: NCCL refuses two ranks on one
    device, so a job that shares a card between ranks names ``gloo``.
    Where CUDA is available the process's current device becomes
    ``LOCAL_RANK`` (else its rank) modulo the visible devices: one process
    per device.
    """
    if dist.is_initialized():
        return
    configured = (init_method is not None or world_size is not None or rank is not None
                  or any(k in os.environ for k in _LAUNCHER_ENV))
    if not configured:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK", rank if rank is not None
                               else os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend=backend, init_method=init_method or "env://", **kw)


def make_multihost_mesh(samples_per_host: int = 1, device_type=None) -> DeviceMesh:
    """('tiles', 'samples') mesh over every process of the job, the samples
    axis within a node: a launcher numbers a node's processes
    consecutively (``LOCAL_WORLD_SIZE`` of them), and the mesh's samples
    groups are runs of ``samples_per_host`` consecutive ranks, so the
    per-step all-reduce over ``samples`` stays on the node and tiles span
    nodes (combined only when the image is gathered)."""
    n = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if samples_per_host < 1 or n % samples_per_host or local % samples_per_host:
        raise ValueError(
            f"samples_per_host={samples_per_host} must divide the {n} processes and the "
            f"{local} of a node"
        )
    return make_mesh(tiles=n // samples_per_host, samples=samples_per_host,
                     device_type=device_type)


def local_tile_slice(mesh: DeviceMesh, num_pixels: int):
    """(start, size) of the pixel rows this process's tile owns -- what it
    writes when saving a sharded render."""
    nt = mesh_shape(mesh)["tiles"]
    p_local = num_pixels // nt
    coords = [mesh_coords(mesh)[0]]
    # One device per process: its tile coordinates are one run.  Kept as
    # the JAX package's check that a process saves a contiguous slice.
    if coords != list(range(min(coords), max(coords) + 1)):
        raise RuntimeError(f"non-contiguous tile coordinates for this process: {coords}")
    return min(coords) * p_local, (max(coords) - min(coords) + 1) * p_local


def _run_rank(rank, fn, world_size, init_method, backend, args):
    initialize_cluster(init_method=init_method, world_size=world_size, rank=rank,
                       backend=backend)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn, world_size: int, args=(), *, init_method: str, backend: str = "gloo",
                timeout: float = 120.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    on this host, each with its process group started (``init_method``,
    ``backend``), and wait for all of them at most ``timeout`` seconds.

    Raises when a process fails (the others are stopped) or when the time
    runs out (every process is killed): a collective whose peer died blocks
    forever, so no job is waited for without a limit.  ``fn`` must be
    importable by name in a new process (a module-level function)."""
    ctx = mp.start_processes(_run_rank, args=(fn, world_size, init_method, backend, args),
                             nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size}-process job did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)

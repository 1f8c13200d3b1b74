"""Process-group bootstrap, the one-host launcher and the per-rank batch
(counterpart of ``streetunveiler_tpu/parallel/multihost.py``).

One rank is one process with one device: NCCL on ``cuda`` (never two
ranks on one card), gloo on ``cpu``. Under torchrun (or any launcher that
sets ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``) ``bootstrap``
reads the environment; ``launch_local`` starts the ranks of a one-host
mesh itself. There is no global array in torch: each rank holds its own
cameras and its own slab of the ground truth (``make_global_batch``).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def bootstrap(device="cuda", init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None):
    """``torch.distributed.init_process_group`` on this rank's device:
    NCCL on ``cuda``, gloo on ``cpu``. Without arguments the rank, the
    world size and the rendezvous come from the environment torchrun sets.
    Returns (rank, world_size, device); a no-op when the group exists.
    On ``cuda`` the rank takes local card ``LOCAL_RANK`` (its rank when
    unset) and raises when the host has fewer cards."""
    dev = resolve_device(device)
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(
                f"rank {rank} needs local card {local}, but this host has "
                f"{n}: NCCL never puts two ranks on one card")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if init_method is None and "MASTER_ADDR" not in os.environ:
            raise RuntimeError(
                "no rendezvous: pass init_method (tcp://host:port or "
                "file://path) or run under torchrun")
        kw = dict(backend="nccl" if dev.type == "cuda" else "gloo",
                  rank=rank, world_size=world_size)
        if init_method is not None:
            kw["init_method"] = init_method
        dist.init_process_group(**kw)
    return dist.get_rank(), dist.get_world_size(), dev


def _rank_main(rank, fn, world_size, device, init_method, args, threads):
    """A spawned rank: join the group, run ``fn(*args)``, leave. Gloo
    ranks share the launching process's threads."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    if device == "cpu":
        torch.set_num_threads(threads)
    bootstrap(device, init_method=init_method, rank=rank,
              world_size=world_size)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch_local(fn, world_size: int, device="cuda", args=()):
    """Run ``fn(*args)`` on ``world_size`` ranks of this host, one process
    each (spawned; ``fn`` must be importable by name), NCCL on one card
    per rank or gloo on the CPU, and wait for all of them. Raises when
    the host has fewer cards than ranks, and when any rank fails."""
    import torch.multiprocessing as mp
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        n = torch.cuda.device_count()
        if world_size > n:
            raise RuntimeError(
                f"the mesh needs {world_size} GPUs and this host has {n}; "
                f"NCCL never puts two ranks on one card (use --device cpu "
                f"for a gloo run on the CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_main, nprocs=world_size, join=True,
                           start_method="spawn",
                           args=(fn, world_size, dev.type, init_method,
                                 tuple(args), max(1, torch.get_num_threads()
                                                  // world_size)))


def local_camera_indices(n_cameras: int, rank: int | None = None,
                         world_size: int | None = None) -> list[int]:
    """The camera indices this rank is responsible for loading: an even,
    contiguous split over the ranks."""
    p = dist.get_rank() if rank is None else rank
    n = max(dist.get_world_size() if world_size is None else world_size, 1)
    per = -(-n_cameras // n)
    return list(range(p * per, min((p + 1) * per, n_cameras)))


def data_slice(mesh, batch: int) -> slice:
    """The cameras of a global batch that this rank's ``data`` row takes
    (``batch`` a multiple of the mesh's ``data`` size)."""
    n_data = mesh.size(0)
    if batch % n_data:
        raise ValueError(f"batch {batch} is not a multiple of data "
                         f"{n_data}")
    per = batch // n_data
    d = mesh.get_local_rank("data")
    return slice(d * per, (d + 1) * per)


def make_global_batch(mesh, w2c_local, k_local, gt_local, sem_local=None,
                      device=None):
    """This rank's share of the batch on its device: the cameras of its
    ``data`` row (``w2c_local`` [B, 4, 4], ``k_local`` [B, 3, 3], the
    ground truth ``gt_local`` [B, H, W, 3] and the optional label maps
    [B, H, W]), the images cut to the rows of its ``tile`` slab."""
    dev = torch.device(device if device is not None else mesh.device_type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n_tile = mesh.size(1)
    t = mesh.get_local_rank("tile")
    h = np.shape(gt_local)[1]
    slab = h // n_tile

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    out = (put(w2c_local, torch.float32), put(k_local, torch.float32),
           put(np.asarray(gt_local)[:, t * slab:(t + 1) * slab],
               torch.float32))
    if sem_local is not None:
        out += (put(np.asarray(sem_local)[:, t * slab:(t + 1) * slab],
                    torch.int32),)
    return out

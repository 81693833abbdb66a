"""Starting the world of ranks, and gathering to rank 0 (PyTorch counterpart
of circulantpreconditioner_tpu/parallel/multihost.py): MPI_Init and
VecScatterCreateToZero.

One process per device: NCCL on `cuda:LOCAL_RANK`, gloo on the CPU. Where
the ranks come from, in `rank_world` (the drivers, the tests and
chip_smoke.py share it):

1. a process group the caller has initialised already;
2. torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, and its
   `MASTER_ADDR`/`MASTER_PORT`);
3. with no more than one device asked for, a world of one rank opened here
   (an in-memory store: no socket, no file);
4. otherwise an error that names `torchrun --nproc-per-node P`.

No two ranks share a GPU, and no rank falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from circulantpreconditioner_tpu_torch.parallel.mesh_utils import RankMesh, device_mesh
from circulantpreconditioner_tpu_torch.utils.device import resolve_device


def _init(device: torch.device, rank: int, world: int, local_rank: int, **kw) -> None:
    """init_process_group for one rank: NCCL on cuda:local_rank, or gloo."""
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if local_rank >= visible:
            raise RuntimeError(f"rank {rank} would drive cuda:{local_rank}, but {visible} "
                               "GPU(s) are visible: one rank per device")
        torch.cuda.set_device(local_rank)
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=torch.device("cuda", local_rank), **kw)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world, **kw)


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device: str = "cuda") -> None:
    """Join a world of `num_processes` ranks whose rank 0 listens at
    `coordinator` ("host:port"), as rank `process_id` (MPI_Init analog).
    On GPUs, hosts run one process per card: process_id modulo the host's
    card count picks this process's card."""
    dev = resolve_device(device)
    local = process_id % torch.cuda.device_count() if dev.type == "cuda" else 0
    _init(dev, process_id, num_processes, local, init_method=f"tcp://{coordinator}")


@contextlib.contextmanager
def rank_world(devices: int | None, device: str | torch.device = "cuda"):
    """The world of ranks for a sharded run of `devices` ranks (None: as
    many as the world has). Opens it from torchrun's environment, or as one
    rank, when no group is initialised, and then closes it on exit; a group
    the caller initialised is used and left open. CUDA graphs that captured
    its collectives must be released before it closes: destroying an NCCL
    communicator waits for the graphs that hold it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and devices and devices > torch.cuda.device_count():
        raise RuntimeError(f"--devices {devices}: {torch.cuda.device_count()} GPU(s) are "
                           "visible, and no two ranks share one")
    if dist.is_initialized():
        yield
        return
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        _init(dev, rank, world, int(env.get("LOCAL_RANK", rank)), init_method="env://")
    elif devices in (None, 1):
        _init(dev, 0, 1, 0, store=dist.HashStore())
    else:
        raise RuntimeError(
            f"--devices {devices} needs {devices} ranks, one process per device, and no "
            f"process group is initialised: start them with torchrun --nproc-per-node "
            f"{devices} -m <driver> ...")
    try:
        yield
    finally:
        dist.destroy_process_group()


def global_device_mesh(axis: str = "shard") -> RankMesh:
    """1D mesh over every rank of the world (PETSC_COMM_WORLD analog)."""
    return device_mesh(None, axis)


def gather_to_host0(x: torch.Tensor) -> np.ndarray | None:
    """VecScatterCreateToZero analog: the ranks' blocks of a row-sharded
    array, concatenated along axis 0, as a host array on rank 0 (None on the
    others). Every rank must call it."""
    mesh = global_device_mesh()
    full = mesh.all_gather(x, "shard")
    return full.cpu().numpy() if dist.get_rank() == 0 else None

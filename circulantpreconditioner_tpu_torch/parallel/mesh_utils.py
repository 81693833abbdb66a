"""Rank meshes over torch.distributed (PyTorch counterpart of
circulantpreconditioner_tpu/parallel/mesh_utils.py): the analog of the
reference's MPI communicator world, PETSC_COMM_WORLD.

The JAX package runs one program over a process's devices (`shard_map` over
a `jax.sharding.Mesh`). The port runs one process per device, each rank
holding only its own block of every sharded array, as PETSc's MPI ranks do.
A `RankMesh` is one rank's view of the mesh: the size of each named axis,
this rank's index along it, the process group of the ranks that share its
other indices, and the rank's device. Its methods are the collectives that
the JAX modules call inside `shard_map`:

- `all_to_all`: `jax.lax.all_to_all(..., tiled=True)`, by one
  `all_to_all_single`; complex tensors travel as (re, im) pairs;
- `all_gather`: `jax.lax.all_gather(..., tiled=True)` along axis 0;
- `ring_exchange`: the two `jax.lax.ppermute` rings of a halo exchange, as
  one `all_to_all_single` whose split sizes are zero but for the two
  neighbours. torch refuses a send to the rank's own process on gloo, and at
  one or two ranks both neighbours are one rank, or the rank itself: the
  all-to-all form serves every world size with one code path;
- `all_reduce`, `global_norms`: the psums of dot products and norms.

Every collective is issued at every world size, one rank included: there is
no single-rank shortcut. A mesh spans the whole world, since a rank outside
it would have no device of the mesh to drive.

Each collective can be captured in a CUDA graph (utils/graphs.py: the
sharded steps and GMRES): it issues on the current stream, its split sizes
follow from the shapes alone, and none reads a device value on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class RankMesh:
    """One rank's view of a mesh of ranks with named axes."""

    def __init__(self, axes, sizes, coords, groups, device: torch.device):
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, (int(s) for s in sizes)))  # as jax Mesh.shape
        self.coords = dict(zip(self.axes, (int(c) for c in coords)))  # this rank's indices
        self.groups = dict(zip(self.axes, groups))  # the process group along each axis
        self.device = device

    def all_to_all(self, x: torch.Tensor, axis: str, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """Tiled all-to-all along mesh axis `axis`: x's `split_axis` is cut
        into P blocks, block j goes to the j-th rank of the axis, and the
        blocks received are concatenated, in rank order, along `concat_axis`."""
        split_axis %= x.dim()
        concat_axis %= x.dim()
        if x.is_complex():
            return torch.view_as_complex(
                self.all_to_all(torch.view_as_real(x), axis, split_axis, concat_axis))
        P = self.shape[axis]
        S = x.shape[split_axis]
        if S % P:
            raise ValueError(f"axis {split_axis} of length {S} does not split over {P} ranks")
        send = x.movedim(split_axis, 0)
        send = send.reshape((P, S // P) + tuple(send.shape[1:])).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.groups[axis])
        # recv[i] is rank i's block with the split axis in front: put that
        # axis back, then the ranks just before the concatenated axis
        y = recv.movedim(1, split_axis + 1).movedim(0, concat_axis)
        shape = list(y.shape)
        return y.reshape(shape[:concat_axis] + [shape[concat_axis] * shape[concat_axis + 1]]
                         + shape[concat_axis + 2:])

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The blocks of every rank along `axis`, concatenated along axis 0."""
        if x.is_complex():
            return torch.view_as_complex(self.all_gather(torch.view_as_real(x), axis))
        P = self.shape[axis]
        out = torch.empty((P * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        # torch 2.13 renamed all_gather_into_tensor all_gather_single
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, x.contiguous(), group=self.groups[axis])
        return out

    def ring_exchange(self, to_right: torch.Tensor, to_left: torch.Tensor,
                      axis: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Send `to_right` to the next rank along `axis` and `to_left` to the
        previous one, around the ring; returns (from_left, from_right), each
        shaped as the messages (which must have equal sizes). With one rank
        both come from the rank itself: the periodic wrap."""
        P = self.shape[axis]
        r = self.coords[axis]
        right, left = (r + 1) % P, (r - 1) % P
        n = to_right.numel()
        if to_left.numel() != n:
            raise ValueError("ring_exchange needs messages of equal size")
        sizes = [0] * P
        sizes[right] += n
        sizes[left] += n
        # the block for each peer in peer order; inside a block the rightward
        # message first, so that the receiver finds its from_left first
        parts = []
        for j in range(P):
            if j == right:
                parts.append(to_right.reshape(-1))
            if j == left:
                parts.append(to_left.reshape(-1))
        send = torch.cat(parts)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, output_split_sizes=sizes, input_split_sizes=sizes,
                               group=self.groups[axis])
        at = 0
        for j in range(P):
            if j == left:
                from_left = recv[at:at + n]
                at += n
            if j == right:
                from_right = recv[at:at + n]
                at += n
        return from_left.reshape(to_right.shape), from_right.reshape(to_left.shape)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over every rank of the mesh (a new tensor)."""
        y = x.clone()
        dist.all_reduce(y)
        return y

    def global_norms(self, local: torch.Tensor) -> torch.Tensor:
        """2-norms of sharded vectors from the ranks' local 2-norms."""
        return torch.sqrt(self.all_reduce(local * local))


def rank_device() -> torch.device:
    """The device of this rank: its GPU under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _check_world(n: int) -> None:
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n < world:
        raise ValueError(f"requested {n} devices of a world of {world} ranks: a mesh spans "
                         "the whole world, one rank per device")


def device_mesh(n_devices: int | None = None, axis: str = "shard") -> RankMesh:
    """1D mesh over the world's ranks (the initialised process group)."""
    n = n_devices or dist.get_world_size()
    _check_world(n)
    return RankMesh((axis,), (n,), (dist.get_rank(),), (dist.group.WORLD,), rank_device())


def device_mesh_2d(shape: tuple[int, int], axes: tuple[str, str] = ("z", "y")) -> RankMesh:
    """2D (p, q) mesh for pencil decompositions: rank = i·q + j sits at (i, j).
    Along axes[0] the ranks share j, along axes[1] they share i; every rank
    creates every group, in one order, as torch.distributed requires."""
    p, q = (int(v) for v in shape)
    _check_world(p * q)
    i, j = divmod(dist.get_rank(), q)
    along0 = [dist.new_group([a * q + b for a in range(p)]) for b in range(q)]
    along1 = [dist.new_group([a * q + b for b in range(q)]) for a in range(p)]
    return RankMesh(axes, (p, q), (i, j), (along0[j], along1[i]), rank_device())


def shard_on_axis(x, mesh: RankMesh, axis_name: str, array_axis: int,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """This rank's block of x (host array or tensor) along `array_axis`,
    which splits evenly over mesh axis `axis_name`, on the rank's device."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    P = mesh.shape[axis_name]
    n = x.shape[array_axis]
    if n % P:
        raise ValueError(f"axis {array_axis} of length {n} does not split over {P} ranks")
    k = mesh.coords[axis_name]
    block = x.narrow(array_axis, k * (n // P), n // P)
    return block.to(device=mesh.device, dtype=dtype or block.dtype).contiguous()


def replicated(x, mesh: RankMesh, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole of x on the rank's device (every rank holds a copy)."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return x.to(device=mesh.device, dtype=dtype or x.dtype)

"""Shared CLI plumbing for the port's driver executables (counterpart of
circulantpreconditioner_tpu/drivers/common.py).

The reference drivers' positional `[mesh.med | nx [ny [nz]]]`: a mesh file
(.med, .msh or .typ3, read by mesh.read_mesh: welding, non-conforming repair,
grid-topology recovery or RCM order), or nx [ny [nz]] on the domain
[-0.5, 0.5]^d with `--mesh-family cartesian|hexa|tetra|kershaw|kershawtet`
(all but cartesian are 3D: missing extents repeat the last one; tetra and
kershawtet split each hex into 6 tets). `--msh FILE` reads a Gmsh file and
recovers its grid. `--device` picks the torch device (default "cuda", which
raises when no GPU is present). Output: `--vtk` snapshots, a `--med` time
series (needs h5py) and checkpoints, in --result-dir.

The drivers' `--shard` modes run one process per device (parallel/): under
`torchrun --nproc-per-node P`, or as one rank without it. `--devices` is the
rank count they expect, `--pq` the pencil mesh's shape. Every rank steps its
own block; rank 0 alone prints and writes files.
"""

from __future__ import annotations

import argparse
import os

import torch

import numpy as np

from circulantpreconditioner_tpu_torch.io import save_checkpoint, write_med, write_vtk
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh, read_mesh
from circulantpreconditioner_tpu_torch.mesh.med import import_h5py
from circulantpreconditioner_tpu_torch.mesh.topology import recover_grid_topology
from circulantpreconditioner_tpu_torch.mesh.unstructured import (
    hex_mesh,
    kershaw_mesh,
    kershaw_tet_mesh,
    read_gmsh,
    tet_mesh,
)
from circulantpreconditioner_tpu_torch.utils.device import resolve_device


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("n", nargs="*",
                   help="mesh.med|mesh.msh|mesh.typ3 file, or nx [ny [nz]] (cartesian "
                        "[-0.5,0.5]^d) — same positional convention as the reference drivers")
    p.add_argument("--mesh-family", choices=["cartesian", "hexa", "tetra", "kershaw",
                                             "kershawtet"],
                   default="cartesian")
    p.add_argument("--msh", help="Gmsh .msh v2.2 file (overrides n / family)")
    p.add_argument("--periodic", action="store_true", help="periodic BCs (cartesian only)")
    p.add_argument("--kershaw-eps", type=float, default=0.3,
                   help="Kershaw distortion in (0, 1]; 1 = uniform")
    p.add_argument("--tmax", type=float, default=0.05)
    p.add_argument("--ntmax", type=int, default=2_000_000)
    p.add_argument("--cfl", type=float, default=None)
    p.add_argument("--precision", type=float, default=1e-5,
                   help="stationarity threshold on ||dU||_2 (reference: 1e-5)")
    p.add_argument("--output-freq", type=int, default=1)
    p.add_argument("--chunk", type=int, default=None,
                   help="steps per host synchronisation (default output-freq; "
                        "1 = step-by-step host loop)")
    p.add_argument("--result-dir", default="./results")
    p.add_argument("--vtk", action="store_true", help="write VTK snapshots")
    p.add_argument("--med", action="store_true", help="write a MED time series")
    p.add_argument("--checkpoint-freq", type=int, default=0,
                   help="save (state,t,it) every N steps (0 = off)")
    p.add_argument("--f64", action="store_true", help="float64")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a GPU) or cpu")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks of a --shard run, one process per device (default: the "
                        "world's size; more than 1 needs torchrun --nproc-per-node P)")
    p.add_argument("--pq", type=int, nargs=2, default=None,
                   help="pencil rank-mesh shape (p q)")
    return p


def build_mesh(args):
    if args.msh:
        mesh = read_gmsh(args.msh)
        recover_grid_topology(mesh)
        return mesh
    if args.n and not str(args.n[0]).lstrip("-").isdigit():
        return read_mesh(args.n[0])
    n = [int(v) for v in args.n] or [50, 50]  # reference default 50x50 square
    if args.mesh_family == "cartesian":
        return cartesian_mesh(((-0.5, 0.5),) * len(n), n, periodic=args.periodic)
    bounds = ((-0.5, 0.5),) * 3
    n3 = (n + [n[-1]] * 3)[:3]
    if args.mesh_family == "hexa":
        return hex_mesh(bounds, n3)
    if args.mesh_family == "tetra":
        return tet_mesh(bounds, n3)
    if args.mesh_family == "kershawtet":
        # generated 3DKershawTetra analog (the reference ladder's top family)
        return kershaw_tet_mesh(bounds, n3, eps=args.kershaw_eps)
    return kershaw_mesh(bounds, n3, eps=args.kershaw_eps)


def setup_dtype(args) -> tuple[torch.device, torch.dtype]:
    """(device, dtype) from --device and --f64."""
    return resolve_device(args.device), (torch.float64 if args.f64 else torch.float32)


def make_output_cb(args, mesh, split=None, prefix="field"):
    """Per-output callback (it, t, U, extras) on the flat cell-major state U
    (host or device): VTK snapshots (--vtk), one MED time series (--med) and
    checkpoints, in --result-dir. `split` (U → pressure, velocity) names the
    fields the writers take; without it the state is one field, `prefix`.
    Files are named by the mesh name's last path component (a mesh read
    from a Gmsh file is named by its path)."""
    if args.med:
        import_h5py()  # raise before the run, not at its first output
    os.makedirs(args.result_dir, exist_ok=True)
    stem = os.path.join(args.result_dir, os.path.basename(mesh.name))
    med_path = f"{stem}_{prefix}.med"
    wrote_med = [False]

    def cb(it, t, U, extras):
        if args.vtk or args.med:
            if split is not None:
                p, v = split(U)
                fields = {"pressure": p, "velocity": v}
            else:
                fields = {prefix: (U.detach().cpu().numpy() if isinstance(U, torch.Tensor)
                                   else np.asarray(U)).reshape(-1)}
            if args.vtk:
                write_vtk(f"{stem}_{prefix}_{it:06d}.vtk", mesh, fields, time=t)
            if args.med:
                write_med(med_path, mesh, fields, time=t, it=it, append=wrote_med[0])
                wrote_med[0] = True
        if args.checkpoint_freq and it % args.checkpoint_freq == 0:
            save_checkpoint(f"{stem}_ckpt.npz", U, t, it)

    return cb


def chunk_of(args) -> int:
    """Steps per host synchronisation: --chunk, default --output-freq."""
    c = args.chunk if args.chunk is not None else args.output_freq
    return max(int(c), 1)


def rank0_print():
    """print on rank 0 of a sharded run, None on the others (run_time_loop's
    `log`)."""
    import torch.distributed as dist

    return print if dist.get_rank() == 0 else None


def make_sharded_output_cb(args, mesh, unshard, device: torch.device, split=None,
                           prefix="field"):
    """make_output_cb for a sharded run: at each output every rank gathers the
    state (`unshard` of its block, a collective) and rank 0 alone writes.
    None when no output is asked for."""
    import torch.distributed as dist

    if not (args.vtk or args.med or args.checkpoint_freq):
        return None
    cb = make_output_cb(args, mesh, split=split, prefix=prefix) if dist.get_rank() == 0 else None

    def on_output(it, t, U, extras):
        full = unshard(torch.as_tensor(U, device=device))
        if cb is not None:
            cb(it, t, full.cpu().numpy(), extras)  # host arrays, as run_time_loop passes

    return on_output


def sharded_rows(D, dm, dtype):
    """(row-sharded D, its description): the halo ELL rows where the band
    fits a halo, else the all-gather ELL rows."""
    from circulantpreconditioner_tpu_torch.parallel import HaloELLMatrix, ShardedELLMatrix

    A = D.to_csr(dtype)
    try:
        As = HaloELLMatrix(A, dm, row_multiple=D.block_size)
        return As, f"halo exchange (w={As.halo})"
    except ValueError:
        return ShardedELLMatrix(A, dm, row_multiple=D.block_size), "all-gather"

"""Shared CLI plumbing for the port's driver executables (counterpart of
circulantpreconditioner_tpu/drivers/common.py).

Positional nx [ny [nz]] on the domain [-0.5, 0.5]^d, as the reference
drivers, with `--mesh-family cartesian|hexa|tetra|kershaw|kershawtet` (all
but cartesian are 3D: missing extents repeat the last one; tetra and
kershawtet split each hex into 6 tets). `--device` picks the torch device
(default "cuda", which raises when no GPU is present). Mesh files and the
VTK/MED writers raise NotImplementedError naming their ROADMAP.md item;
checkpoints are written.
"""

from __future__ import annotations

import argparse
import os

import torch

from circulantpreconditioner_tpu_torch.io import save_checkpoint
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
from circulantpreconditioner_tpu_torch.mesh.unstructured import (
    hex_mesh,
    kershaw_mesh,
    kershaw_tet_mesh,
    tet_mesh,
)
from circulantpreconditioner_tpu_torch.utils.device import resolve_device


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("n", nargs="*",
                   help="nx [ny [nz]] (cartesian [-0.5,0.5]^d) — same positional "
                        "convention as the reference drivers")
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
    return p


def build_mesh(args):
    if args.msh or (args.n and not str(args.n[0]).lstrip("-").isdigit()):
        raise NotImplementedError("mesh files (.msh/.med) are not ported yet: "
                                  "see ROADMAP.md, queue 1, item 12a (mesh readers)")
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
    """Per-output callback (it, t, U, extras) on the flat cell-major state U.
    `split` (U → pressure, velocity) names the fields the VTK/MED writers
    take; the writers are not ported yet (ROADMAP.md, slice 3, item 23b)."""
    if args.vtk or args.med:
        raise NotImplementedError("--vtk/--med writers are not ported yet: "
                                  "see ROADMAP.md, slice 3, item 23b")
    os.makedirs(args.result_dir, exist_ok=True)

    def cb(it, t, U, extras):
        if args.checkpoint_freq and it % args.checkpoint_freq == 0:
            save_checkpoint(os.path.join(args.result_dir, f"{mesh.name}_ckpt.npz"), U, t, it)

    return cb


def chunk_of(args) -> int:
    """Steps per host synchronisation: --chunk, default --output-freq."""
    c = args.chunk if args.chunk is not None else args.output_freq
    return max(int(c), 1)

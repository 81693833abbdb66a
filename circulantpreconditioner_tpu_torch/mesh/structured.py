"""Structured cartesian mesh generator (1/2/3D).

NumPy copy of circulantpreconditioner_tpu/mesh/structured.py: the same cell
numbering (x fastest) and the same face and group tables.

Replicates the SOLVERLAB `Mesh(xinf,xsup,nx[,yinf,ysup,ny[,zinf,zsup,nz]])`
constructor used by every reference driver (e.g. tests/TransportEquationFFT_
SphericalExplosion_impl_mpi.cxx:191-222) plus the `setGroupAtPlan` boundary
tagging (tests/WaveSystem_SphericalExplosion_expl_seq.cxx:156-167).

Cell numbering is C-order over (z, y, x) with x fastest —
cell(x=i, y=j, z=k) = k·ny·nx + j·nx + i — identical to the flattening the
reference's FFT solver assumes (testFftSolver_3D.py:38-41), so a structured
field reshapes directly to the (nz, ny, nx) grid of ops/circulant.py.
"""

from __future__ import annotations

import numpy as np

from circulantpreconditioner_tpu_torch.mesh.core import INTERIOR, Mesh
from circulantpreconditioner_tpu_torch.utils.profiling import host_spanned


@host_spanned("port.setup.mesh")
def cartesian_mesh(
    bounds,  # ((x0,x1), (y0,y1), (z0,z1)) truncated to dim entries
    n,  # (nx[, ny[, nz]])
    default_group: str = "Wall",
    periodic: bool | list[bool] = False,
    name: str | None = None,
) -> Mesh:
    """Uniform cartesian mesh. `periodic` may be a single flag or per-axis
    list; periodic axes get matching twin faces and group "Periodic"."""
    n = tuple(int(v) for v in np.atleast_1d(n))
    dim = len(n)
    bounds = np.asarray(bounds, dtype=np.float64).reshape(dim, 2)
    per = list(periodic) if isinstance(periodic, (list, tuple)) else [bool(periodic)] * dim
    h = (bounds[:, 1] - bounds[:, 0]) / np.asarray(n)

    # cell centers, C-order (z, y, x) with x fastest
    axes_1d = [bounds[d, 0] + (np.arange(n[d]) + 0.5) * h[d] for d in range(dim)]
    grids = np.meshgrid(*reversed(axes_1d), indexing="ij")  # z, y, x order
    centers = np.stack([g.reshape(-1) for g in reversed(grids)], axis=1)  # (nC, dim) xyz cols

    nC = int(np.prod(n))
    vol = float(np.prod(h))
    cell_volume = np.full(nC, vol)

    strides = np.ones(dim, dtype=np.int64)  # stride of +1 step along axis d (xyz order)
    for d in range(1, dim):
        strides[d] = strides[d - 1] * n[d - 1]

    # multi-index of each cell along each xyz axis
    idx = np.arange(nC, dtype=np.int64)
    coords = np.empty((nC, dim), dtype=np.int64)
    rem = idx.copy()
    for d in range(dim):
        coords[:, d] = rem % n[d]
        rem //= n[d]

    face_cells = []
    face_normal = []
    face_area = []
    face_center = []
    face_group = []
    twins = []

    groups: dict[str, int] = {}

    def get_code(gname: str) -> int:
        if gname not in groups:
            groups[gname] = len(groups) + 1
        return groups[gname]

    area_d = [vol / h[d] for d in range(dim)]

    for d in range(dim):
        nd = n[d]
        e = np.zeros(dim)
        e[d] = 1.0
        # interior faces between cell i and i+1 along axis d
        mask = coords[:, d] < nd - 1
        L = idx[mask]
        R = L + strides[d]
        k = len(L)
        face_cells.append(np.stack([L, R], axis=1))
        face_normal.append(np.tile(e, (k, 1)))
        face_area.append(np.full(k, area_d[d]))
        fc = centers[L].copy()
        fc[:, d] += h[d] / 2
        face_center.append(fc)
        face_group.append(np.full(k, INTERIOR, dtype=np.int32))
        twins.append(np.full(k, -1, dtype=np.int64))

        # boundary faces at the low and high planes of axis d
        for side, sign in ((0, -1.0), (nd - 1, +1.0)):
            mask_b = coords[:, d] == side
            Lb = idx[mask_b]
            kb = len(Lb)
            gname = "Periodic" if per[d] else default_group
            code = get_code(gname)
            face_cells.append(np.stack([Lb, np.full(kb, -1, dtype=np.int64)], axis=1))
            face_normal.append(np.tile(sign * e, (kb, 1)))
            face_area.append(np.full(kb, area_d[d]))
            fcb = centers[Lb].copy()
            fcb[:, d] += sign * h[d] / 2
            face_center.append(fcb)
            face_group.append(np.full(kb, code, dtype=np.int32))
            if per[d]:
                # twin face is the boundary face on the opposite plane of the
                # SAME (other-axes) position; record the opposite CELL so the
                # assembly can couple to it: store twin as index into the face
                # list we are about to append for the opposite side. Simpler
                # and sufficient: twin cell = wrap-around neighbour.
                twin_cell = Lb + (strides[d] * (nd - 1) * (1 if side == 0 else -1))
                twins.append(twin_cell)  # NOTE: stores the twin CELL id
            else:
                twins.append(np.full(kb, -1, dtype=np.int64))

    mesh = Mesh(
        dim=dim,
        cell_center=centers,
        cell_volume=cell_volume,
        face_cells=np.concatenate(face_cells),
        face_normal=np.concatenate(face_normal),
        face_area=np.concatenate(face_area),
        face_center=np.concatenate(face_center),
        face_group=np.concatenate(face_group),
        groups=groups,
        periodic_twin=np.concatenate(twins),
        structured_shape=n,
        bounds=bounds,
        name=name or f"cartesian_{'x'.join(map(str, n))}",
    )
    mesh.spacing = h  # type: ignore[attr-defined]
    # x-fastest cell numbering IS a topological grid: lets the gather-free
    # varying-stencil / field-major paths apply to cartesian meshes too
    # (diffusion has no dedicated uniform-stencil operator and previously
    # fell back to the assembled-CSR gather matvec here)
    mesh.topology_shape = tuple(int(v) for v in n)  # type: ignore[attr-defined]
    return mesh


def set_group_at_plane(mesh: Mesh, axis: int, value: float, name: str, tol: float = 1e-10):
    """Tag boundary faces lying on the plane x_axis == value with group
    `name` (setGroupAtPlan analog)."""
    if name not in mesh.groups:
        mesh.groups[name] = len(mesh.groups) + 1
    code = mesh.groups[name]
    on_plane = np.abs(mesh.face_center[:, axis] - value) < tol
    boundary = mesh.face_cells[:, 1] < 0
    mesh.face_group[on_plane & boundary] = code
    return mesh

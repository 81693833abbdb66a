"""Legacy-VTK output of cell fields: NumPy copy of
circulantpreconditioner_tpu/io/vtk.py (`--vtk`).

ASCII legacy VTK, which ParaView and VisIt read. Structured meshes are
written as STRUCTURED_POINTS; meshes with stored cell-vertex connectivity
(generated or read from a file) as an UNSTRUCTURED_GRID; a mesh with faces
only as a POLYDATA cloud of cell centres. Fields are host arrays (NumPy);
the drivers move the state off the device before writing.
"""

from __future__ import annotations

import os

import numpy as np

from circulantpreconditioner_tpu_torch.mesh.core import Mesh

_VTK_CELL = {4: 10, 8: 12}  # tet, hex


def write_vtk(path: str, mesh: Mesh, fields: dict[str, np.ndarray], time: float | None = None):
    """fields: name → (nC,) or (nC, k) cell arrays. Returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"{mesh.name} t={time if time is not None else 0}\n")
        f.write("ASCII\n")
        if mesh.is_structured:
            n = list(mesh.structured_shape) + [1, 1]
            nx, ny, nz = n[0], n[1], n[2]
            h = list(getattr(mesh, "spacing", [1.0] * mesh.dim)) + [1.0, 1.0]
            b = mesh.bounds
            org = [b[d, 0] if d < mesh.dim else 0.0 for d in range(3)]
            f.write("DATASET STRUCTURED_POINTS\n")
            f.write(f"DIMENSIONS {nx + 1} {ny + 1} {nz + 1}\n")
            f.write(f"ORIGIN {org[0]} {org[1]} {org[2]}\n")
            f.write(f"SPACING {h[0]} {h[1]} {h[2]}\n")
        elif hasattr(mesh, "points"):
            pts = mesh.points
            cells = mesh.cell_vertices
            f.write("DATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {len(pts)} double\n")
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
            total = sum(len(c) + 1 for c in cells)
            f.write(f"CELLS {len(cells)} {total}\n")
            for c in cells:
                f.write(" ".join([str(len(c))] + [str(v) for v in c]) + "\n")
            f.write(f"CELL_TYPES {len(cells)}\n")
            for c in cells:
                f.write(f"{_VTK_CELL[len(c)]}\n")
        else:
            f.write("DATASET POLYDATA\n")
            f.write(f"POINTS {mesh.n_cells} double\n")
            for p in mesh.cell_center:
                row = list(p) + [0.0] * (3 - len(p))
                f.write(f"{row[0]} {row[1]} {row[2]}\n")
        f.write(f"CELL_DATA {mesh.n_cells}\n" if mesh.is_structured or hasattr(mesh, "points")
                else f"POINT_DATA {mesh.n_cells}\n")
        for name, data in fields.items():
            data = np.asarray(data)
            if data.ndim == 1:
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                for v in data:
                    f.write(f"{v}\n")
            else:
                k = data.shape[1]
                if k == mesh.dim and k < 3:
                    data = np.concatenate([data, np.zeros((len(data), 3 - k))], axis=1)
                    k = 3
                if k == 3:
                    f.write(f"VECTORS {name} double\n")
                    for v in data:
                        f.write(f"{v[0]} {v[1]} {v[2]}\n")
                else:
                    f.write(f"SCALARS {name} double {k}\nLOOKUP_TABLE default\n")
                    for v in data:
                        f.write(" ".join(str(x) for x in v) + "\n")
    return path

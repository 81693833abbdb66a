"""FVCA6 `.typ3` mesh reader: NumPy copy of
circulantpreconditioner_tpu/mesh/typ3.py.

The format stores the face-major connectivity directly: vertices, the
vertices of each face and the two cells of each face (1-based), so no face
extraction is needed. Geometry by fan triangulation, volumes by the
divergence theorem, normals outward of the first incident cell.
"""

from __future__ import annotations

import numpy as np

from circulantpreconditioner_tpu_torch.mesh.core import INTERIOR, Mesh


def _read_block(lines, i, expect_header):
    while not lines[i].strip().startswith(expect_header):
        i += 1
    return i + 1


def read_typ3(path: str, name: str | None = None, default_group: str = "Wall") -> Mesh:
    """The mesh of an FVCA `.typ3` file. Each block starts on a line that
    begins with its name and ends with its count (`Vertices`,
    `Volumes->faces`, `Volumes->Vertices`, `Faces->Vertices`,
    `Faces->Control volumes`); numbers may use Fortran `D` exponents; ids are
    1-based, and a face's second cell is 0 or negative on the boundary."""
    with open(path) as fh:
        lines = fh.read().splitlines()

    i = _read_block(lines, 0, "Vertices")
    nV = int(lines[i - 1].split()[-1])
    pts = np.array(
        [[float(v.replace("D", "E")) for v in lines[i + j].split()] for j in range(nV)]
    )
    i += nV

    i = _read_block(lines, i, "Volumes->faces")
    nC = int(lines[i - 1].split()[-1])
    i += nC  # cell->face ids not needed; faces carry the incidence

    i = _read_block(lines, i, "Volumes->Vertices")
    cell_verts = []
    for j in range(nC):
        row = [int(v) for v in lines[i + j].split()]
        cell_verts.append([v - 1 for v in row[1: 1 + row[0]]])
    i += nC

    i = _read_block(lines, i, "Faces->Vertices")
    nF = int(lines[i - 1].split()[-1])
    face_verts = []
    for j in range(nF):
        row = [int(v) for v in lines[i + j].split()]
        face_verts.append([v - 1 for v in row[1: 1 + row[0]]])
    i += nF

    i = _read_block(lines, i, "Faces->Control volumes")
    fc = np.full((nF, 2), -1, dtype=np.int64)
    for j in range(nF):
        a, b = (int(v) for v in lines[i + j].split()[:2])
        fc[j] = (a - 1 if a > 0 else -1, b - 1 if b > 0 else -1)
    # boundary faces may list the cell in either slot; normalize cell0 >= 0
    swap = fc[:, 0] < 0
    fc[swap] = fc[swap][:, ::-1]
    if (fc[:, 0] < 0).any():
        raise ValueError(f"{path}: face with no incident cell")

    # vectorized fan geometry over padded face-vertex array (padding by
    # repeating the first vertex is exact for the fan area formula)
    kmax = max(len(f) for f in face_verts)
    fvp = np.array([f + [f[0]] * (kmax - len(f)) for f in face_verts], dtype=np.int64)
    P = pts[fvp]  # (nF, kmax, 3)
    c = P.mean(axis=1)
    b = P[:, list(range(1, kmax)) + [0], :]
    tri_n = 0.5 * np.cross(P - c[:, None, :], b - c[:, None, :])
    total = tri_n.sum(axis=1)
    area = np.linalg.norm(total, axis=1)
    if (area < 1e-300).any():
        raise ValueError("degenerate face")
    normal = total / area[:, None]
    tri_area = np.linalg.norm(tri_n, axis=2)
    tri_ctr = (P + b + c[:, None, :]) / 3.0
    center = (tri_area[:, :, None] * tri_ctr).sum(axis=1) / np.maximum(
        tri_area.sum(axis=1), 1e-300
    )[:, None]

    cell_centroid = np.array([pts[cv].mean(axis=0) for cv in cell_verts])
    flip = np.einsum("fd,fd->f", normal, center - cell_centroid[fc[:, 0]]) < 0
    normal[flip] = -normal[flip]

    cell_volume = np.zeros(nC)
    contrib = area * np.einsum("fd,fd->f", center, normal) / 3.0
    np.add.at(cell_volume, fc[:, 0], contrib)
    m2 = fc[:, 1] >= 0
    np.add.at(cell_volume, fc[m2, 1], -contrib[m2])

    face_group = np.where(fc[:, 1] < 0, 1, INTERIOR).astype(np.int32)
    mesh = Mesh(
        dim=3,
        cell_center=cell_centroid,
        cell_volume=cell_volume,
        face_cells=fc,
        face_normal=normal,
        face_area=area,
        face_center=center,
        face_group=face_group,
        groups={default_group: 1},
        periodic_twin=None,
        structured_shape=None,
        bounds=None,
        name=name or path.rsplit("/", 1)[-1],
    )
    mesh.points = pts  # type: ignore[attr-defined]
    mesh.cell_vertices = [tuple(cv) for cv in cell_verts]  # type: ignore[attr-defined]
    mesh.face_vertices = [tuple(f) for f in face_verts]  # type: ignore[attr-defined]
    return mesh

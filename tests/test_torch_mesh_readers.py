"""The port's mesh readers against the JAX package's, on the same inputs and
the same files (written to tmp_path): weld_points, the Gmsh 2.2 reader
(shuffled cells, duplicated vertices, ignored 2D elements), the 2D polygon
meshes, the typ3 reader, and the MED reader on files that the JAX package's
write_med writes (3D hexahedra, tetrahedra, a mixed mesh, 2D), with
boundary groups. Every array is compared bit for bit (np.array_equal).

Also the small Gmsh 2.2 writer the other mesh-file tests use, and the mesh
comparison they share."""

import os
import subprocess
import sys

import numpy as np
import pytest

import circulantpreconditioner_tpu.mesh.unstructured as ju
import circulantpreconditioner_tpu_torch.mesh.unstructured as tu
from circulantpreconditioner_tpu.io import write_med as j_write_med
from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.mesh import read_med as j_read_med
from circulantpreconditioner_tpu.mesh import read_mesh as j_read_mesh
from circulantpreconditioner_tpu.mesh import read_typ3 as j_read_typ3
from circulantpreconditioner_tpu_torch.mesh import read_med as t_read_med
from circulantpreconditioner_tpu_torch.mesh import read_mesh as t_read_mesh
from circulantpreconditioner_tpu_torch.mesh import read_typ3 as t_read_typ3

CUBE = ((-0.5, 0.5),) * 3
MESH_ARRAYS = ("cell_center", "cell_volume", "face_cells", "face_normal", "face_area",
               "face_center", "face_group", "points")


def write_gmsh(path, points, cells, seed=None, boundary_quads=0):
    """A Gmsh MSH 2.2 ASCII file of `cells` (tetrahedra, type 4, or
    hexahedra, type 5), coordinates to 17 significant digits (exact). With a
    seed, the node ids are a shuffled range starting at 7 and the elements
    are written in shuffled order; `boundary_quads` 2D elements (type 3,
    which the readers ignore) are written first."""
    points = np.asarray(points, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int64)
    rng = np.random.default_rng(seed)
    ids = np.arange(len(points)) + 1
    order = np.arange(len(cells))
    if seed is not None:
        ids = rng.permutation(len(points)) + 7
        order = rng.permutation(len(cells))
    etype = {4: 4, 8: 5}[cells.shape[1]]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(len(points))]
    lines += [f"{i} {x:.17g} {y:.17g} {z:.17g}" for i, (x, y, z) in zip(ids, points)]
    lines += ["$EndNodes", "$Elements", str(boundary_quads + len(cells))]
    lines += [f"{e + 1} 3 2 1 1 " + " ".join(str(ids[v]) for v in cells[e, :4])
              for e in range(boundary_quads)]
    lines += [f"{boundary_quads + k + 1} {etype} 2 0 1 " + " ".join(str(v) for v in ids[cells[c]])
              for k, c in enumerate(order)]
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return str(path)


def duplicated_vertices(points, cells):
    """Each cell with its own copies of its vertices, as the reference's
    3DKershawTetra files store them."""
    cells = np.asarray(cells)
    return np.asarray(points)[cells.reshape(-1)], np.arange(cells.size).reshape(cells.shape)


def assert_same_mesh(mt, mj):
    """Every array and attribute of the port's mesh equal to the JAX mesh's,
    bit for bit."""
    assert (mt.dim, mt.n_cells, mt.n_faces, mt.name) == (mj.dim, mj.n_cells, mj.n_faces, mj.name)
    for a in MESH_ARRAYS:
        assert np.array_equal(getattr(mt, a), getattr(mj, a)), a
    assert mt.groups == mj.groups
    for a in ("cell_vertices", "face_vertices"):
        vt, vj = getattr(mt, a), getattr(mj, a)
        assert len(vt) == len(vj) and all(
            np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(vt, vj)), a
    for a in ("welded_nodes", "topology_shape", "bandwidth_ordered"):
        assert getattr(mt, a, None) == getattr(mj, a, None), a
    for a in ("cell_permutation", "periodic_twin"):
        pt, pj = getattr(mt, a, None), getattr(mj, a, None)
        assert (pt is None) == (pj is None) and (pt is None or np.array_equal(pt, pj)), a


# --- weld_points -----------------------------------------------------------

@pytest.mark.parametrize("case", ["duplicates", "clean", "bin-straddling"])
def test_weld_points_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "duplicates":
        pts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                        [1.0 + 1e-13, 0.0, 0.0], [0.5, 0.5, 0.5]])
    elif case == "clean":
        pts = rng.random((50, 3))
    else:  # copies 0.2·tol apart on either side of a rounding-bin edge
        base = rng.random((20, 3))
        edge = (np.round(base / 1e-9) + 0.5) * 1e-9
        pts = np.concatenate([edge - 1e-10, edge + 1e-10, base])
    pt, rt = tu.weld_points(pts)
    pj, rj = ju.weld_points(pts)
    assert np.array_equal(pt, pj)
    assert (rt is None) == (rj is None) and (rt is None or np.array_equal(rt, rj))
    if case != "clean":
        assert rt is not None and len(pt) < len(pts)


# --- Gmsh ------------------------------------------------------------------

def test_read_gmsh_shuffled_kershaw_hex(tmp_path):
    """Kershaw 6³ with shuffled node ids and cells, and 2D quads to ignore:
    the homogeneous file reaches the vectorised build as one array."""
    m = tu.kershaw_mesh(CUBE, (6, 6, 6))
    path = write_gmsh(tmp_path / "k6.msh", m.points, m.cell_vertices, seed=1, boundary_quads=3)
    mt, mj = tu.read_gmsh(path), ju.read_gmsh(path)
    assert_same_mesh(mt, mj)
    assert isinstance(mt.cell_vertices, np.ndarray) and mt.welded_nodes is False
    assert mt.n_cells == 216 and np.isclose(mt.cell_volume.sum(), 1.0)
    mt.validate()


def test_read_gmsh_kershaw_tet_duplicated_vertices(tmp_path):
    m = tu.kershaw_tet_mesh(CUBE, (4, 4, 4))
    pts, cells = duplicated_vertices(m.points, m.cell_vertices)
    path = write_gmsh(tmp_path / "kt4.msh", pts, cells)
    mt, mj = tu.read_gmsh(path), ju.read_gmsh(path)
    assert_same_mesh(mt, mj)
    assert mt.welded_nodes is True and len(mt.points) == len(m.points)
    # welded, the file's mesh is the generated one: the cells keep their order
    for a in ("cell_center", "cell_volume", "face_cells", "face_area", "face_normal"):
        assert np.array_equal(getattr(mt, a), getattr(m, a)), a


def test_read_gmsh_unlisted_node_raises(tmp_path):
    path = tmp_path / "bad.msh"
    path.write_text("$Nodes\n1\n1 0 0 0\n$EndNodes\n$Elements\n1\n1 4 2 0 1 1 2 3 4\n"
                    "$EndElements\n")
    with pytest.raises(ValueError, match="not listed"):
        tu.read_gmsh(str(path))


# --- 2D polygon meshes -----------------------------------------------------

@pytest.mark.parametrize("kind", ["triangles", "quads", "mixed"])
def test_build_mesh_from_cells_2d_matches_jax(kind):
    if kind == "triangles":
        pts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.5, 0.5]])
        cells = [(0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)]
    elif kind == "quads":
        x, y = np.meshgrid(np.linspace(0, 1, 4), np.linspace(0, 2, 3))
        pts = np.stack([x.ravel() + 0.1 * y.ravel() ** 2, y.ravel()], axis=1)
        cells = [(j * 4 + i, j * 4 + i + 1, (j + 1) * 4 + i + 1, (j + 1) * 4 + i)
                 for j in range(2) for i in range(3)]
    else:
        pts = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
        cells = [(0, 1, 4, 3), (1, 2, 4)]
    mt = tu.build_mesh_from_cells_2d(pts, cells)
    assert_same_mesh(mt, ju.build_mesh_from_cells_2d(pts, cells))
    mt.validate()


# --- typ3 ------------------------------------------------------------------

def write_typ3(path, points, cell_vertices, face_vertices, face_cells):
    """An FVCA .typ3 file: 1-based ids, Fortran D exponents, a face's second
    cell 0 on the boundary."""
    fmt = lambda x: f"{x:.17E}".replace("E", "D")  # noqa: E731
    rows = [f"Vertices {len(points)}"] + [" ".join(fmt(v) for v in p) for p in points]
    rows += [f"Volumes->faces {len(cell_vertices)}"]
    rows += [f"{sum(c in fc for fc in face_cells)}" for c in range(len(cell_vertices))]
    rows += [f"Volumes->Vertices {len(cell_vertices)}"]
    rows += [" ".join(str(v) for v in [len(cv)] + [int(v) + 1 for v in cv]) for cv in cell_vertices]
    rows += [f"Faces->Vertices {len(face_vertices)}"]
    rows += [" ".join(str(v) for v in [len(fv)] + [int(v) + 1 for v in fv]) for fv in face_vertices]
    rows += [f"Faces->Control volumes {len(face_cells)}"]
    rows += [f"{a + 1} {b + 1 if b >= 0 else 0}" for a, b in face_cells]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return str(path)


def test_read_typ3_matches_jax(tmp_path):
    """A Kershaw (3,2,2) mesh written as typ3 from its own faces."""
    m = tu.kershaw_mesh(CUBE, (3, 2, 2))
    fv = [tuple(int(v) for v in r if v >= 0) for r in m.face_vertices]
    path = write_typ3(tmp_path / "k.typ3", m.points, m.cell_vertices, fv, m.face_cells)
    mt = t_read_typ3(path)
    assert_same_mesh(mt, j_read_typ3(path))
    mt.validate()
    assert mt.name == "k.typ3"
    np.testing.assert_allclose(mt.cell_volume, m.cell_volume, rtol=1e-13)


# --- MED -------------------------------------------------------------------

class CellMesh:
    """What write_med needs of a mesh given by its cells."""

    def __init__(self, name, points, cells, dim=3):
        self.name, self.dim, self.is_structured = name, dim, False
        self.points, self.cell_vertices, self.n_cells = np.asarray(points, float), cells, len(cells)


def mixed_mesh():
    """A hexahedron, a pyramid on its top face and a tetrahedron on a
    pyramid side: one cell of each of HE8, PY5 and TE4, listed out of
    block order."""
    pts = [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1],
           [0, 1, 1], [0.5, 0.5, 1.5], [1.5, 0.5, 1.5]]
    cells = [(4, 5, 6, 7, 8), (5, 6, 8, 9), (0, 1, 2, 3, 4, 5, 6, 7)]
    return CellMesh("mixed", pts, cells)


def med_file(tmp_path, kind):
    """A MED file written by the JAX package's write_med."""
    if kind == "hex":
        m = j_cartesian(((0, 1),) * 3, (3, 2, 2))
        m.name = "box"
    elif kind == "kershaw":
        m = ju.kershaw_mesh(CUBE, (3, 3, 2))
    elif kind == "tet":
        m = ju.tet_mesh(((0, 1),) * 3, (2, 2, 2))
        m.name = "tets"
    elif kind == "mixed":
        m = mixed_mesh()
    elif kind == "2d":
        m = j_cartesian(((0.0, 1.0), (0.0, 1.0)), (6, 5))
        m.name = "square2d"
    else:
        pts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.5, 0.5]])
        m = ju.build_mesh_from_cells_2d(pts, [(0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)],
                                        name="tris")
    path = str(tmp_path / f"{kind}.med")
    j_write_med(path, m, {"u": np.arange(m.n_cells, dtype=float)}, time=0.0, it=0)
    return path


@pytest.mark.parametrize("kind", ["hex", "kershaw", "tet", "mixed", "2d", "tri"])
def test_read_med_matches_jax(tmp_path, kind):
    path = med_file(tmp_path, kind)
    mt = t_read_med(path)
    assert_same_mesh(mt, j_read_med(path))
    mt.validate()


@pytest.mark.parametrize("kind", ["hex", "kershaw", "tet", "mixed", "2d"])
def test_read_mesh_matches_jax(tmp_path, kind):
    """read_mesh: the non-conforming gate, grid recovery or RCM order."""
    path = med_file(tmp_path, kind)
    mt = t_read_mesh(path)
    assert_same_mesh(mt, j_read_mesh(path))
    if kind in ("hex", "kershaw"):
        assert mt.topology_shape == ((3, 2, 2) if kind == "hex" else (3, 3, 2))


def test_read_med_boundary_groups(tmp_path):
    """Families to groups: QU4 boundary elements of the x = 0 side in a
    family whose group is "Gauche" (FAS/<mesh>/ELEME, 80-byte names)."""
    import h5py

    path = med_file(tmp_path, "hex")
    with h5py.File(path, "a") as f:
        it = f["ENS_MAA/box"][list(f["ENS_MAA/box"])[0]]
        # the four x = 0 quads of the (3, 2, 2) lattice, x fastest: vertex (0, j, k)
        quads = np.array([[(k * 3 + j) * 4, ((k + 1) * 3 + j) * 4, ((k + 1) * 3 + j + 1) * 4,
                           (k * 3 + j + 1) * 4] for k in range(2) for j in range(2)])
        q = it["MAI"].create_group("QU4")
        q.create_dataset("NOD", data=(quads.T.ravel() + 1).astype(np.int32))
        q.create_dataset("FAM", data=np.full(4, -1, dtype=np.int32))
        fam = f.create_group("FAS/box/ELEME/FAM_-1_Gauche")
        fam.attrs["NUM"] = np.int32(-1)
        name = np.zeros((1, 80), dtype=np.int8)
        name[0, :6] = np.frombuffer(b"Gauche", dtype=np.int8)
        fam.create_dataset("GRO/NOM", data=name)
    mt, mj = t_read_med(path), j_read_med(path)
    assert_same_mesh(mt, mj)
    assert mt.groups == {"Wall": 1, "Gauche": 2}
    assert (mt.face_group == 2).sum() == 4
    assert np.allclose(mt.face_center[mt.face_group == 2, 0], 0.0)


def test_package_imports_without_h5py():
    """h5py is imported only to read or write a MED file: the package and
    its mesh and io modules import without it, and read_med then raises an
    ImportError that names it."""
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import circulantpreconditioner_tpu_torch\n"
            "import circulantpreconditioner_tpu_torch.io, circulantpreconditioner_tpu_torch.drivers.common\n"
            "from circulantpreconditioner_tpu_torch.mesh import read_med\n"
            "try:\n    read_med('x.med')\nexcept ImportError as e:\n    print('raised:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "raised:" in out.stdout and "h5py" in out.stdout

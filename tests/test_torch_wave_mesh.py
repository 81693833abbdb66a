"""The port's hexahedral mesh generators against the JAX package's.

The JAX package extracts faces with its optional g++ helper when that builds
(numbering them in the order they are first met, cell by cell), else by a
NumPy lexsort (in sorted-key order); the port numbers them as the helper
does. Cells are numbered identically and compared directly; faces are
compared as a set, keyed by their sorted vertex ids, with each face's (L, R)
pair put in ascending order and its normal turned to match, at 1e-14. The
port's numbering is held to a plain first-meeting loop, and, where the JAX
helper builds, the whole mesh to the JAX package's bit for bit."""

import numpy as np
import pytest

from circulantpreconditioner_tpu.mesh import unstructured as ju
from circulantpreconditioner_tpu_torch.mesh import unstructured as tu

TOL = 1e-14
BOUNDS = ((-0.5, 0.5),) * 3


def _canonical_faces(m):
    """Faces sorted by vertex key: (keys, cells (L ≤ R unless R = -1),
    normals outward of the first of those cells, areas, centres)."""
    fv = np.asarray(m.face_vertices if isinstance(m.face_vertices, np.ndarray)
                    else np.array(m.face_vertices), dtype=np.int64)
    key = np.sort(fv, axis=1)
    order = np.lexsort(key.T[::-1])
    fc = m.face_cells[order].copy()
    nrm = m.face_normal[order].copy()
    swap = (fc[:, 1] >= 0) & (fc[:, 1] < fc[:, 0])
    fc[swap] = fc[swap][:, ::-1]
    nrm[swap] = -nrm[swap]
    return key[order], fc, nrm, m.face_area[order], m.face_center[order]


@pytest.mark.parametrize("family", ["hexa", "kershaw"])
@pytest.mark.parametrize("n", [(4, 4, 4), (16, 8, 5)])
def test_generator_matches_jax(family, n):
    if family == "hexa":
        mj, mt = ju.hex_mesh(BOUNDS, n), tu.hex_mesh(BOUNDS, n)
    else:
        mj, mt = ju.kershaw_mesh(BOUNDS, n, eps=0.3), tu.kershaw_mesh(BOUNDS, n, eps=0.3)
    assert mt.topology_shape == mj.topology_shape == n
    assert mt.n_cells == mj.n_cells and mt.n_faces == mj.n_faces and mt.name == mj.name
    np.testing.assert_array_equal(mt.points, mj.points)
    np.testing.assert_array_equal(mt.cell_vertices, np.asarray(mj.cell_vertices))
    np.testing.assert_allclose(mt.cell_volume, mj.cell_volume, rtol=TOL)
    np.testing.assert_allclose(mt.cell_center, mj.cell_center, rtol=0, atol=TOL)
    for a, b in zip(_canonical_faces(mt), _canonical_faces(mj)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    np.testing.assert_array_equal(np.sort(mt.face_group), np.sort(mj.face_group))
    assert mt.groups == mj.groups
    assert abs(mt.min_ratio_vol_surf() - mj.min_ratio_vol_surf()) <= TOL * mj.min_ratio_vol_surf()
    np.testing.assert_allclose(mt.bbox(), mj.bbox(), rtol=0, atol=TOL)


def _first_meeting_faces(cells):
    """Faces numbered as first met, cell by cell and face by face: (vertex
    ids in the order of the first meeting, (first cell, second cell))."""
    index, fv, fc = {}, [], []
    for c, cell in enumerate(np.asarray(cells)):
        for face in tu._HEX_FACES:
            verts = tuple(int(cell[i]) for i in face)
            key = tuple(sorted(verts))
            if key in index:
                fc[index[key]][1] = c
            else:
                index[key] = len(fv)
                fv.append(verts)
                fc.append([c, -1])
    return np.array(fv), np.array(fc)


@pytest.mark.parametrize("n", [(3, 2, 2), (5, 4, 3)])
def test_faces_numbered_by_first_meeting_as_jax(n):
    from circulantpreconditioner_tpu.native import native_available

    mt = tu.kershaw_mesh(BOUNDS, n, eps=0.3)
    fv, fc = _first_meeting_faces(mt.cell_vertices)
    np.testing.assert_array_equal(mt.face_vertices, fv)
    np.testing.assert_array_equal(mt.face_cells, fc)
    if native_available():  # the JAX package's own numbering: every array equal bit for bit
        mj = ju.kershaw_mesh(BOUNDS, n, eps=0.3)
        for name in ("face_cells", "face_vertices", "face_area", "face_normal", "face_center",
                     "face_group", "cell_volume", "cell_center"):
            np.testing.assert_array_equal(getattr(mt, name), np.asarray(getattr(mj, name)))


def test_kershaw_eps_changes_geometry_not_topology():
    a = tu.kershaw_mesh(BOUNDS, (6, 6, 6), eps=0.3)
    b = tu.kershaw_mesh(BOUNDS, (6, 6, 6), eps=1.0)  # eps = 1: no warp
    h = tu.hex_mesh(BOUNDS, (6, 6, 6))
    np.testing.assert_array_equal(a.face_cells, b.face_cells)
    np.testing.assert_allclose(b.cell_volume, h.cell_volume, rtol=1e-13)
    assert np.ptp(a.cell_volume) > 1e-3 * a.cell_volume.mean()
    np.testing.assert_allclose(a.cell_volume.sum(), 1.0, rtol=1e-13)  # volume conserved


def test_polygon_area_normal_center_matches_jax():
    rng = np.random.default_rng(4)
    quad = np.array([[0, 0, 0], [1, 0, 0.1], [1, 1, 0], [0, 1, -0.2]], float)
    quad += 0.05 * rng.normal(size=quad.shape)
    for a, b in zip(tu._polygon_area_normal_center(quad), ju._polygon_area_normal_center(quad)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_non_hex_cells_raise():
    """Cells that are neither hexes nor tets need their face table
    (cell_faces), as in the JAX package; tets take the vectorised path."""
    pts = np.random.default_rng(1).random((6, 3))
    for build in (tu.build_mesh_from_cells, ju.build_mesh_from_cells):
        with pytest.raises(ValueError, match="unsupported vertex count 6"):
            build(pts, [(0, 1, 2, 3, 4, 5)])
    tet = tu.build_mesh_from_cells(np.eye(4, 3), [(0, 1, 2, 3)])
    np.testing.assert_allclose(tet.cell_volume, [1.0 / 6], rtol=1e-14)

"""The port's tet meshes (`tet_mesh`, `kershaw_tet_mesh`) and the generic
`cell_faces` path of `build_mesh_from_cells` against the JAX package
(float64 on the CPU, the same NumPy inputs).

Tolerances: none. The faces are numbered in the order they are first met,
as the JAX package's native face extraction numbers them, and every face
and cell array is equal bit for bit where that extraction is available
(`native_available()`); the generic path is the JAX package's own loop, so
it is equal bit for bit always.
"""

import numpy as np
import pytest

import circulantpreconditioner_tpu.mesh.unstructured as ju
import circulantpreconditioner_tpu_torch.mesh.unstructured as tu
from circulantpreconditioner_tpu.native import native_available

BOUNDS = ((-0.5, 0.5),) * 3
ARRAYS = ("face_cells", "face_vertices", "face_area", "face_normal", "face_center",
          "face_group", "cell_volume", "cell_center")
GEOMETRY = ("face_cells", "face_area", "face_normal", "face_center", "face_group",
            "cell_volume", "cell_center")


def _first_meeting_faces(cells, table):
    """Plain reference of the native extraction: (face vertex ids, -1 padded,
    in the order of the first meeting, (first cell, second cell))."""
    index, fv, fc = {}, [], []
    for c, cell in enumerate(np.asarray(cells)):
        for face in table:
            verts = tuple(int(cell[i]) for i in face) + (-1,) * (4 - len(face))
            key = tuple(sorted(verts))
            if key in index:
                fc[index[key]][1] = c
            else:
                index[key] = len(fv)
                fv.append(verts)
                fc.append([c, -1])
    return np.array(fv), np.array(fc)


@pytest.mark.parametrize("family,n", [("tet_mesh", (3, 2, 4)), ("kershaw_tet_mesh", (5, 5, 5))])
def test_tet_faces_numbered_by_first_meeting_as_jax(family, n):
    mt = getattr(tu, family)(BOUNDS, n)
    fv, fc = _first_meeting_faces(mt.cell_vertices, tu._TET_FACES)
    np.testing.assert_array_equal(mt.face_vertices, fv)
    np.testing.assert_array_equal(mt.face_cells, fc)
    if native_available():  # the JAX package's own numbering: every array equal bit for bit
        mj = getattr(ju, family)(BOUNDS, n)
        for name in ARRAYS:
            np.testing.assert_array_equal(getattr(mt, name), np.asarray(getattr(mj, name)))


@pytest.mark.parametrize("family,n", [("tet_mesh", (3, 2, 4)), ("kershaw_tet_mesh", (4, 3, 5))])
def test_tet_supercell_numbering(family, n):
    """6 tets per hex, hex-major: the supercell grid the stencils read."""
    mt, mj = getattr(tu, family)(BOUNDS, n), getattr(ju, family)(BOUNDS, n)
    assert mt.topology_shape == mj.topology_shape == n
    assert mt.cells_per_site == mj.cells_per_site == 6
    assert mt.name == mj.name and mt.n_cells == 6 * int(np.prod(n))
    np.testing.assert_array_equal(tu._HEX_TO_TETS, ju._HEX_TO_TETS)
    np.testing.assert_array_equal(tu._TET_FACES, ju._TET_FACES)
    assert (mt.cell_volume > 0).all()
    np.testing.assert_allclose(mt.cell_volume.sum(), 1.0, rtol=1e-13)
    if family == "tet_mesh":  # the 6 tets of a site fill its (planar-faced) hex
        np.testing.assert_allclose(mt.cell_volume.reshape(-1, 6).sum(axis=1),
                                   tu.hex_mesh(BOUNDS, n).cell_volume, rtol=1e-12)


def test_kershaw_tet_eps_changes_geometry_not_topology():
    a = tu.kershaw_tet_mesh(BOUNDS, (4, 4, 4), eps=0.3)
    b = tu.kershaw_tet_mesh(BOUNDS, (4, 4, 4), eps=1.0)  # eps = 1: no warp
    t = tu.tet_mesh(BOUNDS, (4, 4, 4))
    np.testing.assert_array_equal(a.face_cells, b.face_cells)
    np.testing.assert_allclose(b.cell_volume, t.cell_volume, rtol=1e-13)
    assert np.ptp(a.cell_volume) > 1e-3 * a.cell_volume.mean()


def _mixed_cells():
    """Two hexes and the 6 tets of each of two more: a mixed mesh."""
    pts, hexes = tu._hex_grid_points_cells(BOUNDS, (2, 2, 1))
    cells = [tuple(int(v) for v in h) for h in hexes[:2]]
    cells += [tuple(int(h[i]) for i in t) for h in hexes[2:] for t in tu._HEX_TO_TETS]
    return pts, cells


def test_mixed_mesh_generic_path_matches_jax():
    pts, cells = _mixed_cells()
    mt, mj = tu.build_mesh_from_cells(pts, cells), ju.build_mesh_from_cells(pts, cells)
    assert mt.face_vertices == mj.face_vertices  # lists of tuples, first-met order
    for name in GEOMETRY:
        np.testing.assert_array_equal(getattr(mt, name), np.asarray(getattr(mj, name)))
    np.testing.assert_allclose(mt.cell_volume.sum(), 1.0, rtol=1e-13)
    assert mt.n_cells == 14 and (mt.cell_volume > 0).all()


def test_cell_faces_path_matches_jax_and_fast_path():
    """Polyhedra given by their faces: a prism split of a hex mesh (each hex
    as two triangular prisms), and hexes given with their own face table."""
    pts, hexes = tu._hex_grid_points_cells(BOUNDS, (3, 2, 2))
    tri_faces = [(0, 2, 1), (3, 4, 5), (0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5)]
    prisms, faces = [], []
    for h in hexes:  # prisms (0,1,2 | 4,5,6) and (0,2,3 | 4,6,7)
        prisms += [tuple(int(h[i]) for i in (0, 1, 2, 4, 5, 6)),
                   tuple(int(h[i]) for i in (0, 2, 3, 4, 6, 7))]
        faces += [tri_faces, tri_faces]
    mt = tu.build_mesh_from_cells(pts, prisms, cell_faces=faces)
    mj = ju.build_mesh_from_cells(pts, prisms, cell_faces=faces)
    for name in GEOMETRY:
        np.testing.assert_array_equal(getattr(mt, name), np.asarray(getattr(mj, name)))
    np.testing.assert_allclose(mt.cell_volume, 1.0 / (2 * 12), rtol=1e-12)
    # hexes with an explicit face table: the generic loop, same faces as the fast path
    cells = [tuple(int(v) for v in h) for h in hexes]
    mg = tu.build_mesh_from_cells(pts, cells, cell_faces=[tu._HEX_FACES] * len(cells))
    mf = tu.build_mesh_from_cells(pts, cells)
    np.testing.assert_array_equal(np.asarray(mg.face_vertices), mf.face_vertices)
    np.testing.assert_array_equal(mg.face_cells, mf.face_cells)
    np.testing.assert_allclose(mg.cell_volume, mf.cell_volume, rtol=1e-13)
    np.testing.assert_allclose(mg.face_area, mf.face_area, rtol=1e-13)


def test_two_dimensional_points_are_lifted():
    """(nV, 2) points get z = 0, as in the JAX package."""
    pts = np.array([[0, 0], [1, 0], [0, 1], [0.3, 0.3]], float)
    mt, mj = tu.build_mesh_from_cells(pts, [(0, 1, 2, 3)]), ju.build_mesh_from_cells(pts, [(0, 1, 2, 3)])
    assert mt.points.shape == (4, 3) and (mt.points[:, 2] == 0).all()
    for name in GEOMETRY:
        np.testing.assert_array_equal(getattr(mt, name), np.asarray(getattr(mj, name)))


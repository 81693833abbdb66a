"""The port's non-conforming interface repair against the JAX package's, on
two unit cubes whose shared x = 1 quad each side splits along a different
diagonal: the same pieces, equal face arrays, the full unit interface
recovered with exact closure. And the port's read_mesh warning where the
file shares its vertices, so the repair is gated off (the JAX package skips
it in silence): the mesh stays equal to the JAX package's."""

import warnings

import numpy as np
import pytest

import circulantpreconditioner_tpu.mesh.conforming as jc
import circulantpreconditioner_tpu.mesh.unstructured as ju
import circulantpreconditioner_tpu_torch.mesh.conforming as tc
import circulantpreconditioner_tpu_torch.mesh.unstructured as tu
from circulantpreconditioner_tpu.mesh import read_mesh as j_read_mesh
from circulantpreconditioner_tpu_torch.mesh import read_mesh as t_read_mesh
from test_torch_mesh_readers import assert_same_mesh, write_typ3

PTS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1],
                [0, 1, 1], [2, 0, 0], [2, 1, 0], [2, 0, 1], [2, 1, 1]], dtype=np.float64)
CELLS = [(0, 1, 2, 3, 4, 5, 6, 7), (1, 2, 8, 9, 5, 6, 10, 11)]
# local faces: the left cube's x+ quad split along 1-6, the right cube's x-
# quad along the other diagonal (globals 2-5)
FACES = [[(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (3, 7, 6, 2), (0, 4, 7, 3), (1, 2, 6), (1, 6, 5)],
         [(0, 1, 3, 2), (4, 6, 7, 5), (0, 2, 6, 4), (1, 5, 7, 3), (2, 3, 7, 6), (0, 1, 4), (1, 5, 4)]]


def two_cubes(mod):
    return mod.build_mesh_from_cells(PTS, CELLS, cell_faces=FACES)


def closure_max(m) -> float:
    acc = np.zeros((m.n_cells, 3))
    np.add.at(acc, m.face_cells[:, 0], m.face_normal * m.face_area[:, None])
    inner = m.face_cells[:, 1] >= 0
    np.add.at(acc, m.face_cells[inner, 1], -(m.face_normal * m.face_area[:, None])[inner])
    return float(np.abs(acc).max())


def test_two_cube_split_repair_matches_jax():
    mt, mj = two_cubes(tu), two_cubes(ju)
    assert int((mt.face_cells[:, 1] >= 0).sum()) == 0  # all four triangles unmatched
    assert tc.count_nonconforming_pairs(mt) == 4
    assert_same_mesh(mt, mj)  # counting changed nothing
    with pytest.warns(UserWarning, match="non-conforming interface repair") as wt:
        nt = tc.match_nonconforming_faces(mt)
    with pytest.warns(UserWarning) as wj:
        nj = jc.match_nonconforming_faces(mj)
    assert nt == nj >= 2
    assert str(wt[0].message) == str(wj[0].message)
    assert_same_mesh(mt, mj)
    assert (mt.nonconforming_pieces, mt.nonconforming_dropped_area) == (
        mj.nonconforming_pieces, mj.nonconforming_dropped_area)
    inner = mt.face_cells[:, 1] >= 0
    np.testing.assert_allclose(mt.face_area[inner].sum(), 1.0, rtol=1e-12)
    assert closure_max(mt) < 1e-12
    mt.validate()


def test_conforming_mesh_has_no_candidates():
    m = tu.kershaw_mesh(((0, 1),) * 3, (3, 3, 3))
    assert tc.count_nonconforming_pairs(m) == 0
    assert tc.match_nonconforming_faces(m) == 0


def test_read_mesh_warns_where_the_repair_is_gated_off(tmp_path):
    """The two cubes as a typ3 file, with their vertices shared: nothing is
    welded, so read_mesh does not repair (as in the JAX package), but the
    port warns with the count of the pairs it leaves as boundary."""
    m = two_cubes(tu)
    path = write_typ3(tmp_path / "cubes.typ3", PTS, CELLS, m.face_vertices, m.face_cells)
    with pytest.warns(UserWarning, match="4 pairs of opposing boundary faces"):
        mt = t_read_mesh(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the JAX package is silent
        mj = j_read_mesh(path)
    assert_same_mesh(mt, mj)
    assert int((mt.face_cells[:, 1] >= 0).sum()) == 0


def test_read_mesh_silent_on_a_conforming_file(tmp_path):
    m = tu.kershaw_mesh(((0, 1),) * 3, (2, 2, 2))
    fv = [tuple(int(v) for v in r) for r in m.face_vertices]
    path = write_typ3(tmp_path / "k.typ3", m.points, m.cell_vertices, fv, m.face_cells)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mt = t_read_mesh(path)
    assert mt.topology_shape == (2, 2, 2)

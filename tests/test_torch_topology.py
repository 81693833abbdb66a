"""The port's grid-topology recovery, RCM renumbering and permute_cells
against the JAX package's, on meshes read from the same Gmsh files and on
generated meshes: the permutations, `topology_shape` and every mesh array
equal bit for bit."""

import numpy as np
import pytest

import circulantpreconditioner_tpu.mesh.topology as jt
import circulantpreconditioner_tpu.mesh.unstructured as ju
import circulantpreconditioner_tpu_torch.mesh.topology as tt
import circulantpreconditioner_tpu_torch.mesh.unstructured as tu
from test_torch_mesh_readers import CUBE, assert_same_mesh, duplicated_vertices, write_gmsh


def _both(path):
    return tu.read_gmsh(path), ju.read_gmsh(path)


def test_recover_grid_topology_on_shuffled_kershaw_file(tmp_path):
    m = tu.kershaw_mesh(CUBE, (6, 5, 4))
    mt, mj = _both(write_gmsh(tmp_path / "k.msh", m.points, m.cell_vertices, seed=3))
    assert tt.recover_grid_topology(mt) and jt.recover_grid_topology(mj)
    assert mt.topology_shape == mj.topology_shape == (6, 5, 4)
    assert np.array_equal(mt.cell_permutation, mj.cell_permutation)
    assert not np.array_equal(mt.cell_permutation, np.arange(mt.n_cells))  # really shuffled
    assert_same_mesh(mt, mj)
    # the recovered numbering is the generator's: the same cells in the same place
    assert np.array_equal(mt.cell_center, m.cell_center)
    assert np.array_equal(mt.cell_volume[np.argsort(mt.cell_permutation)],
                          mj.cell_volume[np.argsort(mj.cell_permutation)])


def test_renumber_bandwidth_matches_jax(tmp_path):
    """A welded Kershaw-tet file has no grid: RCM order, equal to JAX's."""
    m = tu.kershaw_tet_mesh(CUBE, (4, 3, 3))
    pts, cells = duplicated_vertices(m.points, m.cell_vertices)
    mt, mj = _both(write_gmsh(tmp_path / "kt.msh", pts, cells))
    assert not tt.recover_grid_topology(mt) and not jt.recover_grid_topology(mj)
    assert tt.renumber_bandwidth(mt) and jt.renumber_bandwidth(mj)
    assert mt.bandwidth_ordered and np.array_equal(mt.cell_permutation, mj.cell_permutation)
    assert_same_mesh(mt, mj)
    bw = lambda x: int(np.abs(x.face_cells[x.face_cells[:, 1] >= 0] @ [1, -1]).max())  # noqa: E731
    assert bw(mt) < bw(m)


def test_permute_cells_composes(tmp_path):
    """Two permutations in a row: cell_permutation is their composition
    (orig_of_new), with the port's ndarray cell_vertices and the JAX
    package's list of tuples."""
    m = tu.kershaw_mesh(CUBE, (3, 3, 2))
    mt, mj = _both(write_gmsh(tmp_path / "k.msh", m.points, m.cell_vertices))
    rng = np.random.default_rng(5)
    p1, p2 = rng.permutation(mt.n_cells), rng.permutation(mt.n_cells)
    for mesh, mod in ((mt, tt), (mj, jt)):
        mod.permute_cells(mesh, p1)
        mod.permute_cells(mesh, p2)
    assert_same_mesh(mt, mj)
    orig_of_new = np.argsort(p1)[np.argsort(p2)]
    assert np.array_equal(mt.cell_permutation, orig_of_new)
    assert np.array_equal(mt.cell_center, m.cell_center[orig_of_new])
    assert np.array_equal(mt.cell_vertices, m.cell_vertices[orig_of_new])


@pytest.mark.parametrize("gen", ["hex_mesh", "kershaw_mesh"])
def test_recovery_is_idempotent_on_generated_meshes(gen):
    """A generated grid, its tag removed, is recovered in its own order:
    the identity permutation and unchanged arrays; a second call is a no-op."""
    mt, mj = getattr(tu, gen)(CUBE, (4, 3, 5)), getattr(ju, gen)(CUBE, (4, 3, 5))
    ref = {a: getattr(mt, a).copy() for a in ("cell_center", "cell_volume", "face_cells")}
    for mesh, mod in ((mt, tt), (mj, jt)):
        mesh.topology_shape = None
        assert mod.recover_grid_topology(mesh) and mesh.topology_shape == (4, 3, 5)
        assert mod.recover_grid_topology(mesh)
    assert np.array_equal(mt.cell_permutation, np.arange(mt.n_cells))
    for a, v in ref.items():
        assert np.array_equal(getattr(mt, a), v), a
    assert_same_mesh(mt, mj)


def test_non_grid_mesh_untouched():
    mt, mj = tu.tet_mesh(CUBE, (2, 2, 3)), ju.tet_mesh(CUBE, (2, 2, 3))
    ref = {a: getattr(mt, a).copy() for a in ("cell_center", "face_cells")}
    for mesh, mod in ((mt, tt), (mj, jt)):
        mesh.topology_shape = None
        assert not mod.recover_grid_topology(mesh)
        assert getattr(mesh, "cell_permutation", None) is None
    for a, v in ref.items():
        assert np.array_equal(getattr(mt, a), v), a
    assert_same_mesh(mt, mj)

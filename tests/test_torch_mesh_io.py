"""The port's VTK and MED writers against the JAX package's: the VTK text
equal for cartesian, hexahedral and tetrahedral meshes; MED files written by
either package read by the other (mesh and field series); med_cell_order
equal; and the drivers' --vtk and --med series written."""

import os

import numpy as np
import pytest

import circulantpreconditioner_tpu.mesh.unstructured as ju
import circulantpreconditioner_tpu_torch.mesh.unstructured as tu
from circulantpreconditioner_tpu.io import med_cell_order as j_order
from circulantpreconditioner_tpu.io import read_med_field as j_read_field
from circulantpreconditioner_tpu.io import write_med as j_write_med
from circulantpreconditioner_tpu.io import write_vtk as j_write_vtk
from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.mesh import read_med as j_read_med
from circulantpreconditioner_tpu_torch.io import med_cell_order as t_order
from circulantpreconditioner_tpu_torch.io import read_med_field as t_read_field
from circulantpreconditioner_tpu_torch.io import write_med as t_write_med
from circulantpreconditioner_tpu_torch.io import write_vtk as t_write_vtk
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_cartesian
from circulantpreconditioner_tpu_torch.mesh import read_med as t_read_med
from test_torch_mesh_readers import CUBE, assert_same_mesh, mixed_mesh

MESHES = {
    "cartesian": (lambda: t_cartesian(CUBE, (3, 2, 4)), lambda: j_cartesian(CUBE, (3, 2, 4))),
    "cartesian2d": (lambda: t_cartesian(CUBE[:2], (5, 3)), lambda: j_cartesian(CUBE[:2], (5, 3))),
    "kershaw": (lambda: tu.kershaw_mesh(CUBE, (3, 2, 2)), lambda: ju.kershaw_mesh(CUBE, (3, 2, 2))),
    "tet": (lambda: tu.tet_mesh(CUBE, (2, 2, 1)), lambda: ju.tet_mesh(CUBE, (2, 2, 1))),
}


def _fields(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    return {"pressure": rng.standard_normal(n), "velocity": rng.standard_normal((n, dim)),
            "pair": rng.standard_normal((n, 2)).astype(np.float32)}


@pytest.mark.parametrize("kind", list(MESHES))
def test_write_vtk_text_matches_jax(tmp_path, kind):
    mt, mj = (f() for f in MESHES[kind])
    fields = _fields(mt.n_cells, mt.dim)
    pt = t_write_vtk(str(tmp_path / "t" / "a.vtk"), mt, fields, time=0.25)
    pj = j_write_vtk(str(tmp_path / "j" / "a.vtk"), mj, fields, time=0.25)
    text = open(pt).read()
    assert text == open(pj).read()
    header = "DATASET STRUCTURED_POINTS" if kind.startswith("cartesian") else (
        f"CELLS {mt.n_cells} ")
    assert header in text and f"CELL_DATA {mt.n_cells}\n" in text


@pytest.mark.parametrize("kind", ["cartesian", "cartesian2d", "kershaw", "tet"])
def test_med_written_by_each_package_is_read_by_the_other(tmp_path, kind):
    """Two time steps of two fields through write_med (first call and
    append); the mesh read back by both readers, the series by both
    read_med_field."""
    mt, mj = (f() for f in MESHES[kind])
    mt.name = mj.name = "m"
    f0, f1 = _fields(mt.n_cells, mt.dim, 1), _fields(mt.n_cells, mt.dim, 2)
    for name, (mesh, write) in {"t": (mt, t_write_med), "j": (mj, j_write_med)}.items():
        path = str(tmp_path / f"{name}.med")
        write(path, mesh, f0, time=0.0, it=0)
        write(path, mesh, f1, time=0.5, it=1, append=True)
    for path in (str(tmp_path / "t.med"), str(tmp_path / "j.med")):
        assert_same_mesh(t_read_med(path), j_read_med(path))
        for field in f0:
            st, sj = t_read_field(path, field), j_read_field(path, field)
            assert [(i, t) for i, t, _ in st] == [(i, t) for i, t, _ in sj] == [(0, 0.0), (1, 0.5)]
            for (_, _, vt), (_, _, vj), ref in zip(st, sj, (f0[field], f1[field])):
                assert np.array_equal(vt, vj)
                assert np.array_equal(vt, ref.astype(np.float64).reshape(len(ref), -1))


def test_med_cell_order_matches_jax(tmp_path):
    """The mixed mesh's blocks (TE4, PY5, HE8) and a homogeneous mesh."""
    m = mixed_mesh()
    assert np.array_equal(t_order(m), j_order(m)) and list(t_order(m)) == [1, 0, 2]
    vals = np.random.default_rng(3).random((m.n_cells, 2))
    t_write_med(str(tmp_path / "mixed.med"), m, {"U": vals})
    (_, _, back), = j_read_field(str(tmp_path / "mixed.med"), "U")
    assert np.array_equal(back, vals[t_order(m)])
    mt, mj = (f() for f in MESHES["tet"])
    assert np.array_equal(t_order(mt), j_order(mj))
    assert np.array_equal(t_order(mt), np.arange(mt.n_cells))


def test_write_med_rejects_wrong_sizes_and_repeated_steps(tmp_path):
    mt = MESHES["kershaw"][0]()
    path = str(tmp_path / "k.med")
    with pytest.raises(ValueError, match="values for"):
        t_write_med(path, mt, {"u": np.zeros(mt.n_cells + 1)})
    t_write_med(path, mt, {"u": np.zeros(mt.n_cells)}, it=3)
    with pytest.raises(ValueError, match="already written"):
        t_write_med(path, mt, {"u": np.zeros(mt.n_cells)}, it=3, append=True)


@pytest.mark.parametrize("driver,argv,field", [
    ("wave_explicit", ["--mesh-family", "kershaw", "4", "4", "4"], "pressure"),
    ("transport_fft", ["6", "6", "6"], "temperature"),
])
def test_driver_writes_vtk_and_med_series(tmp_path, driver, argv, field):
    """--vtk and --med, 3 steps at --output-freq 1: one VTK file a step with
    the cell count in its header, and one MED series of 3 steps, equal to
    the final state at its last step."""
    import importlib

    mod = importlib.import_module(f"circulantpreconditioner_tpu_torch.drivers.{driver}")
    res = mod.main(argv + ["--vtk", "--med", "--output-freq", "1", "--ntmax", "3", "--tmax",
                           "1e9", "--f64", "--device", "cpu", "--result-dir", str(tmp_path)])
    vtk = sorted(f for f in os.listdir(tmp_path) if f.endswith(".vtk"))
    med = [f for f in os.listdir(tmp_path) if f.endswith(".med")]
    assert len(vtk) == 3 and len(med) == 1
    n = res.state.numel() // (4 if driver == "wave_explicit" else 1)
    for f in vtk:
        assert f"CELL_DATA {n}\n" in open(tmp_path / f).read()
    series = t_read_field(str(tmp_path / med[0]), field)
    assert [it for it, _, _ in series] == [1, 2, 3]
    final = res.state.numpy().reshape(n, -1)[:, 0]
    assert np.array_equal(series[-1][2][:, 0], final)

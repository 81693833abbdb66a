"""The port's drivers on mesh files (`--device cpu --f64`) against the JAX
drivers on the same files: the same steps, the same GMRES iterations in
every step, final states within 1e-10 × max|U|.

- path D from a Gmsh file: Kershaw 8³ with shuffled cells, whose grid
  read_mesh recovers, under --pc gridmg;
- the FFT projection PC on an unstructured file: Kershaw-tet with each
  cell's vertices duplicated (welded, no grid, RCM order, the window SpMV),
  under --pc circulant2l;
- transport_implicit --pc circulant and diffusion_implicit on a Kershaw
  file, and transport_fft refusing it (it needs a cartesian mesh);
- wave_explicit on a 2D MED file (the reference's 2D `.med` branch).
"""

import numpy as np
import pytest

from circulantpreconditioner_tpu.drivers import diffusion_implicit as j_diff
from circulantpreconditioner_tpu.drivers import transport_fft as j_fft
from circulantpreconditioner_tpu.drivers import transport_implicit as j_trans
from circulantpreconditioner_tpu.drivers import wave_explicit as j_exp
from circulantpreconditioner_tpu.drivers import wave_implicit as j_imp
from circulantpreconditioner_tpu.io import write_med as j_write_med
from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu_torch.drivers import diffusion_implicit as t_diff
from circulantpreconditioner_tpu_torch.drivers import transport_fft as t_fft
from circulantpreconditioner_tpu_torch.drivers import transport_implicit as t_trans
from circulantpreconditioner_tpu_torch.drivers import wave_explicit as t_exp
from circulantpreconditioner_tpu_torch.drivers import wave_implicit as t_imp
from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh, kershaw_tet_mesh, read_mesh
from test_torch_mesh_readers import CUBE, duplicated_vertices, write_gmsh


def _args(tmp_path, extra, ntmax=2):
    return extra + ["--tmax", "1e9", "--ntmax", str(ntmax), "--f64", "--result-dir",
                    str(tmp_path)]


def _same(rt, rj):
    assert rt.iterations == rj.iterations
    uj = np.asarray(rj.state)
    np.testing.assert_allclose(rt.state.numpy(), uj, rtol=0, atol=1e-10 * np.abs(uj).max())
    its = lambda r: [d["extras"][0] for d in r.diagnostics if d["extras"]]  # noqa: E731
    assert its(rt) == its(rj)
    return its(rt)


def test_wave_implicit_gridmg_from_shuffled_kershaw_file(tmp_path, capsys):
    m = kershaw_mesh(CUBE, (8, 8, 8))
    path = write_gmsh(tmp_path / "kershaw8.msh", m.points, m.cell_vertices, seed=8)
    argv = _args(tmp_path, [path, "--pc", "gridmg"])
    rt = t_imp.main(argv + ["--device", "cpu"])
    assert "field-major GMRES loop" in capsys.readouterr().out  # the recovered grid's route
    its = _same(rt, j_imp.main(argv))
    assert len(its) == 2 and all(d["extras"][2] for d in rt.diagnostics)


def test_wave_implicit_circulant2l_from_welded_kershaw_tet_file(tmp_path, capsys):
    m = kershaw_tet_mesh(CUBE, (4, 4, 4))
    path = write_gmsh(tmp_path / "kershawtet4.msh", *duplicated_vertices(m.points,
                                                                        m.cell_vertices))
    mesh = read_mesh(path)
    assert mesh.welded_nodes and mesh.bandwidth_ordered
    assert getattr(mesh, "topology_shape", None) is None
    argv = _args(tmp_path, [path, "--pc", "circulant2l"])
    rt = t_imp.main(argv + ["--device", "cpu"])
    assert "field-major" not in capsys.readouterr().out  # no grid: cell-major, window SpMV
    its = _same(rt, j_imp.main(argv))
    assert len(its) == 2 and all(d["extras"][2] for d in rt.diagnostics)


def test_transport_implicit_circulant_from_kershaw_file(tmp_path):
    m = kershaw_mesh(CUBE, (6, 6, 6))
    path = write_gmsh(tmp_path / "kershaw6.msh", m.points, m.cell_vertices, seed=6)
    argv = _args(tmp_path, [path, "--pc", "circulant"], ntmax=3)
    rt = t_trans.main(argv + ["--device", "cpu"])
    _same(rt, j_trans.main(argv))
    assert all(d["extras"][2] for d in rt.diagnostics)


@pytest.mark.parametrize("method", ["pc", "cg"])
def test_diffusion_implicit_from_kershaw_file(tmp_path, method):
    m = kershaw_mesh(CUBE, (6, 6, 6))
    path = write_gmsh(tmp_path / "kershaw6.msh", m.points, m.cell_vertices, seed=6)
    argv = _args(tmp_path, [path, "--method", method])
    rt = t_diff.main(argv + ["--device", "cpu"])
    _same(rt, j_diff.main(argv))
    assert all(d["extras"][2] for d in rt.diagnostics)


def test_transport_fft_refuses_a_mesh_file(tmp_path):
    m = kershaw_mesh(CUBE, (3, 3, 3))
    path = write_gmsh(tmp_path / "kershaw3.msh", m.points, m.cell_vertices)
    for main in (t_fft.main, j_fft.main):
        with pytest.raises(SystemExit, match="requires a cartesian mesh"):
            main(_args(tmp_path, [path]) + (["--device", "cpu"] if main is t_fft.main else []))


@pytest.mark.parametrize("option", ["positional", "--msh"])
def test_wave_explicit_from_file(tmp_path, option):
    """A Gmsh file given positionally or by --msh (read_gmsh, then grid
    recovery): the recovered grid's field-major loop, as from the JAX
    driver."""
    m = kershaw_mesh(CUBE, (5, 4, 3))
    path = write_gmsh(tmp_path / "k.msh", m.points, m.cell_vertices, seed=2)
    argv = _args(tmp_path, [path] if option == "positional" else ["--msh", path], ntmax=4)
    _same(t_exp.main(argv + ["--device", "cpu"]), j_exp.main(argv))


def test_wave_explicit_from_2d_med_file(tmp_path):
    """The counterpart of tests/test_med_io.py's 2D driver run: a 6×6 square
    written by the JAX package's write_med, read by the ESP = 2 branch."""
    m = j_cartesian(((0.0, 1.0), (0.0, 1.0)), (6, 6))
    m.name = "square2d"
    path = str(tmp_path / "square2d.med")
    j_write_med(path, m, {"p": np.ones(m.n_cells)}, time=0.0, it=0)
    argv = _args(tmp_path, [path], ntmax=3)
    rt = t_exp.main(argv + ["--device", "cpu"])
    _same(rt, j_exp.main(argv))
    assert rt.state.shape == (36 * 3,) and np.isfinite(rt.state.numpy()).all()

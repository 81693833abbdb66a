"""The port's wave drivers (`--device cpu --f64`) against the JAX drivers on
the same command lines, every --pc of the implicit driver but the direct
solves (tested in test_torch_circulant_pc.py):
the same step count, the same GMRES iterations in every step, and final
states within 1e-10 × max|U|. GMRES without a
preconditioner runs at --cfl 10 on the Kershaw mesh: at the default cfl
1e3/3 it amplifies roundoff past any such bound (see
test_torch_wave_model.py). On the tet meshes (--mesh-family tetra|kershawtet)
both of the port's drivers run the field-major block-sparse supercell loop;
the JAX implicit driver runs cell-major GMRES over the dense supercell
stencil with the grid V-cycle's cell-major apply, and the two agree as on
the other meshes (tests/test_torch_tet_field_major.py holds the route to
the benchmark's float64 reference). Also the CLI repairs:
--kershaw-eps, make_output_cb(split=...) and its writers, --msh and the mesh
families."""

import argparse

import numpy as np
import pytest

from circulantpreconditioner_tpu.drivers import common as j_common
from circulantpreconditioner_tpu.drivers import wave_explicit as j_exp
from circulantpreconditioner_tpu.drivers import wave_implicit as j_imp
from circulantpreconditioner_tpu_torch.drivers import common as t_common
from circulantpreconditioner_tpu_torch.drivers import wave_explicit as t_exp
from circulantpreconditioner_tpu_torch.drivers import wave_implicit as t_imp

KERSHAW = ["--mesh-family", "kershaw", "6", "6", "6"]
CART = ["8", "8"]


def _args(tmp_path, extra, ntmax=3):
    return extra + ["--tmax", "1e9", "--ntmax", str(ntmax), "--f64",
                    "--result-dir", str(tmp_path)]


def _same(rt, rj):
    assert rt.iterations == rj.iterations
    uj = np.asarray(rj.state)
    np.testing.assert_allclose(rt.state.numpy(), uj, rtol=0, atol=1e-10 * np.abs(uj).max())
    its = lambda r: [d["extras"][0] for d in r.diagnostics if d["extras"]]  # noqa: E731
    assert its(rt) == its(rj)


@pytest.mark.parametrize("mesh", [KERSHAW, CART])
def test_wave_explicit_driver_matches_jax(tmp_path, mesh):
    argv = _args(tmp_path, mesh, ntmax=5)
    _same(t_exp.main(argv + ["--device", "cpu"]), j_exp.main(argv))


@pytest.mark.parametrize("mesh", [KERSHAW, CART])
@pytest.mark.parametrize("pc", ["gridmg", "pbjacobi", "none", "ilu0", "bjacobi", "aggvcycle"])
def test_wave_implicit_driver_matches_jax(tmp_path, mesh, pc):
    extra = ["--cfl", "10"] if pc == "none" and mesh is KERSHAW else []
    argv = _args(tmp_path, mesh + ["--pc", pc] + extra, ntmax=2)
    rt = t_imp.main(argv + ["--device", "cpu"])
    _same(rt, j_imp.main(argv))
    assert all(d["extras"][2] for d in rt.diagnostics)  # GMRES converged every step


def test_default_pc_is_ilu0_and_matches_jax(tmp_path, capsys):
    """With no --pc the driver runs GMRES + ILU(0), the reference's
    sequential solver, as the JAX driver does."""
    argv = _args(tmp_path, KERSHAW, ntmax=2)
    rt = t_imp.main(argv + ["--device", "cpu"])
    assert "pc=ilu0" in capsys.readouterr().out
    _same(rt, j_imp.main(argv))
    _same(rt, t_imp.main(argv + ["--device", "cpu", "--pc", "ilu0"]))


def test_shard_rows_raises_naming_its_item(tmp_path):
    """--shard rows runs (tests/test_torch_parallel_drivers.py) with --pc
    none, pbjacobi and circulant2l; any other --pc, ilu0 the default among
    them, exits naming those three, as the JAX driver does. The pencil
    decomposition is transport_fft's alone: --shard pencil is refused."""
    with pytest.raises(SystemExit, match=r"supports --pc none\|pbjacobi\|circulant2l"):
        t_imp.main(_args(tmp_path, CART + ["--shard", "rows", "--device", "cpu"]))
    with pytest.raises(SystemExit):
        t_imp.main(_args(tmp_path, CART + ["--shard", "pencil", "--pq", "3", "1",
                                          "--device", "cpu"]))


@pytest.mark.parametrize("extra", [["--shard", "slab"], ["--shard", "pencil", "--pq", "3", "1"]])
def test_wave_explicit_unported_options_raise(tmp_path, extra):
    """What still raises: --shard slab on a mesh with no grid topology (an
    RCM-ordered tet file), as in the JAX driver, and --shard pencil, which
    only transport_fft has."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from test_torch_mesh_readers import write_gmsh

    mt = kershaw_tet_mesh(((-0.5, 0.5),) * 3, (2, 2, 2))
    path = write_gmsh(tmp_path / "kt2.msh", mt.points, mt.cell_vertices)
    match = "topologically structured" if extra[1] == "slab" else None
    with pytest.raises(SystemExit, match=match):
        t_exp.main(_args(tmp_path, [path, "--device", "cpu"] + extra))


def test_wave_explicit_msh_option_matches_jax(tmp_path):
    """--msh (once raising, now ported): a Kershaw 4³ Gmsh file, read and
    its grid recovered, stepped as the JAX driver steps it."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from test_torch_mesh_readers import write_gmsh

    m = kershaw_mesh(((-0.5, 0.5),) * 3, (4, 4, 4))
    path = write_gmsh(tmp_path / "k4.msh", m.points, m.cell_vertices, seed=4)
    argv = _args(tmp_path, ["--msh", path], ntmax=5)
    rt = t_exp.main(argv + ["--device", "cpu"])
    _same(rt, j_exp.main(argv))
    U_gen = t_exp.main(_args(tmp_path, KERSHAW[:2] + ["4", "4", "4", "--device", "cpu"],
                             ntmax=5)).state
    # the recovered grid is the generator's, its faces in the file's order
    np.testing.assert_allclose(rt.state.numpy(), U_gen.numpy(), rtol=0,
                               atol=1e-12 * np.abs(U_gen.numpy()).max())


def test_kershaw_eps_option(tmp_path):
    """The repaired --kershaw-eps: the JAX default, and passed to the mesh."""
    jp = j_common.base_parser("x").parse_args([])
    tp = t_common.base_parser("x").parse_args([])
    assert tp.kershaw_eps == jp.kershaw_eps == 0.3
    argv = ["--mesh-family", "kershaw", "5", "4", "3", "--kershaw-eps", "0.6"]
    mj = j_common.build_mesh(j_common.base_parser("x").parse_args(argv))
    mt = t_common.build_mesh(t_common.base_parser("x").parse_args(argv))
    assert mt.name == mj.name == "kershaw_5x4x3"
    np.testing.assert_allclose(mt.cell_volume, mj.cell_volume, rtol=1e-14)
    mt3 = t_common.build_mesh(t_common.base_parser("x").parse_args(argv[:-1] + ["0.3"]))
    assert np.abs(mt3.cell_volume - mt.cell_volume).max() > 1e-3 * mt.cell_volume.mean()


@pytest.mark.parametrize("argv,name,shape", [
    (["--mesh-family", "hexa", "4", "3", "2"], "hexa_4x3x2", (4, 3, 2)),
    (["--mesh-family", "kershaw", "4"], "kershaw_4x4x4", (4, 4, 4)),
    (["--mesh-family", "hexa", "5", "3"], "hexa_5x3x3", (5, 3, 3)),
    (["--mesh-family", "tetra", "3", "2", "4"], "tetra_3x2x4", (3, 2, 4)),
    (["--mesh-family", "kershawtet", "4", "3"], "kershawtet_4x3x3", (4, 3, 3))])
def test_build_mesh_families(argv, name, shape):
    mj = j_common.build_mesh(j_common.base_parser("x").parse_args(argv))
    mt = t_common.build_mesh(t_common.base_parser("x").parse_args(argv))
    assert mt.name == mj.name == name and mt.topology_shape == mj.topology_shape == shape
    assert mt.n_cells == mj.n_cells and mt.n_faces == mj.n_faces
    np.testing.assert_allclose(mt.cell_volume, mj.cell_volume, rtol=1e-14)


def test_make_output_cb_split_and_checkpoint(tmp_path):
    """The repaired make_output_cb(split=...): the wave drivers pass their
    model's split_fields, and a checkpoint holds the cell-major state that
    the field-major loop unpacks."""
    from circulantpreconditioner_tpu_torch.io import load_checkpoint

    args = argparse.Namespace(vtk=False, med=False, result_dir=str(tmp_path),
                              checkpoint_freq=1)
    mesh = t_common.build_mesh(t_common.base_parser("x").parse_args(CART))
    cb = t_common.make_output_cb(args, mesh, split=lambda U: (U, U), prefix="wave")
    cb(1, 0.5, np.arange(4.0), [])
    state, t, it, _ = load_checkpoint(str(tmp_path / "cartesian_8x8_ckpt.npz"))
    assert it == 1 and t == 0.5 and np.array_equal(state, np.arange(4.0))
    res = t_exp.main(_args(tmp_path, CART + ["--device", "cpu", "--checkpoint-freq", "1"]))
    state, t, it, _ = load_checkpoint(str(tmp_path / "cartesian_8x8_ckpt.npz"))
    assert it == res.iterations and np.array_equal(state, res.state.numpy())
    # the writers (item 23b, once raising): split's pressure and velocity
    args.vtk = args.med = True
    args.checkpoint_freq = 0
    U = np.arange(mesh.n_cells * 3.0)
    cb = t_common.make_output_cb(args, mesh, split=lambda U: (U[0::3], U.reshape(-1, 3)[:, 1:]),
                                 prefix="wave")
    cb(2, 0.75, U, [])
    from circulantpreconditioner_tpu_torch.io import read_med_field

    (it, t, p), = read_med_field(str(tmp_path / "cartesian_8x8_wave.med"), "pressure")
    assert (it, t) == (2, 0.75) and np.array_equal(p[:, 0], U[0::3])
    (_, _, v), = read_med_field(str(tmp_path / "cartesian_8x8_wave.med"), "velocity")
    assert np.array_equal(v, U.reshape(-1, 3)[:, 1:])
    text = open(tmp_path / "cartesian_8x8_wave_000002.vtk").read()
    assert "SCALARS pressure double 1" in text and "VECTORS velocity double" in text


def test_tet_implicit_gridmg_driver_matches_jax(tmp_path, capsys):
    """wave_implicit --pc gridmg on Kershaw-tet 6³: the port's field-major
    GMRES over the block-sparse supercell stencil and the V-cycle's
    field-major apply against the JAX driver's cell-major route."""
    argv = _args(tmp_path, ["--mesh-family", "kershawtet", "6", "6", "6", "--pc", "gridmg"],
                 ntmax=2)
    rt = t_imp.main(argv + ["--device", "cpu"])
    assert "-- field-major GMRES loop" in capsys.readouterr().out
    rj = j_imp.main(argv)
    assert "field-major" not in capsys.readouterr().out
    _same(rt, rj)
    assert all(d["extras"][2] for d in rt.diagnostics)


def test_tet_explicit_driver_matches_jax(tmp_path, capsys):
    """wave_explicit on tetra 4³: the field-major supercell loop in both."""
    argv = _args(tmp_path, ["--mesh-family", "tetra", "4", "4", "4"], ntmax=5)
    rt = t_exp.main(argv + ["--device", "cpu"])
    assert "-- field-major stencil loop" in capsys.readouterr().out
    _same(rt, j_exp.main(argv))

"""The wave system's field-major route on the Kershaw-tetra meshes (6 tets a
grid site, the field view (24, nSites)) on the CPU in float64, against the
plain reference of the benchmark (portbench/reference: the frozen Kershaw-tet
geometry and upwind assembly in SciPy, no JAX) and against the port's own
cell-major route:

- the field-major implicit matvec is the reference's assembled I + D;
- pbjacobi_fm on the site view is the cell-major pbjacobi, and so is the
  cell-major one wrapped by cell_major_adapter with the model's fm_block;
- one implicit step through wave_implicit's field-major loop, for --pc none,
  pbjacobi, gridmg and dct2lm, takes the cell-major route's iterations and
  state, and the reference's answer.

Tolerances. The matvec: 1e-12 × max|y| (the two operators agree to 1e-13,
and the supercell apply sums in another order). The steps run GMRES to
rtol = atol = 1e-12 and the reference to a relative residual of 1e-11: their
answers lie 1.2e-10 apart (relative 2-norm), so STEP_TOL = 1e-8 leaves 80×
room, while the reference's TF32 control, the precision next below float32,
reads 3.7e-4 on the same request and fails it (the last test). The port's
two routes: the same iterations, states within 1e-10 relative. The steps run
at cfl 10: at the driver's 1e3/3 dct2lm does not converge on this mesh in
1000 iterations (in the JAX package's cell-major driver either), and
pbjacobi needs more than 1000 at rtol 1e-12.
"""

from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch

from circulantpreconditioner_tpu_torch.drivers import wave_implicit as t_imp
from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
from circulantpreconditioner_tpu_torch.models import WaveSystem, run_time_loop
from circulantpreconditioner_tpu_torch.ops.stencil import SupercellNormalOperator
from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
from portbench.reference.checks import errors, implicit_solutions
from portbench.reference.control import implicit_tf32
from portbench.reference.operators import implicit_operator

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
BOUNDS = ((-0.5, 0.5),) * 3
N, CFL, RTOL = 6, 10.0, 1e-12
STEP_TOL = 1e-8


def _config(n, cfl):
    return {"model": "wave", "c0": 700.0, "cfl": cfl,
            "mesh": {"family": "kershawtet", "n": list(n), "eps": 0.3,
                     "bounds": [list(b) for b in BOUNDS]}}


def _model(n, cfl=CFL):
    return WaveSystem(kershaw_tet_mesh(BOUNDS, tuple(n), eps=0.3), cfl=cfl, **F64)


def _close(x, ref, tol):
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("n", [(4, 4, 4), (6, 5, 4)])
def test_field_major_matvec_is_the_references_operator(n):
    A, dt = implicit_operator(_config(n, 1e3 / 3), "wall")
    model = _model(n, 1e3 / 3)
    assert dt == pytest.approx(model.dt, rel=1e-13)
    assert isinstance(model.divergence_op().__self__, SupercellNormalOperator)
    x = np.random.default_rng(sum(n)).standard_normal(A.shape[0])
    g = model.pack_fm(torch.as_tensor(x)).reshape(-1)
    assert g.numel() == 24 * int(np.prod(n))
    y = model.unpack_fm(model.implicit_matvec_fm()(g))
    _close(y, A @ x, 1e-12)
    _close(model.implicit_matvec()(torch.as_tensor(x)), A @ x, 1e-12)


def test_pbjacobi_fm_on_the_site_view_is_the_cell_major_pbjacobi():
    model = _model((4, 3, 5))
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(model.mesh.n_cells * 4))
    z_cm = pcs.pbjacobi(model.divergence, shift=1.0)(x)
    g = model.pack_fm(x).reshape(-1)
    z_fm = pcs.pbjacobi_fm(model.divergence, shift=1.0, cells_per_site=6)(g)
    _close(model.unpack_fm(z_fm), z_cm, 1e-15)
    z_ad = pcs.cell_major_adapter(pcs.pbjacobi(model.divergence, shift=1.0), model.fm_block)(g)
    _close(model.unpack_fm(z_ad), z_cm, 0.0)


@pytest.fixture(scope="module")
def reference():
    """The reference's operator, the request (the driver's initial state)
    and its float64 answer."""
    A, _ = implicit_operator(_config((N,) * 3, CFL), "wall")
    u0 = _model((N,) * 3).initial_state().numpy()[:, None]
    return A, u0, implicit_solutions(A, u0, CPU)


def _cell_major_step(pc):
    """The driver's cell-major route for --pc `pc`: its fallback for a mesh
    with no field-major form."""
    model = _model((N,) * 3)
    make_M_cm = t_imp._preconditioners(argparse.Namespace(pc=pc), model.mesh, model, CPU,
                                       torch.float64)[2]
    side = "right" if pc in ("gridmg", "dct2lm") else "left"
    step = model.implicit_stepper(M=make_M_cm(), rtol=RTOL, atol=RTOL, maxiter=1000, side=side)
    return run_time_loop(step, model.initial_state(), model.dt, tmax=1e9, ntmax=1, log=None)


@pytest.mark.parametrize("pc", ["none", "pbjacobi", "gridmg", "dct2lm"])
def test_one_field_major_step_takes_the_cell_major_route_and_the_reference(
        tmp_path, capsys, reference, pc):
    argv = ["--mesh-family", "kershawtet"] + [str(N)] * 3 + [
        "--pc", pc, "--cfl", str(CFL), "--rtol", str(RTOL), "--atol", str(RTOL),
        "--tmax", "1e9", "--ntmax", "1", "--f64", "--device", "cpu", "--result-dir",
        str(tmp_path)]
    rt = t_imp.main(argv)
    assert "-- field-major GMRES loop" in capsys.readouterr().out
    rc = _cell_major_step(pc)
    (it_fm, _, conv_fm), (it_cm, _, conv_cm) = (r.diagnostics[-1]["extras"] for r in (rt, rc))
    assert conv_fm and conv_cm and it_fm == it_cm
    _close(rt.state, rc.state, 1e-10)
    _, _, ref = reference
    assert errors(rt.state.numpy()[:, None], ref)[0] < STEP_TOL


def test_the_tf32_control_fails_the_step_tolerance(reference):
    A, u0, ref = reference
    tf32 = implicit_tf32(A, {"rtol": 1e-5, "atol": 1e-5, "restart": 30, "maxits": 1000}, u0, CPU)
    assert errors(tf32, ref)[0] > 100 * STEP_TOL

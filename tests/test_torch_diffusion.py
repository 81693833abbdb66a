"""The port's diffusion family against the JAX package (float64 on the CPU,
the same NumPy inputs): the TPFA assembly and the periodic stencil,
DiffusionEquation with its steppers and exact solutions, CG and BiCGStab,
and DiffusionProjectionPC; and the eight properties of
tests/test_diffusion.py, held by the port.

Tolerances:
- the assembled operator and the stencil: 1e-14 × max|entry| (on Kershaw
  meshes the two packages' geometry differs by an ulp);
- exact_mode_decay and discrete_symbol: 1e-12 relative;
- Krylov solves: the same iteration count, x within 1e-10 × max|x|;
- the properties: the bounds of tests/test_diffusion.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import DiffusionEquation as JDiff
from circulantpreconditioner_tpu.ops import assembly as j_asm
from circulantpreconditioner_tpu.ops.csr import CSRMatrix as JCSR
from circulantpreconditioner_tpu.solvers import bicgstab as j_bicgstab
from circulantpreconditioner_tpu.solvers import cg as j_cg
from circulantpreconditioner_tpu.solvers import preconditioners as jpcs
from circulantpreconditioner_tpu.solvers.circulant_pc import DiffusionProjectionPC as JPC
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_cartesian
from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh as t_kershaw
from circulantpreconditioner_tpu_torch.models import DiffusionEquation as TDiff
from circulantpreconditioner_tpu_torch.ops import assembly as t_asm
from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix as TCSR
from circulantpreconditioner_tpu_torch.solvers import bicgstab as t_bicgstab
from circulantpreconditioner_tpu_torch.solvers import cg as t_cg
from circulantpreconditioner_tpu_torch.solvers import make_bicgstab, make_cg
from circulantpreconditioner_tpu_torch.solvers import preconditioners as tpcs
from circulantpreconditioner_tpu_torch.solvers.circulant_pc import DiffusionProjectionPC as TPC

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)


def _meshes(kind):
    if kind == "periodic 6x5":
        return (j_cartesian(((0, 1),) * 2, (6, 5), periodic=True),
                t_cartesian(((0, 1),) * 2, (6, 5), periodic=True))
    if kind == "wall 5x4x3":
        return j_cartesian(((0, 1),) * 3, (5, 4, 3)), t_cartesian(((0, 1),) * 3, (5, 4, 3))
    mj, mt = j_kershaw(((0.0, 1.0),) * 3, (4, 3, 3)), t_kershaw(((0.0, 1.0),) * 3, (4, 3, 3))
    if kind == "kershaw periodic 4x3x3":
        mj.set_periodic()
        mt.set_periodic()
    return mj, mt


def _dense(A):
    return A.to_scipy().toarray()


def _close(x, ref, tol):
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["periodic 6x5", "wall 5x4x3", "kershaw 4x3x3",
                                  "kershaw periodic 4x3x3"])
def test_diffusion_csr_matches_jax(kind):
    mj, mt = _meshes(kind)
    if kind.startswith("kershaw periodic"):  # face order may differ between the packages
        assert mt.groups == mj.groups
        assert (mt.periodic_twin_face >= 0).sum() == (mj.periodic_twin_face >= 0).sum() > 0
        assert np.array_equal(np.sort(mt.face_cells[mt.periodic_twin_face >= 0, 0]),
                              np.sort(mj.face_cells[mj.periodic_twin_face >= 0, 0]))
    Aj = j_asm.diffusion_csr(mj, 0.013, 0.7, dtype=jnp.float64)
    At = t_asm.diffusion_csr(mt, 0.013, 0.7, **F64)
    _close(_dense(At), Aj.to_dense(), 1e-14)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_diffusion_stencil_matches_jax(dim):
    spacing = (0.1, 0.25, 0.05)
    oj, bj = j_asm.diffusion_stencil(dim, 0.02, 0.3, spacing)
    ot, bt = t_asm.diffusion_stencil(dim, 0.02, 0.3, spacing)
    assert ot == oj
    _close(bt, bj, 1e-14)


@pytest.mark.parametrize("k", [(3,), (1, 2), (0, 4, 1)])
def test_exact_mode_decay_matches_jax(k):
    dim = len(k)
    n = (16, 12, 10)[:dim]
    dj = JDiff(j_cartesian(((0.0, 1.0),) * dim, n, periodic=True), nu=0.05, cfl=40.0,
               dtype=jnp.float64)
    dt = TDiff(t_cartesian(((0.0, 1.0),) * dim, n, periodic=True), nu=0.05, cfl=40.0, **F64)
    assert dt.dt == dj.dt
    np.testing.assert_allclose(dt.discrete_symbol(k), dj.discrete_symbol(k), rtol=1e-12)
    np.testing.assert_allclose(dt.exact_mode_decay(k, 4), dj.exact_mode_decay(k, 4), rtol=1e-12)


# --- the properties of tests/test_diffusion.py, on the port ----------------


def test_operator_spd_and_conservative():
    m = t_cartesian(((0, 1),) * 2, (6, 5), periodic=True)
    d = TDiff(m, nu=0.7, cfl=10.0, **F64)
    A = _dense(d.divergence)
    np.testing.assert_allclose(A, A.T, atol=1e-14)
    assert np.linalg.eigvalsh(A).min() > -1e-12
    np.testing.assert_allclose(A @ np.ones(m.n_cells), 0.0, atol=1e-12)


def test_operator_symmetric_on_warped_periodic_mesh():
    """The shared pair distance keeps V·L symmetric on a warped periodic mesh."""
    m = t_kershaw(((0.0, 1.0),) * 3, (4, 3, 3))
    m.set_periodic()
    d = TDiff(m, nu=0.3, cfl=5.0, **F64)
    A = _dense(d.divergence)
    VA = m.cell_volume[:, None] * A
    np.testing.assert_allclose(VA, VA.T, atol=1e-12 * np.abs(VA).max())
    np.testing.assert_allclose(A @ np.ones(m.n_cells), 0.0, atol=1e-10)


def test_exact_discrete_mode_decay_implicit():
    """Implicit Euler damps a periodic Fourier mode by exactly
    (1 + dt·λ_h(k))⁻¹ per step, through the CG and the FFT steppers."""
    n = 16
    m = t_cartesian(((0.0, 1.0),), (n,), periodic=True)
    d = TDiff(m, nu=0.05, cfl=40.0, **F64)
    u0 = np.sin(2 * np.pi * 3 * m.cell_center[:, 0])
    factor = d.exact_mode_decay((3,), n_steps=4)
    for step in (d.implicit_stepper(rtol=1e-13, atol=1e-13, maxiter=500), d.fft_stepper()):
        u = torch.as_tensor(u0)
        for _ in range(4):
            u = step(u)[0]
        np.testing.assert_allclose(u.numpy(), factor * u0, atol=1e-9)


def test_exact_continuous_solution_convergence():
    """The discrete decay converges to e^{−ν(2πk)²t} sin(2πkx) as h shrinks."""
    errs = []
    for n in (16, 32):
        m = t_cartesian(((0.0, 1.0),), (n,), periodic=True)
        d = TDiff(m, nu=0.02, cfl=4.0, **F64)
        steps = max(int(round(0.5 / d.dt)), 1)
        x = m.cell_center[:, 0]
        u = torch.as_tensor(np.sin(2 * np.pi * x))
        step = d.fft_stepper()
        for _ in range(steps):
            u = step(u)[0]
        exact = np.exp(-d.nu * (2 * np.pi) ** 2 * steps * d.dt) * np.sin(2 * np.pi * x)
        errs.append(np.abs(u.numpy() - exact).max())
    assert errs[1] < 0.5 * errs[0]


def test_fft_equals_cg_3d_and_jax():
    shape = (6, 5, 4)
    dj = JDiff(j_cartesian(((0, 1),) * 3, shape, periodic=True), nu=0.3, cfl=100.0,
               dtype=jnp.float64)
    dt = TDiff(t_cartesian(((0, 1),) * 3, shape, periodic=True), nu=0.3, cfl=100.0, **F64)
    u0 = dt.initial_state()
    u_fft, u_cg = dt.fft_stepper()(u0), dt.implicit_stepper(rtol=1e-12, atol=1e-12)(u0)
    np.testing.assert_allclose(u_fft[0].numpy(), u_cg[0].numpy(), atol=1e-8)
    rj = dj.implicit_stepper(rtol=1e-12, atol=1e-12)(dj.initial_state())
    assert u_cg[2] == int(rj[2]) and u_cg[4]
    _close(u_cg[0], rj[0], 1e-10)
    _close(u_fft[0], dj.fft_stepper()(dj.initial_state())[0], 1e-12)


def test_varying_stencil_on_kershaw_matches_matrix():
    m = t_kershaw(((0, 1),) * 3, (4, 4, 3))
    d = TDiff(m, nu=1.0, cfl=50.0, **F64)
    x = torch.as_tensor(np.random.default_rng(0).random(m.n_cells))
    np.testing.assert_allclose(d.divergence_op()(x).numpy(),  # auto: varying
                               d.divergence.matvec(x).numpy(), atol=1e-13)


def test_diffusion_projection_pc_accelerates_and_matches_jax():
    """GMRES with the projection PC (not symmetric, so not CG) needs fewer
    iterations than plain CG on a stiff Kershaw system, and as many as the
    JAX package's; the PC's coarse solve is the staged DFT, the JAX default."""
    mj, mt = j_kershaw(((0, 1),) * 3, (8, 8, 8)), t_kershaw(((0, 1),) * 3, (8, 8, 8))
    dj = JDiff(mj, nu=1.0, cfl=5e3, dtype=jnp.float64)
    dt = TDiff(mt, nu=1.0, cfl=5e3, **F64)
    kw = dict(rtol=1e-8, atol=1e-10, maxiter=2000)
    u0 = dt.initial_state()
    res_plain = dt.implicit_stepper(**kw)(u0)
    pc = TPC(mt, dt.dt, dt.nu, use_matmul_dft=True, **F64)
    res_pc = dt.implicit_stepper(M=pc.apply, method="gmres", **kw)(u0)
    assert res_pc[4] and res_plain[4]
    assert res_pc[2] < 0.7 * res_plain[2], (res_pc[2], res_plain[2])
    np.testing.assert_allclose(res_pc[0].numpy(), res_plain[0].numpy(), atol=1e-5)
    pj = JPC(mj, dj.dt, dj.nu, dtype=jnp.float64)
    rj = dj.implicit_stepper(M=pj.apply, method="gmres", **kw)(dj.initial_state())
    assert pc.projection == pj.projection
    assert res_pc[2] == int(rj[2])
    _close(res_pc[0], rj[0], 1e-10)
    r = np.random.default_rng(4).standard_normal(mt.n_cells)
    _close(pc.apply(torch.as_tensor(r)), pj.apply(jnp.asarray(r)), 1e-10)
    pc_fft = TPC(mt, dt.dt, dt.nu, **F64)  # the port's default coarse solve: torch.fft
    _close(pc_fft.apply(torch.as_tensor(r)), pj.apply(jnp.asarray(r)), 1e-10)


def test_explicit_stable_at_cfl_below_one():
    m = t_cartesian(((0, 1),) * 2, (12, 12), periodic=True)
    d = TDiff(m, nu=0.1, cfl=0.9, **F64)
    u = d.initial_state()
    step = d.explicit_stepper()
    for _ in range(50):
        u = step(u)[0]
    assert u.min().item() >= 599.0 and u.max().item() <= 651.0  # the maximum principle


# --- CG and BiCGStab --------------------------------------------------------


def laplace_2d(nx, ny):
    ex, ey = np.ones(nx), np.ones(ny)
    Tx = sp.diags([2 * ex, -ex[:-1], -ex[:-1]], [0, -1, 1])
    Ty = sp.diags([2 * ey, -ey[:-1], -ey[:-1]], [0, -1, 1])
    return (sp.kronsum(Tx, Ty) + 0.05 * sp.eye(nx * ny)).tocsr()


def upwind_1d_periodic(n, lam):
    A = sp.diags([(1 + lam) * np.ones(n), -lam * np.ones(n - 1)], [0, -1]).tolil()
    A[0, n - 1] = -lam
    return A.tocsr()


def _krylov_parity(rt, rj, A, b):
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    _close(rt.x, rj.x, 1e-10)
    np.testing.assert_allclose(rt.x.numpy(), spla.spsolve(A, b), rtol=1e-6, atol=1e-6)


def test_cg_spd_matches_jax():
    A = laplace_2d(15, 15)
    b = np.random.default_rng(5).normal(size=A.shape[0])
    Aj, At = JCSR.from_scipy(A, dtype=jnp.float64), TCSR.from_scipy(A, **F64)
    kw = dict(rtol=1e-10, atol=1e-12)
    rt = t_cg(At.matvec, torch.as_tensor(b), M=tpcs.jacobi(At), **kw)
    rj = j_cg(Aj.matvec, jnp.asarray(b), M=jpcs.jacobi(Aj), **kw)
    _krylov_parity(rt, rj, A, b)
    assert make_cg(At.matvec, rtol=1e-10, atol=1e-12, maxiter=3)(torch.as_tensor(b)).iters == 3


def test_bicgstab_nonsymmetric_matches_jax():
    A = upwind_1d_periodic(100, 2.0)
    b = np.random.default_rng(6).normal(size=100)
    Aj, At = JCSR.from_scipy(A, dtype=jnp.float64), TCSR.from_scipy(A, **F64)
    kw = dict(rtol=1e-10, atol=1e-12)
    rt = t_bicgstab(At.matvec, torch.as_tensor(b), **kw)
    rj = j_bicgstab(Aj.matvec, jnp.asarray(b), **kw)
    _krylov_parity(rt, rj, A, b)
    # with a preconditioner (right form): Jacobi on the same operator
    rt = make_bicgstab(At.matvec, tpcs.jacobi(At), **kw)(torch.as_tensor(b))
    rj = j_bicgstab(Aj.matvec, jnp.asarray(b), M=jpcs.jacobi(Aj), **kw)
    _krylov_parity(rt, rj, A, b)

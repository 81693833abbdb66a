"""Right-preconditioned GMRES with true_residual=True stops only where its
answer meets its tolerance: where a cycle's residual estimate meets tol =
max(rtol·‖b‖, atol), the next cycle's start forms b − A x, and the solve
ends only if that norm meets tol; each cycle the true residual forces
counts in STATS.true_restarts. The transport model's right-preconditioned
stepper takes it; without it GMRES keeps PETSc's test on the estimate.

The fault it cures: the estimate is that of A M⁻¹ applied to each basis
vector, while x takes M⁻¹ of their combination, and a preconditioner in
reduced precision is not linear to the last bit. On the reference's
implicit transport (the wall cube, a = (1, 0, 0), cfl 1e3/3) with the dense
circulant solve at "high" in float32, the estimate met 1e-5 in 3
iterations while ‖b − A x‖/‖b‖ read 2.5e-4 to 3.4e-4 on the CPU (fp32) and
9.4e-3 to 2.9e-2 on the card (K4's bf16×3). The answers are held to a
float64 solve of the benchmark's own frozen assembly
(portbench/reference/operators.py).

Left preconditioning keeps PETSc's test on the preconditioned estimate:
its counts are those it had before (measured on the solver without the
true-residual test).

This file imports no JAX; its `gpu` test runs on the card with

    python -m pytest --noconftest tests/test_torch_true_residual.py -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
from circulantpreconditioner_tpu_torch.models import TransportEquation
from circulantpreconditioner_tpu_torch.ops.spectral_collapse import make_circulant_solver
from circulantpreconditioner_tpu_torch.solvers import make_gmres
from circulantpreconditioner_tpu_torch.utils.graphs import STATS
from portbench.reference.operators import implicit_operator

CPU = torch.device("cpu")
CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "transport100.json"
TOL = 1e-5  # the configuration's rtol = atol


def _transport(n: int, device, dtype, precision: str = "high"):
    """(matvec, the dense circulant PC, b = the initial state, A = I + D in
    float64 from the reference's assembly) on the n³ wall cube."""
    config = json.loads(CONFIG.read_text())
    config["mesh"]["n"] = [n, n, n]
    mesh = cartesian_mesh(tuple(map(tuple, config["mesh"]["bounds"])), (n, n, n),
                          periodic=False)
    model = TransportEquation(mesh, config["velocity"], cfl=config["cfl"], device=device,
                              dtype=dtype)
    op = model.fft_operator
    M = make_circulant_solver(op.shape_zyx, op.lambdas_zyx, device=device, dtype=dtype,
                              precision=precision).as_preconditioner()
    A, _ = implicit_operator(config, "wall")
    return model.implicit_matvec(), M, model.initial_state(), A


def _true_residual(A, b: np.ndarray, x: np.ndarray) -> float:
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def _check_answer(n: int, device) -> None:
    matvec, M, b, A = _transport(n, device, torch.float32)
    STATS.reset()
    res = make_gmres(matvec, M, side="right", rtol=TOL, atol=TOL, restart=30,
                     maxiter=1000, true_residual=True)(b)
    bd, x = b.double().cpu().numpy(), res.x.double().cpu().numpy()
    true = _true_residual(A, bd, x)
    x_ref = spla.spsolve(A.tocsc(), bd)
    err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert res.converged and true <= TOL, (res.iters, true)
    assert err <= TOL, err
    # resnorm is the float32 norm of b − A x that decided the stop
    assert res.resnorm < TOL * np.linalg.norm(bd)
    assert res.resnorm == pytest.approx(true * np.linalg.norm(bd), rel=0.1)
    assert STATS.true_restarts >= 1 and STATS.solves == 1


@pytest.mark.parametrize("n", [12, 16])
def test_float32_right_gmres_meets_rtol_on_the_true_residual(n):
    _check_answer(n, CPU)


def test_the_transport_stepper_checks_the_true_residual():
    """The model's right-preconditioned step (the transport driver's and the
    benchmark's --pc circulant) takes the check: its answer meets rtol."""
    matvec, M, b, A = _transport(12, CPU, torch.float32)
    config = json.loads(CONFIG.read_text())
    mesh = cartesian_mesh(tuple(map(tuple, config["mesh"]["bounds"])), (12, 12, 12),
                          periodic=False)
    model = TransportEquation(mesh, config["velocity"], cfl=config["cfl"], device=CPU,
                              dtype=torch.float32)
    STATS.reset()
    x, _, iters, resnorm, converged = model.implicit_stepper(M=M, side="right")(b)
    bd = b.double().numpy()
    assert converged and _true_residual(A, bd, x.double().numpy()) <= TOL
    assert STATS.true_restarts >= 1 and iters > 3


class _Lying:
    """A preconditioner whose estimate lies: Jacobi plus a fixed direction
    scaled by ‖r‖, so that M(Σ yᵢvᵢ) ≠ Σ yᵢM(vᵢ). `calls` counts applies."""

    def __init__(self, dinv: torch.Tensor, eps: float):
        g = torch.Generator().manual_seed(3)
        e = torch.rand(dinv.shape[0], generator=g, dtype=dinv.dtype)
        self.dinv, self.e, self.calls = dinv, eps * e / torch.linalg.norm(e), 0

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        return self.dinv * r + torch.linalg.norm(r) * self.e


def _lying_problem(dtype=torch.float64):
    mesh = cartesian_mesh(((-0.5, 0.5),) * 3, (8, 6, 5), periodic=False)
    model = TransportEquation(mesh, (1.0, 0.5, 0.25), cfl=20.0, device=CPU, dtype=dtype)
    dinv = 1.0 / (model.divergence.diagonal() + 1.0)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=mesh.n_cells) + 600.0,
                        dtype=dtype)
    return model.implicit_matvec(), dinv, b


@pytest.mark.parametrize("eps", [1e-3, 1e-2])
def test_a_lying_preconditioner_restarts_until_the_true_residual_meets_tol(eps):
    """Without the test on b − A x the solve stopped in one cycle (27 to 29
    iterations) at a true residual 9e5 to 1e7 times tol."""
    matvec, dinv, b = _lying_problem()
    M = _Lying(dinv, eps)
    STATS.reset()
    res = make_gmres(matvec, M, side="right", rtol=1e-8, atol=0.0, restart=30,
                     maxiter=500, true_residual=True)(b)
    tol = 1e-8 * float(torch.linalg.norm(b))
    true = float(torch.linalg.norm(b - matvec(res.x)))
    assert res.converged and true < tol
    assert res.resnorm == pytest.approx(true, rel=1e-6)
    assert STATS.true_restarts >= 1 and res.iters > 30


def test_an_exact_preconditioner_forces_no_restart():
    """With an exact (linear) preconditioner the estimate and ‖b − A x‖
    agree, so no cycle is forced; the check costs one residual and one host
    read, nothing more."""
    matvec, dinv, b = _lying_problem()
    M = _Lying(dinv, 0.0)
    STATS.reset()
    res = make_gmres(matvec, M, side="right", rtol=1e-8, atol=0.0, restart=30,
                     maxiter=500, true_residual=True)(b)
    assert res.converged and STATS.true_restarts == 0
    assert float(torch.linalg.norm(b - matvec(res.x))) == pytest.approx(res.resnorm, rel=1e-6)


# right preconditioning without the check, the lying M: (iterations, M
# applies) of the solver before the true-residual test
RIGHT_COUNTS = {1e-3: (27, 29), 1e-2: (29, 31)}


@pytest.mark.parametrize("eps", list(RIGHT_COUNTS))
def test_right_gmres_without_the_check_keeps_the_estimates_stop(eps):
    """Without true_residual, side="right" stops where the estimate meets
    tol, as PETSc's default test does and as the solver did before: one
    cycle, ‖b − A x‖ far above tol, and no cycle forced."""
    matvec, dinv, b = _lying_problem()
    M = _Lying(dinv, eps)
    STATS.reset()
    res = make_gmres(matvec, M, side="right", rtol=1e-8, atol=0.0, restart=30,
                     maxiter=500)(b)
    tol = 1e-8 * float(torch.linalg.norm(b))
    assert (res.iters, M.calls) == RIGHT_COUNTS[eps]
    assert res.converged and res.resnorm < tol
    assert float(torch.linalg.norm(b - matvec(res.x))) > 1e3 * tol
    assert STATS.true_restarts == 0


@pytest.mark.parametrize("restart", [1, 2])
def test_a_solve_ended_by_the_check_reports_the_true_residual(restart):
    """Whether the solve ends on a check after a cycle whose estimate met
    tol or on a restart's start whose ‖b − A x‖ meets it, it reports itself
    converged, with that norm."""
    matvec, dinv, b = _lying_problem()
    res = make_gmres(matvec, _Lying(dinv, 0.0), side="right", rtol=1e-8, atol=0.0,
                     restart=restart, maxiter=500, true_residual=True)(b)
    true = float(torch.linalg.norm(b - matvec(res.x)))
    assert res.converged and true < 1e-8 * float(torch.linalg.norm(b))
    assert res.resnorm == pytest.approx(true, rel=1e-6)


def test_the_check_is_for_right_preconditioning():
    with pytest.raises(ValueError, match="true_residual"):
        make_gmres(lambda v: v, side="left", true_residual=True)


# left preconditioning, the lying M and an exact one: (iterations, M applies)
# of the solver before the true-residual test, which left solves do not take
LEFT_COUNTS = {(1e-3, torch.float64): (47, 62), (0.0, torch.float64): (56, 72),
               (1e-3, torch.float32): (34, 46), (0.0, torch.float32): (37, 50)}


@pytest.mark.parametrize("eps,dtype", list(LEFT_COUNTS), ids=str)
def test_left_gmres_keeps_its_counts(eps, dtype):
    matvec, dinv, b = _lying_problem(dtype)
    M = _Lying(dinv, eps)
    STATS.reset()
    rtol = 1e-8 if dtype == torch.float64 else 1e-5
    res = make_gmres(matvec, M, side="left", rtol=rtol, atol=0.0, restart=4, maxiter=500)(b)
    assert (res.iters, M.calls) == LEFT_COUNTS[eps, dtype]
    assert STATS.true_restarts == 0


@pytest.mark.gpu
def test_float32_right_gmres_meets_rtol_through_k4_on_the_card():
    """The same case at "high" on the card, where the PC is one K4 launch
    in bf16×3, the solve captured in CUDA graphs."""
    if not torch.cuda.is_available():
        pytest.skip("runs on the card (K4 is a CUDA kernel): need a GPU "
                    "(torch.cuda.is_available() is False)")
    _check_answer(16, torch.device("cuda"))

"""Tests of the port that need the GPU: kernels K1, K2, K3 and K4 against
their plain versions (K4 at the paths' shapes in both bf16 forms, and the
flagship at "high" through it), one GMRES step preconditioned through K1,
one grid-V-cycle GMRES step on the wave system through K2, the staged DFT solve through K3,
one dct2lm GMRES step through K2, and the paths with no hand-written kernel
(ILU(0) and block-Jacobi ILU(0), diffusion, the aggregation V-cycle, the
V-cycle of the tet meshes) on the card against the CPU, K7 (the tet meshes'
supercell SpMV) against its plain version and its refusals,
the distributed layer's slab solve on a world of one rank over NCCL, and
the device-resident solves: K2 counted per graph replay, a capture failure
raising, and every --pc choice of the implicit drivers solving under
capture; every captured step of the models (the jitted steps' and lax.scan
chunks' counterparts) against the same steps with capture off, and the
sharded drivers' steps and GMRES captured through NCCL. They skip without a
GPU.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerance: K1 (float32 FFT stages) and its plain version (float32 dense DFT
sums of up to n terms) round differently, ~1e-6 relative; the bar is
1e-5 · max|x_plain|. 100³, (101, 100, 100) and (400, 16, 16) run x and y
fused per plane, the others unfused; (2, 3, 9000) has rows too long for a
block's shared memory, so K1 runs their stages over device memory, and it is
held to the plain version in float64. (1, 5, 8) has λ_z = 0: on an axis of
one point the transport spectrum is 1 (ops/circulant.py, as in the JAX
package) while matvec's roll is the identity.
"""

import functools

import numpy as np
import pytest
import torch

from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
from circulantpreconditioner_tpu_torch.models import TransportEquation
from circulantpreconditioner_tpu_torch.ops import fused_circulant as tfc
from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("runs on the card (K1, K2 and K3 are CUDA kernels): need a GPU "
                    "(torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lams", [((6, 5, 8), (0.3, 0.2, 0.9)),
                                        ((100, 100, 100), (0.0, 0.0, 1e3 / 18)),
                                        ((33, 20, 70), (1.0, 2.0, 3.0)),
                                        ((7, 11, 13), (0.3, 0.2, 0.9)),
                                        ((101, 100, 100), (0.0, 0.0, 1e3 / 18)),
                                        ((400, 16, 16), (1.0, 0.5, 0.25)),
                                        ((1, 5, 8), (0.0, 0.2, 0.9)),
                                        ((4, 200, 300), (0.3, 0.2, 0.9)),
                                        ((2, 3, 9000), (0.5, 0.5, 0.5))])
def test_k1_kernel_matches_plain(cuda, shape, lams):
    s = tfc.FusedCirculantSolver.create(shape, lams, device=cuda, dtype=torch.float32)
    b = torch.as_tensor(np.random.default_rng(8).normal(size=shape).astype(np.float32),
                        device=cuda)
    before = tfc.FusedCirculantSolver.launches
    x = s.solve(b)
    torch.cuda.synchronize()
    assert tfc.FusedCirculantSolver.launches == before + 1
    if max(shape) > 5000:  # float32 dense sums of 9000 terms err by ~1e-5 themselves
        s64 = tfc.FusedCirculantSolver.create(shape, lams, device=cuda, dtype=torch.float64)
        xp = tfc.fused_circulant_reference(b.double(), s64.arrays)
    else:
        xp = tfc.fused_circulant_reference(b, s.arrays)
    assert (x - xp).abs().max().item() <= 1e-5 * xp.abs().max().item()
    op = CirculantTransportOperator.create(shape, lams, device=cuda, dtype=torch.float32)
    assert (torch.linalg.norm(op.matvec(x) - b) / torch.linalg.norm(b)).item() < 1e-4


@pytest.mark.gpu
def test_k1_wrapper_rejects_what_it_cannot_take(cuda):
    s = tfc.FusedCirculantSolver.create((4, 6, 8), (1.0, 0.5, 0.25), device=cuda,
                                        dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        tfc.fused_circulant_solve_cuda(torch.ones(4, 6, 8, device=cuda, dtype=torch.float64),
                                       s.plan)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.fused_circulant_solve_cuda(torch.ones(8, 6, 4, device=cuda).transpose(0, 2),
                                       s.plan)
    with pytest.raises(ValueError, match="shape"):
        tfc.fused_circulant_solve_cuda(torch.ones(4, 6, 9, device=cuda), s.plan)


@pytest.mark.gpu
def test_gmres_step_with_k1_preconditioner(cuda):
    """The slice's main path at 32³: one GMRES iteration per step, through K1."""
    mesh = cartesian_mesh(((-0.5, 0.5),) * 3, (32, 32, 32), periodic=True)
    model = TransportEquation(mesh, (1.0, 0.0, 0.0), cfl=1e3 / 3, device=cuda,
                              dtype=torch.float32)
    op = model.fft_operator
    M = tfc.FusedCirculantSolver.from_operator(op)
    before = tfc.FusedCirculantSolver.launches
    u1, _, iters, _, converged = model.implicit_stepper(M=M.as_preconditioner(),
                                                        side="right")(model.initial_state())
    assert converged and iters == 1
    assert tfc.FusedCirculantSolver.launches > before
    u_ref, _ = model.fft_stepper("fft")(model.initial_state())
    assert (u1 - u_ref).abs().max().item() <= 1e-4 * u_ref.abs().max().item()


# --- kernel K2: the wave normal-form stencil SpMV -----------------------------
# Tolerance: K2 and its plain version (torch.roll per offset) add the same
# terms in the same order; float32 contractions into FMAs move the result by
# a few ulp, so the bar is 1e-5 · max|y_plain| in float32 and 1e-12 in float64.

def _kershaw_wave(n, dev, dtype, cfl=1e3 / 3):
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    return WaveSystem(kershaw_mesh(((-0.5, 0.5),) * 3, n), cfl=cfl, device=dev, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [(16, 8, 5), (5, 4, 6), (32, 32, 32)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_k2_kernel_matches_plain(cuda, n, dtype, tol):
    from circulantpreconditioner_tpu_torch.ops.plane_stencil import (
        PlaneStencilMatvec,
        make_plane_stencil_matvec,
    )

    Wn = _kershaw_wave(n, cuda, dtype).normal_operator
    mv = make_plane_stencil_matvec(Wn)
    g = torch.as_tensor(np.random.default_rng(2).random((4, int(np.prod(n)))), device=cuda,
                        dtype=dtype)
    before = PlaneStencilMatvec.launches
    y = mv(g)
    y_grid = mv(g.reshape(4, n[2], n[1], n[0]))
    torch.cuda.synchronize()
    assert PlaneStencilMatvec.launches == before + 2
    yp = Wn.matvec_fm(g)
    assert (y - yp).abs().max().item() <= tol * yp.abs().max().item()
    assert torch.equal(y_grid.reshape(4, -1), y)


@pytest.mark.gpu
def test_k2_wrapper_rejects_what_it_cannot_take(cuda):
    from circulantpreconditioner_tpu_torch.ops.plane_stencil import plane_stencil_cuda

    Wn = _kershaw_wave((5, 4, 6), cuda, torch.float32).normal_operator
    N = 5 * 4 * 6
    with pytest.raises(ValueError, match="float32"):
        plane_stencil_cuda(Wn, torch.ones(4, N, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        plane_stencil_cuda(Wn, torch.ones(4, N))
    with pytest.raises(ValueError, match="shape"):
        plane_stencil_cuda(Wn, torch.ones(4, N + 1, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        plane_stencil_cuda(Wn, torch.ones(N, 4, device=cuda).T)
    with pytest.raises(ValueError, match="float16"):
        plane_stencil_cuda(Wn, torch.ones(4, N, device=cuda, dtype=torch.float16))


@pytest.mark.gpu
def test_gridmg_gmres_step_launches_k2(cuda):
    """One implicit step at Kershaw 16³, GMRES right-preconditioned by the
    grid V-cycle, through K2; it agrees with the plain operator's step."""
    import functools

    from circulantpreconditioner_tpu_torch.models.transport import _identity_plus
    from circulantpreconditioner_tpu_torch.ops.plane_stencil import PlaneStencilMatvec
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC

    model = _kershaw_wave((16, 16, 16), cuda, torch.float32)
    pc = GridVCyclePC.from_grid_model(model.divergence, (16, 16, 16),
                                      A0_apply=model.implicit_matvec(),
                                      A0_apply_fm=model.implicit_matvec_fm())
    G0 = model.pack_fm(model.initial_state()).reshape(-1)
    before = PlaneStencilMatvec.launches
    G1, _, iters, _, converged = model.implicit_stepper_fm(M_fm=pc.apply_fm, side="right")(G0)
    torch.cuda.synchronize()
    assert converged and iters > 0
    assert PlaneStencilMatvec.launches > before + iters  # the matvec and the V-cycle's fine level
    A_plain = functools.partial(_identity_plus, model.normal_operator.matvec_fm_flat)
    pc_plain = GridVCyclePC.from_grid_model(model.divergence, (16, 16, 16),
                                            A0_apply=model.implicit_matvec(), A0_apply_fm=A_plain)
    ref = make_gmres(A_plain, pc_plain.apply_fm, side="right")(G0, G0)
    assert ref.converged and abs(ref.iters - iters) <= 1
    assert (G1 - ref.x).abs().max().item() <= 1e-4 * ref.x.abs().max().item()


# --- kernel K3: the complex matrix product -----------------------------------
# Tolerance: in float32 K3 computes in 3×TF32 on the tensor cores (about
# float32's accuracy, tests/test_torch_tf32_split.py), its plain version in
# float32 (four torch.matmul): 1e-5 · max|o_plain|. In float64 both sum the
# same products in another order: 1e-12. Beyond the staged solver's shapes,
# the cases take the edges of the float32 tiling: K and N not multiples of 8
# (4-byte copies where not multiples of 4), N = 104 (n = 100 padded) and 136
# (a second column tile), K = 129 (a second chunk of B), M = 16·132 + 1 (one
# unit more than the SMs), K = 300 and N = 260 (three chunks, three column
# tiles).

@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(8320, 128, 128), (5100, 100, 100), (37, 45, 29),
                                   (1, 1, 1), (65, 17, 130), (2113, 100, 100),
                                   (300, 99, 104), (257, 104, 104), (300, 129, 136),
                                   (40, 64, 30), (70, 300, 260)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_k3_kernel_matches_plain(cuda, M, K, N, dtype, tol):
    from circulantpreconditioner_tpu_torch.ops.complex_matmul import (
        ComplexMatmulKernel,
        complex_matmul,
        complex_matmul_reference,
    )

    rng = np.random.default_rng(M + K + N)
    a = [torch.as_tensor(rng.standard_normal((M, K)), device=cuda, dtype=dtype)
         for _ in range(2)]
    b = [torch.as_tensor(rng.standard_normal((K, N)), device=cuda, dtype=dtype)
         for _ in range(2)]
    before = ComplexMatmulKernel.launches
    o = complex_matmul(*a, *b)
    torch.cuda.synchronize()
    assert ComplexMatmulKernel.launches == before + 1
    p = complex_matmul_reference(*a, *b)
    scale = max(p[0].abs().max().item(), p[1].abs().max().item())
    for i in range(2):
        assert (o[i] - p[i]).abs().max().item() <= tol * scale


@pytest.mark.gpu
def test_k3_wrapper_rejects_what_it_cannot_take(cuda):
    from circulantpreconditioner_tpu_torch.ops.complex_matmul import complex_matmul_cuda

    a = [torch.ones(6, 4, device=cuda) for _ in range(2)]
    b = [torch.ones(4, 3, device=cuda) for _ in range(2)]
    with pytest.raises(ValueError, match="float64"):
        complex_matmul_cuda(a[0], a[1].double(), *b)
    with pytest.raises(ValueError, match="inner"):
        complex_matmul_cuda(*a, torch.ones(5, 3, device=cuda), torch.ones(5, 3, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        complex_matmul_cuda(torch.ones(4, 6, device=cuda).T, a[1], *b)
    with pytest.raises(ValueError, match="float16"):
        complex_matmul_cuda(*(t.half() for t in a), *(t.half() for t in b))
    with pytest.raises(ValueError, match="CUDA"):
        complex_matmul_cuda(*(t.cpu() for t in a), *(t.cpu() for t in b))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lams", [((128, 128, 128), (0.3, 0.6, 1.2)),
                                        ((100, 100, 100), (0.0, 0.0, 1e3 / 18)),
                                        ((6, 5, 8), (0.3, 0.2, 0.9))])
def test_staged_solve_through_k3(cuda, shape, lams):
    """Main path E: four K3 launches per solve, the einsum form's result."""
    from circulantpreconditioner_tpu_torch.ops.complex_matmul import ComplexMatmulKernel
    from circulantpreconditioner_tpu_torch.ops.dft_matmul import MatmulCirculantSolver

    f32 = dict(device=cuda, dtype=torch.float32)
    sk = MatmulCirculantSolver.create(shape, lams, use_kernel=True, **f32)
    se = MatmulCirculantSolver.create(shape, lams, **f32)
    b = torch.as_tensor(np.random.default_rng(4).normal(size=shape).astype(np.float32),
                        device=cuda)
    before = ComplexMatmulKernel.launches
    x = sk.solve(b)
    torch.cuda.synchronize()
    assert ComplexMatmulKernel.launches == before + 4
    xe = se.solve(b)
    assert (x - xe).abs().max().item() <= 1e-5 * xe.abs().max().item()
    op = CirculantTransportOperator.create(shape, lams, **f32)
    assert (torch.linalg.norm(op.matvec(x) - b) / torch.linalg.norm(b)).item() < 1e-4


@pytest.mark.gpu
def test_dct2lm_gmres_step_launches_k2(cuda):
    """One implicit step at Kershaw 16³ with the multiplicative DCT two-level
    PC: K2 runs in the matvec and once in every PC apply, and the step
    agrees with the plain operator's."""
    import functools

    from circulantpreconditioner_tpu_torch.models.transport import _identity_plus
    from circulantpreconditioner_tpu_torch.ops.plane_stencil import PlaneStencilMatvec
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import DCTBlockProjectionPC

    model = _kershaw_wave((16, 16, 16), cuda, torch.float32)
    coarse = DCTBlockProjectionPC(model.mesh, model.dt, model.c0, device=cuda,
                                  dtype=torch.float32)
    adapter = pcs.cell_major_adapter(coarse.apply, 4)
    pj = pcs.pbjacobi_fm(model.divergence, shift=1.0)
    A = model.implicit_matvec_fm()
    G0 = model.pack_fm(model.initial_state()).reshape(-1)
    before = PlaneStencilMatvec.launches
    G1, _, iters, _, converged = model.implicit_stepper_fm(
        M_fm=pcs.multiplicative(A, adapter, pj), side="right")(G0)
    torch.cuda.synchronize()
    assert converged and iters > 0
    assert PlaneStencilMatvec.launches >= before + 2 * iters
    A_plain = functools.partial(_identity_plus, model.normal_operator.matvec_fm_flat)
    ref = make_gmres(A_plain, pcs.multiplicative(A_plain, adapter, pj), side="right")(G0, G0)
    assert ref.converged and abs(ref.iters - iters) <= 1
    assert (G1 - ref.x).abs().max().item() <= 1e-4 * ref.x.abs().max().item()


# --- paths with no hand-written kernel: ILU(0), diffusion, aggregation -------
# These run in plain PyTorch on the card; the tests hold the card's float32
# run to the CPU's float64 one of the same code.


@pytest.mark.gpu
def test_ilu0_apply_and_gmres_step_on_card(cuda):
    """The ILU(0) apply on the card agrees with the CPU float64 apply of the
    same factor to 1e-5 · max|z|, and a GMRES + ILU(0) step (and a
    block-Jacobi one) at cartesian 16³ converges."""
    from circulantpreconditioner_tpu_torch.drivers.wave_implicit import identity_plus_csr
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

    model = WaveSystem(cartesian_mesh(((-0.5, 0.5),) * 3, (16, 16, 16)), cfl=1e3 / 3,
                       device=cuda, dtype=torch.float32)
    A_I = identity_plus_csr(model, torch.float32)
    ilu = pcs.ilu0(A_I)
    assert ilu.n_levels == (50, 50)
    ilu64 = pcs.ilu0(CSRMatrix.from_scipy(A_I.to_scipy(), device=torch.device("cpu"),
                                          dtype=torch.float64))
    r = np.random.default_rng(15).standard_normal(A_I.shape[0])
    z = ilu.apply(torch.as_tensor(r, device=cuda, dtype=torch.float32)).double().cpu().numpy()
    z64 = ilu64.apply(torch.as_tensor(r)).numpy()
    assert np.abs(z - z64).max() <= 1e-5 * np.abs(z64).max()
    U0 = model.initial_state()
    for M in (ilu.apply, pcs.block_jacobi_ilu0(A_I, 4)):
        U1, _, iters, _, converged = model.implicit_stepper(M=M, maxiter=500)(U0)
        assert converged and iters > 0 and bool(torch.isfinite(U1).all())


@pytest.mark.gpu
def test_diffusion_cg_fft_and_pc_on_card(cuda):
    """Diffusion at 32³: a CG step meets the 1e-4 residual gate, the FFT
    step agrees with CG to 1e-4, and GMRES with the projection PC converges
    on a Kershaw 16³ mesh."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import DiffusionEquation
    from circulantpreconditioner_tpu_torch.solvers.circulant_pc import DiffusionProjectionPC

    cube = ((-0.5, 0.5),) * 3
    d = DiffusionEquation(cartesian_mesh(cube, (32,) * 3, periodic=True), cfl=10.0,
                          device=cuda, dtype=torch.float32)
    b = d.initial_state()
    x_cg, _, _, _, converged = d.implicit_stepper()(b)
    assert converged
    assert (torch.linalg.norm(d.implicit_matvec()(x_cg) - b) / torch.linalg.norm(b)).item() < 1e-4
    x_fft = d.fft_stepper()(b)[0]
    assert (x_fft - x_cg).abs().max().item() <= 1e-4 * x_cg.abs().max().item()
    dk = DiffusionEquation(kershaw_mesh(cube, (16,) * 3), device=cuda, dtype=torch.float32)
    pc = DiffusionProjectionPC(dk.mesh, dk.dt, dk.nu, device=cuda, dtype=torch.float32)
    x, _, iters, _, converged = dk.implicit_stepper(M=pc.apply, method="gmres")(dk.initial_state())
    assert converged and iters > 0 and bool(torch.isfinite(x).all())


@pytest.mark.gpu
def test_aggvcycle_gmres_step_on_card(cuda):
    """A GMRES step right-preconditioned by the aggregation V-cycle at
    Kershaw 12³ converges on the card within one iteration of the CPU float64
    run."""
    from circulantpreconditioner_tpu_torch.solvers import AggregationVCyclePC

    steps = []
    for device, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
        model = _kershaw_wave((12, 12, 12), device, dtype)
        pc = AggregationVCyclePC.from_bsr(model.divergence, A0_apply=model.implicit_matvec(),
                                          shift=1.0)
        assert pc.n_levels == 2
        steps.append(model.implicit_stepper(M=pc.apply, side="right")(model.initial_state()))
    (x, _, iters, _, converged), ref = steps
    assert converged and ref[4] and abs(iters - ref[2]) <= 1
    assert (x.double().cpu() - ref[0]).abs().max().item() <= 1e-4 * ref[0].abs().max().item()


def _tet_wave(n, device, dtype, cfl=1e3 / 3):
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    return WaveSystem(kershaw_tet_mesh(((0.0, 1.0),) * 3, (n,) * 3), cfl=cfl, device=device,
                      dtype=dtype)


@pytest.mark.gpu
def test_supercell_spmv_on_card(cuda):
    """Kershaw-tet 12³: the supercell normal form's apply, K7 (field-major and
    cell-major), and the dense M = 24 stencil (cell-major) on the card against
    the CPU float64 result, to 1e-5 · max|y|; every apply of the model's
    routes launched K7 once and counted as fused."""
    from circulantpreconditioner_tpu_torch.ops import supercell_stencil as k7
    from circulantpreconditioner_tpu_torch.ops.stencil import SupercellNormalOperator
    from circulantpreconditioner_tpu_torch.utils.graphs import STATS

    gpu, cpu = _tet_wave(12, cuda, torch.float32), _tet_wave(12, torch.device("cpu"),
                                                               torch.float64)
    assert isinstance(gpu.divergence_op_fm().__self__, SupercellNormalOperator)
    x = np.random.default_rng(16).standard_normal(gpu.divergence.shape[0])
    g = x.reshape(-1, 24).T.copy()
    launches = k7.SupercellStencilKernel.launches
    STATS.reset()
    y_fm = gpu.divergence_op_fm()(torch.as_tensor(g, device=cuda, dtype=torch.float32))
    y_cm = gpu.divergence_op()(torch.as_tensor(x, device=cuda, dtype=torch.float32))
    y_dense = gpu.divergence_op("varying")(torch.as_tensor(x, device=cuda, dtype=torch.float32))
    assert k7.SupercellStencilKernel.launches - launches == 2
    assert (STATS.supercell_fused, STATS.supercell_plain) == (2, 0)
    ref = cpu.divergence.matvec(torch.as_tensor(x)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(y_fm.double().cpu().numpy().T.reshape(-1) - ref).max() <= 1e-5 * scale
    assert np.abs(y_cm.double().cpu().numpy() - ref).max() <= 1e-5 * scale
    assert np.abs(y_dense.double().cpu().numpy() - ref).max() <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_k7_against_its_plain_version(cuda, dtype, tol):
    """K7 against its plain version (SupercellNormalOperator.plain_fm, run on
    the card) at Kershaw-tet 12³ and on a lattice of unequal sides (7, 5, 9),
    to tol · max|y|, in float32 and float64."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.ops import supercell_stencil as k7

    for n in ((12, 12, 12), (7, 5, 9)):
        S = WaveSystem(kershaw_tet_mesh(((0.0, 1.0),) * 3, n), cfl=1e3 / 3, device=cuda,
                       dtype=dtype).supercell_operator
        g = torch.randn(S.M, S.N, device=cuda, dtype=dtype)
        y, ref = k7.supercell_stencil_cuda(S, g), S.plain_fm(g)
        assert (y - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dtype", "shape", "device", "contiguity", "table dtype"])
def test_k7_refuses_what_it_cannot_take(cuda, case):
    """The wrapper raises, on the card, on a dtype other than float32 and
    float64 (and tables in another than x's), a shape that is not the
    operator's, x off the card, a non-contiguous x, a table not int32."""
    from circulantpreconditioner_tpu_torch.ops import supercell_stencil as k7

    S = _tet_wave(4, cuda, torch.float32).supercell_operator
    g = torch.randn(S.M, S.N, device=cuda)
    match = {"dtype": "float32 or float64", "shape": "shape", "device": "CUDA tensors",
             "contiguity": "contiguous", "table dtype": "expected torch.int32"}[case]
    if case == "dtype":
        g = g.half()
    elif case == "shape":
        g = g[:, :-1]
    elif case == "device":
        g = g.cpu()
    elif case == "contiguity":
        g = torch.randn(S.N, S.M, device=cuda).T
    else:
        S.table = S.table.long()
    with pytest.raises(ValueError, match=match):
        k7.supercell_stencil_cuda(S, g)
    with pytest.raises(ValueError, match="float64"):  # tables in another dtype than x
        k7.supercell_stencil_cuda(S, torch.randn(S.M, S.N, device=cuda, dtype=torch.float64))


@pytest.mark.gpu
def test_supercell_vcycle_on_card(cuda):
    """The supercell grid V-cycle at Kershaw-tet 8³, field-major over the
    block-sparse operator (bench_suite.py's route): one apply on the card
    against the CPU float64 apply to 1e-4 · max|z|, and a right-preconditioned
    field-major GMRES step within one iteration of the CPU's."""
    import functools

    from circulantpreconditioner_tpu_torch.models.transport import _identity_plus
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC

    out = []
    r = np.random.default_rng(17).standard_normal(8**3 * 24)
    for device, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
        model = _tet_wave(8, device, dtype)
        A_fm = functools.partial(_identity_plus, model.divergence_op_fm(flat=True))
        pc = GridVCyclePC.from_grid_model(model.divergence, model.mesh.topology_shape,
                                          cells_per_site=6, A0_apply=A_fm, A0_apply_fm=A_fm,
                                          shift=1.0)
        z = pc.apply_fm(torch.as_tensor(r, device=device, dtype=dtype))
        G0 = model.pack_fm(model.initial_state()).reshape(-1)
        res = make_gmres(A_fm, pc.apply_fm, side="right")(G0, G0)
        out.append((z.double().cpu().numpy(), res))
    (z, res), (z64, ref) = out
    assert np.abs(z - z64).max() <= 1e-4 * np.abs(z64).max()
    assert res.converged and ref.converged and abs(res.iters - ref.iters) <= 1


@pytest.mark.gpu
def test_sharded_solves_on_card_through_nccl(cuda):
    """The distributed layer on a world of one rank over NCCL, opened as the
    drivers open it: the slab solve equals the one-device solve, and asking
    for more ranks than the host has GPUs raises (no two ranks share one)."""
    import torch.distributed as dist

    from circulantpreconditioner_tpu_torch.parallel import (
        SlabCirculantSolver,
        device_mesh,
        rank_world,
    )

    with pytest.raises(RuntimeError, match="GPU"):
        with rank_world(torch.cuda.device_count() + 1, "cuda"):
            pass
    with rank_world(None, "cuda"):
        assert dist.get_backend() == "nccl"
        op = CirculantTransportOperator.create((16, 8, 12), (0.3, 0.8, 2.0), device=cuda,
                                               dtype=torch.float64)
        slab = SlabCirculantSolver.from_operator(op, device_mesh())
        b = torch.as_tensor(np.random.default_rng(1).random((16, 8, 12)), device=cuda)
        x = slab.unshard(slab.solve(slab.shard(b)))
        assert (x - op.solve(b)).abs().max().item() <= 1e-12 * op.solve(b).abs().max().item()
    assert not dist.is_initialized()


# --- device-resident solves: CUDA-graph replays (utils/graphs.py) -------------

@pytest.mark.gpu
def test_k2_launches_counted_per_replay(cuda):
    """A captured K2 matvec replayed 5 times adds 5 launches; the capture
    itself adds none, and the replays compute what the kernel computes."""
    from circulantpreconditioner_tpu_torch.ops.plane_stencil import (
        PlaneStencilMatvec,
        make_plane_stencil_matvec,
    )
    from circulantpreconditioner_tpu_torch.utils.graphs import GraphSet

    Wn = _kershaw_wave((16, 8, 5), cuda, torch.float32).normal_operator
    mv = make_plane_stencil_matvec(Wn)
    g = torch.as_tensor(np.random.default_rng(2).random((4, 16 * 8 * 5)), device=cuda,
                        dtype=torch.float32)
    out = torch.zeros_like(g)
    graphs = GraphSet(cuda)
    before = PlaneStencilMatvec.launches
    graphs.run("k2", lambda: out.copy_(mv(g)))  # the eager warm-up, then the capture
    assert PlaneStencilMatvec.launches == before + 1 and len(graphs) == 1
    out.zero_()
    for _ in range(5):
        graphs.run("k2", lambda: out.copy_(mv(g)))
    torch.cuda.synchronize()
    assert PlaneStencilMatvec.launches == before + 6
    yp = Wn.matvec_fm(g)
    assert (out - yp).abs().max().item() <= 1e-5 * yp.abs().max().item()


_DRIVER_RUNS = [
    ("wave_implicit", ["--mesh-family", "kershaw", "8", "8", "8", "--pc", pc])
    for pc in ("none", "pbjacobi", "ilu0", "bjacobi", "circulant2l", "dct2l", "dct2lm",
               "gridmg", "aggvcycle")
] + [
    ("wave_implicit", ["--mesh-family", "kershawtet", "4", "4", "4", "--pc", "gridmg"]),
    ("wave_implicit", ["8", "8", "8", "--pc", "ilu0", "--maxits", "50"]),
] + [
    ("transport_implicit", ["--mesh-family", "kershaw", "8", "8", "8", "--pc", pc])
    for pc in ("none", "jacobi", "circulant")
] + [
    ("diffusion_implicit", ["--mesh-family", "kershaw", "8", "8", "8", "--method", m])
    for m in ("cg", "gmres", "pc")
]


@pytest.mark.gpu
@pytest.mark.parametrize("driver,argv", _DRIVER_RUNS,
                         ids=[f"{d}-{'-'.join(a[-2:])}" for d, a in _DRIVER_RUNS])
def test_every_krylov_pc_solves_under_capture(cuda, tmp_path, driver, argv):
    """Each --pc choice of the implicit drivers solves its steps as CUDA-graph
    replays on the card: the solves capture their graphs in the first step
    and replay them, every step's solve is finite, and each converges where
    the case converges on the CPU. The same steps with capture off
    (graphs.CAPTURE false: every step function eager) take the same
    iterations and end within 1e-6 of the captured state, so no replay read
    a buffer that another graph of the shared pool had overwritten."""
    import importlib

    from circulantpreconditioner_tpu_torch.utils import graphs

    main = importlib.import_module(f"circulantpreconditioner_tpu_torch.drivers.{driver}").main
    args = argv + ["--ntmax", "2", "--tmax", "1e9", "--device", "cuda"]
    STATS = graphs.STATS
    STATS.reset()
    res = main(args + ["--result-dir", str(tmp_path / "captured")])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(res.state).all())
    assert STATS.captures > 0 and STATS.replays > 0 and STATS.iterations > 0
    conv = [d["extras"][2] for d in res.diagnostics]
    if "--maxits" not in argv:
        assert all(conv), (STATS.snapshot(), [d["extras"] for d in res.diagnostics])
    its = [d["extras"][0] for d in res.diagnostics]

    STATS.reset()
    graphs.CAPTURE = False
    try:
        eager = main(args + ["--result-dir", str(tmp_path / "eager")])
    finally:
        graphs.CAPTURE = True
    torch.cuda.synchronize()
    assert STATS.captures == 0 and STATS.replays == 0 and STATS.iterations > 0
    assert [d["extras"][0] for d in eager.diagnostics] == its
    scale = eager.state.abs().max().item()
    assert (res.state - eager.state).abs().max().item() <= 1e-6 * scale


# --- captured steps (utils/graphs.CapturedStep): the jitted steps' and
# lax.scan chunks' counterparts ------------------------------------------------

def _captured_steppers(dev, dtype):
    """name → (model, captured stepper, initial state) for every explicit and
    direct stepper of the models, and path E's solve through K3."""
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.models import DiffusionEquation, WaveSystem
    from circulantpreconditioner_tpu_torch.models.transport import _direct_step
    from circulantpreconditioner_tpu_torch.ops.dft_matmul import MatmulCirculantSolver
    from circulantpreconditioner_tpu_torch.utils.graphs import CapturedStep

    kw = dict(device=dev, dtype=dtype)
    box = ((-0.5, 0.5),) * 3
    tr = TransportEquation(cartesian_mesh(box, (16, 12, 10), periodic=True),
                           (1.0, -0.5, 0.25), cfl=0.3, **kw)
    td = TransportEquation(cartesian_mesh(box, (16, 12, 10), periodic=True),
                           (1.0, 0.5, 0.25), cfl=1e3 / 3, **kw)
    wk = _kershaw_wave((16, 16, 16), dev, dtype, cfl=1.0 / 3)
    wp = WaveSystem(cartesian_mesh(box, (12, 10, 8), periodic=True), cfl=1e3 / 3, **kw)
    ww = WaveSystem(cartesian_mesh(box, (12, 10, 8)), cfl=1e3 / 3, **kw)
    de = DiffusionEquation(cartesian_mesh(box, (16, 12, 10)), cfl=0.9, **kw)
    dp = DiffusionEquation(cartesian_mesh(box, (16, 12, 10), periodic=True), cfl=100.0, **kw)
    op = td.fft_operator
    k3 = MatmulCirculantSolver.create(op.shape_zyx, op.lambdas_zyx, use_kernel=True, **kw)
    return {
        "transport-explicit": lambda: (tr, tr.explicit_stepper(), tr.initial_state()),
        "transport-fft": lambda: (td, td.fft_stepper("fft"), td.initial_state()),
        "transport-matmul": lambda: (td, td.fft_stepper("matmul"), td.initial_state()),
        "transport-k3": lambda: (td, CapturedStep(functools.partial(_direct_step, k3)),
                                 td.initial_state()),
        "wave-explicit": lambda: (wk, wk.explicit_stepper(), wk.initial_state()),
        "wave-explicit-fm-k2": lambda: (wk, wk.explicit_stepper_fm(),
                                        wk.pack_fm(wk.initial_state())),
        "wave-blockfft": lambda: (wp, wp.block_fft_stepper(), wp.initial_state()),
        "wave-dctfft": lambda: (ww, ww.dct_fft_stepper(), ww.initial_state()),
        "wave-dctfft-fm": lambda: (ww, ww.dct_fft_stepper_fm(), ww.pack_fm(ww.initial_state())),
        "diffusion-explicit": lambda: (de, de.explicit_stepper(), de.initial_state()),
        "diffusion-fft": lambda: (dp, dp.fft_stepper(), dp.initial_state()),
    }


_CAPTURED = ["transport-explicit", "transport-fft", "transport-matmul", "transport-k3",
             "wave-explicit", "wave-explicit-fm-k2", "wave-blockfft", "wave-dctfft",
             "wave-dctfft-fm", "diffusion-explicit", "diffusion-fft"]


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", _CAPTURED)
def test_captured_step_equals_eager(cuda, name, dtype, tol, chunk):
    """7 steps of each captured stepper through run_time_loop (chunk 3: 3, 3
    and 1 steps per graph) against the same steps with capture off: equal
    states, and the kernels' launches counted per replay as the eager run
    counts them (K2 once per explicit field-major step, K3 four times per
    staged solve)."""
    from circulantpreconditioner_tpu_torch.models import run_time_loop
    from circulantpreconditioner_tpu_torch.utils import graphs

    runs = []
    for capture in (True, False):
        graphs.CAPTURE = capture
        try:
            model, step, U0 = _captured_steppers(cuda, dtype)[name]()
            graphs.STATS.reset()
            before = graphs.kernel_launches()
            res = run_time_loop(step, U0, model.dt, tmax=1e9, ntmax=7, precision=0.0,
                                log=None, chunk=chunk)
            torch.cuda.synchronize()
        finally:
            graphs.CAPTURE = True
        launches = tuple(a - b for a, b in zip(graphs.kernel_launches(), before))
        runs.append((res, launches, graphs.STATS.snapshot()))
    (res, launches, snap), (eager, eager_launches, eager_snap) = runs
    assert snap["captures"] == (2 if chunk == 3 else 1) and snap["replays"] > 0
    assert eager_snap["captures"] == eager_snap["replays"] == 0
    assert launches == eager_launches
    if name == "wave-explicit-fm-k2":
        assert launches[1] == 7
    if name == "transport-k3":
        assert launches[2] == 28
    assert res.iterations == eager.iterations == 7
    assert bool(torch.isfinite(res.state).all())
    scale = eager.state.abs().max().item()
    assert (res.state - eager.state).abs().max().item() <= tol * scale
    d, de = (np.array([x["dnorm"] for x in r.diagnostics]) for r in (res, eager))
    assert np.abs(d - de).max() <= tol * np.abs(de).max()


_SHARDED = [
    ("wave_explicit", ["--mesh-family", "kershaw", "16", "16", "16", "--shard", "slab"]),
    ("wave_explicit", ["--mesh-family", "kershaw", "16", "16", "16", "--shard", "rows",
                       "--chunk", "3"]),
    ("transport_fft", ["16", "16", "16", "--shard", "slab"]),
    ("transport_fft", ["16", "16", "16", "--shard", "pencil", "--chunk", "3"]),
    ("wave_implicit", ["--mesh-family", "kershaw", "8", "8", "8", "--shard", "rows",
                       "--pc", "pbjacobi"]),
    ("wave_implicit", ["--mesh-family", "kershaw", "8", "8", "8", "--shard", "rows",
                       "--pc", "circulant2l"]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("driver,argv", _SHARDED,
                         ids=[f"{d}-{'-'.join(a[a.index('--shard') + 1:])}" for d, a in _SHARDED])
def test_sharded_steps_captured_through_nccl(cuda, tmp_path, driver, argv):
    """The sharded drivers on a world of one NCCL rank: the explicit and
    direct steps (halo exchanges, all-to-alls and the global norms) and the
    row-sharded GMRES (its all-reduces and the PC's exchanges) run as graph
    replays, and take the iterations and reach the states of the same run
    with capture off (1e-6 relative)."""
    import importlib

    from circulantpreconditioner_tpu_torch.utils import graphs

    main = importlib.import_module(f"circulantpreconditioner_tpu_torch.drivers.{driver}").main
    steps = 6 if "--chunk" in argv else 3  # a chunk of 3 replays from the second chunk on
    args = argv + ["--ntmax", str(steps), "--tmax", "1e9", "--device", "cuda"]
    runs = []
    for capture in (True, False):
        graphs.CAPTURE = capture
        graphs.STATS.reset()
        try:
            res = main(args + ["--result-dir", str(tmp_path / str(capture))])
        finally:
            graphs.CAPTURE = True
        torch.cuda.synchronize()
        runs.append((res, graphs.STATS.snapshot()))
    (res, snap), (eager, eager_snap) = runs
    assert snap["captures"] > 0 and snap["replays"] > 0
    assert eager_snap["replays"] == 0
    its = [d["extras"][0] for d in res.diagnostics if d["extras"]]
    assert its == [d["extras"][0] for d in eager.diagnostics if d["extras"]]
    assert res.iterations == eager.iterations == steps
    scale = eager.state.abs().max().item()
    assert (res.state - eager.state).abs().max().item() <= 1e-6 * scale


# K4's calls on the main paths: (a's shape, b's shape, axis, b transposed)
_K4_SHAPES = [((100, 100, 100), (100, 100), 2, True),  # the flagship collapse, M.T
              ((100, 100, 100), (100, 51), 2, False),  # the staged solve's x forward
              ((100, 100, 51), (51, 100), 2, False),   # and inverse
              ((100, 100, 51), (100, 100), 1, False),  # its y stage, per z
              ((100, 100, 51), (100, 100), 0, False),  # its z stage
              ((4, 64, 64, 64), (4, 65, 64), 3, True),  # a DCT sweep, one matrix per component
              ((16, 16, 16, 4), (16, 9), 2, False),    # the block solve's x stage, m = 4
              ((37, 19), (19, 45), 1, False),          # ragged
              ((2113, 129), (129, 136), 1, False)]     # two K chunks and two column tiles


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("a_shape,b_shape,axis,transposed", _K4_SHAPES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_k4_kernel_matches_plain(cuda, a_shape, b_shape, axis, transposed, precision):
    """K4 in three and one bf16 passes against its plain version (the same
    splits, fp32 sums in another order): within 1e-5 · max|plain|."""
    from circulantpreconditioner_tpu_torch.ops import tier_matmul as ttm

    rng = np.random.default_rng(16)
    a = torch.as_tensor(rng.normal(size=a_shape).astype(np.float32), device=cuda)
    b = torch.as_tensor(rng.normal(size=b_shape).astype(np.float32), device=cuda)
    b = b.transpose(-1, -2) if transposed else b
    before = ttm.TierMatmulKernel.launches
    o = ttm.tier_matmul(a, b, precision, axis)
    torch.cuda.synchronize()
    assert ttm.TierMatmulKernel.launches == before + 1
    p = ttm.tier_matmul_reference(a, b, precision, axis)
    assert o.shape == p.shape
    assert (o - p).abs().max().item() <= 1e-5 * p.abs().max().item()


@pytest.mark.gpu
def test_flagship_at_high_through_k4(cuda):
    """The 100³ dense collapse at "high": one K4 launch per solve, and the
    residual gate 1e-4 (the TPU's "high" gave 3.46e-5)."""
    from circulantpreconditioner_tpu_torch.ops import tier_matmul as ttm
    from circulantpreconditioner_tpu_torch.ops.spectral_collapse import make_circulant_solver

    n = 100
    lams = (0.0, 0.0, (1e3 / 3) / 6)
    s = make_circulant_solver((n,) * 3, lams, device=cuda, dtype=torch.float32,
                              precision="high")
    b = torch.as_tensor((np.random.default_rng(1).random((n,) * 3) * 50 + 600)
                        .astype(np.float32), device=cuda)
    before = ttm.TierMatmulKernel.launches
    x = s.solve(b)
    torch.cuda.synchronize()
    assert ttm.TierMatmulKernel.launches == before + 1
    op = CirculantTransportOperator.create((n,) * 3, lams, device=cuda, dtype=torch.float32)
    assert (torch.linalg.norm(op.matvec(x) - b) / torch.linalg.norm(b)).item() < 1e-4


@pytest.mark.gpu
def test_k4_split_kept_per_constant(cuda):
    """B is split once per constant and made anew when it changes in place."""
    from circulantpreconditioner_tpu_torch.ops import tier_matmul as ttm

    a = torch.ones(64, 16, device=cuda)
    m = torch.ones(16, 8, device=cuda)
    assert ttm._split_of(m.T.T) is ttm._split_of(m.T.T)
    m.mul_(2.0)
    torch.testing.assert_close(ttm.tier_matmul(a, m, "high"), torch.full((64, 8), 32.0,
                                                                         device=cuda))


@pytest.mark.gpu
def test_capture_failure_raises(cuda):
    """A step function that reads a device value on the host cannot be
    captured: the capture raises, and nothing falls back to eager runs. Last
    in the file: a failed capture may leave the allocator routing its
    stream's allocations to the abandoned pool."""
    from circulantpreconditioner_tpu_torch.utils.graphs import GraphSet

    x = torch.ones(8, device=cuda)
    graphs = GraphSet(cuda)
    with pytest.raises(RuntimeError):
        graphs.run("host read", lambda: x.mul_(float(x.sum().item())))
    assert len(graphs) == 0

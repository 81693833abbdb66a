"""Kernel K5 (ops/vcycle_sweep.py, csrc/vcycle_sweep.cu): the grid V-cycle's
coarse levels as fused sweeps.

On the CPU (tier 1): the fused stages in their plain versions, which CPU
tensors run, reproduce the V-cycle's generic stages (`_vcycle` on the same
hierarchy with its levels' stages set to the generic ones) in float64,
through `apply_fm` and the cell-major `apply`; the stages chosen at build
keep periodic (grid_last) levels, stencils of m > 8, the fine level and a
V-cycle without post-smoothing on the generic stages, and give a flat level
above a periodic one K5's; `STATS` counts every CPU visit of a level below
the fine one as plain and K5 launches nothing. The GPU tests (marker `gpu`,
skipped without a card) hold each K5 stage to its plain version in float32
and float64, on the Galerkin levels of Kershaw 16³, 32³ and 64³ wall meshes
(64³'s are the 32³ and 16³ levels of the main path), an odd grid (boxes
truncated at the far faces, cnt_inv ≠ 1/8) and a scalar (m = 1) transport
operator; a whole `apply_fm` and `apply` to the generic V-cycle; a flat
level above a periodic one; and a captured V-cycle's replays to its eager
run, bit for bit. The Kershaw levels are
flat-layout: their neighbours at the x and y edges wrap onto zero
coefficient layers, which both versions read.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_k5.py -q
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from circulantpreconditioner_tpu_torch.solvers import aggregation_pc as ap
from circulantpreconditioner_tpu_torch.utils.graphs import STATS

OMEGA = 0.8


def _wave_pc(n, device, dtype, bottom_max=600, n_smooth=(1, 1)):
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    model = WaveSystem(kershaw_mesh(((-0.5, 0.5),) * 3, n), cfl=1e3 / 3, device=device,
                       dtype=dtype)
    return ap.GridVCyclePC.from_grid_model(model.divergence, n, A0_apply=model.implicit_matvec(),
                                           A0_apply_fm=model.implicit_matvec_fm(),
                                           bottom_max=bottom_max, n_smooth=n_smooth, dtype=dtype)


def _transport_pc(n, device, dtype, bottom_max, n_smooth=(1, 1)):
    """A scalar (m = 1) hierarchy: the upwind transport operator on a
    Kershaw mesh as a BSR of 1×1 blocks."""
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import TransportEquation
    from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix

    model = TransportEquation(kershaw_mesh(((0.0, 1.0),) * 3, n), velocity=[1.0, 0.5, 0.25],
                              cfl=1e3 / 3, device=device, dtype=dtype)
    sp_ = model.divergence.to_scipy().tocoo()
    D = BSRMatrix.from_block_coo(sp_.shape[0], sp_.shape[1], sp_.row, sp_.col,
                                 sp_.data.reshape(-1, 1, 1), device=device, dtype=dtype)
    return ap.GridVCyclePC.from_grid_model(D, n, bottom_max=bottom_max, n_smooth=n_smooth,
                                           dtype=dtype)


# (name, hierarchy function, grid, bottom_max): Kershaw 16³ with two coarse levels, an
# odd grid whose boxes are truncated, and m = 1
_CPU_CASES = [("kershaw16", _wave_pc, (16, 16, 16), 60),
              ("odd", _wave_pc, (7, 6, 5), 20),
              ("scalar", _transport_pc, (9, 7, 5), 20)]


def _pc(case, device, dtype, n_smooth=(1, 1)):
    _, build, n, bottom_max = case
    return build(n, device, dtype, bottom_max=bottom_max, n_smooth=n_smooth)


def _coarse(pc):
    return [l for l, L in enumerate(pc.levels) if getattr(L, "stencil", None) is not None]


def _rand(n, device, dtype, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=n), device=device,
                           dtype=dtype)


def _unfused(pc):
    """The same hierarchy with the generic stages on every level."""
    plain = copy.copy(pc)
    plain.levels = tuple(dataclasses.replace(L, stages=ap._GRID) if L.stages is ap._K5 else L
                         for L in pc.levels)
    return plain


def _relerr(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


# --- CPU: the plain stages and the stages chosen at build ----------------------

@pytest.mark.parametrize("n_smooth", [(1, 1), (2, 3)])
@pytest.mark.parametrize("case", _CPU_CASES, ids=[c[0] for c in _CPU_CASES])
def test_fused_stages_compose_to_vcycle(case, n_smooth):
    pc = _pc(case, torch.device("cpu"), torch.float64, n_smooth)
    generic = _unfused(pc).levels
    coarse = _coarse(pc)
    assert coarse and all(pc.levels[l].stencil.layout == "flat" for l in coarse)
    for l in coarse:
        L = pc.levels[l]
        assert L.stages is ap._K5 and generic[l].stages is ap._GRID
        r = _rand(L.b * int(np.prod(L.shape_xyz)), "cpu", torch.float64, l)
        fused = ap._vcycle(pc.levels, pc.bot_inv, n_smooth, OMEGA, l, r)
        plain = ap._vcycle(generic, pc.bot_inv, n_smooth, OMEGA, l, r)
        assert _relerr(fused, plain) <= 1e-12


@pytest.mark.parametrize("case", _CPU_CASES, ids=[c[0] for c in _CPU_CASES])
def test_fused_path_through_both_applies(case):
    """apply_fm and the cell-major apply (one relayout pair around apply_fm)
    through the fused stages agree with the generic V-cycle; on the CPU,
    STATS counts every coarse visit as plain."""
    from circulantpreconditioner_tpu_torch.ops.vcycle_sweep import VCycleSweepKernel

    pc = _pc(case, torch.device("cpu"), torch.float64)
    generic = _unfused(pc)
    n = pc.b * int(np.prod(pc.levels[0].shape_xyz))
    g = _rand(n, "cpu", torch.float64, 3)
    STATS.reset()
    before = VCycleSweepKernel.launches
    assert _relerr(pc.apply_fm(g), generic.apply_fm(g)) <= 1e-12
    assert _relerr(pc.apply(g), generic.apply(g)) <= 1e-12
    visits = 2 * 2 * len(_coarse(pc))
    assert (STATS.vcycle_levels_fused, STATS.vcycle_levels_plain) == (0, visits)
    assert VCycleSweepKernel.launches == before


@pytest.mark.parametrize("case", _CPU_CASES, ids=[c[0] for c in _CPU_CASES])
def test_cpu_levels_take_the_plain_path(case):
    pc = _pc(case, torch.device("cpu"), torch.float64)
    g = _rand(pc.b * int(np.prod(pc.levels[0].shape_xyz)), "cpu", torch.float64, 4)
    STATS.reset()
    for _ in range(3):
        pc.apply_fm(g)
    below_fine = len(pc.levels) - 1
    assert (STATS.vcycle_levels_fused, STATS.vcycle_levels_plain) == (0, 3 * below_fine)
    assert STATS.snapshot()["vcycle_levels_plain"] == 3 * below_fine
    assert STATS.snapshot()["vcycle_levels_fused"] == 0


def test_odd_grid_truncates_boxes():
    """The odd case's premise: its last boxes hold fewer than 8 sites."""
    pc = _pc(_CPU_CASES[1], torch.device("cpu"), torch.float64)
    cnt = pc.levels[1].cnt_inv.reshape(-1)
    assert (cnt != 0.125).any() and (cnt == 0.125).any()


def test_dispatch_sends_what_k5_cannot_take_to_the_plain_path():
    """The stages each level gets when the hierarchy is built."""
    from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator

    f64, cpu = torch.float64, torch.device("cpu")
    levels = _wave_pc((16, 16, 16), cpu, f64, bottom_max=60).levels
    assert levels[1].stages is ap._K5 and levels[2].stages is ap._K5
    assert _wave_pc((16, 16, 16), cpu, f64, 60, (2, 3)).levels[1].stages is ap._K5
    assert levels[0].stages is ap._GRID  # the fine level (K2 and K6)
    # no post-smoothing sweep to carry the prolongation
    assert _wave_pc((16, 16, 16), cpu, f64, 60, (1, 0)).levels[1].stages is ap._GRID
    flat = levels[1].stencil
    assert ap._coarse_stages(flat, torch.float32, (1, 1)) is ap._GRID  # float64 coefficients
    # a periodic (grid_last) level: the 2-site y axis of the odd grid's first coarse level
    odd = _wave_pc((9, 4, 6), cpu, f64, bottom_max=20)
    assert odd.levels[1].stencil.layout == "grid_last" and odd.levels[1].stages is ap._GRID
    # m > 8 (a supercell-dense stencil)
    nz, ny, nx = flat.shape_zyx
    wide = VaryingStencilOperator.from_arrays(
        (nz, ny, nx), 9, flat.offsets, [np.zeros((9, 9, nz * ny * nx)) for _ in flat.offsets],
        "flat", device=cpu, dtype=f64)
    assert ap._coarse_stages(wide, f64, (1, 1)) is ap._GRID
    # the windowed levels of the algebraic V-cycle
    alg = ap._Level(A=None, Dinv=levels[1].Dinv, cnt_inv=levels[1].cnt_inv, n=8, b=4, factor=4,
                    n_agg=2)
    assert alg.stages is ap._CELL
    # a grid_last level no longer holds back the flat level above it
    assert [L.stages for L in _mixed_pc(cpu, f64).levels[1:]] == [ap._K5, ap._GRID]


def _mixed_pc(device, dtype):
    """A flat level above a periodic (grid_last) one: the (18, 8, 12) wave
    grid's levels 9×4×6 (flat) and 5×2×3 (grid_last)."""
    pc = _wave_pc((18, 8, 12), device, dtype, bottom_max=20)
    assert [L.stencil.layout for L in pc.levels[1:]] == ["flat", "grid_last"]
    return pc


def test_flat_level_above_grid_last_runs_fused_stages():
    """A grid_last level runs its stencil's field-major apply: the flat level
    above it runs the fused stages, as the generic ones would, and apply_fm
    equals the cell-major apply in the other layout."""
    f64 = torch.float64
    pc = _mixed_pc(torch.device("cpu"), f64)
    assert pc.levels[1].stages is ap._K5 and pc.levels[2].stages is ap._GRID
    g = _rand(4 * 18 * 8 * 12, "cpu", f64, 7)
    STATS.reset()
    assert _relerr(pc.apply(g), _unfused(pc).apply(g)) <= 1e-12
    assert (STATS.vcycle_levels_fused, STATS.vcycle_levels_plain) == (0, 4)
    z_fm = pc.apply_fm(g.reshape(-1, 4).T.reshape(-1)).reshape(4, -1).T.reshape(-1)
    assert _relerr(z_fm, pc.apply(g)) <= 1e-12


# --- GPU: the kernel against its plain versions --------------------------------
# Tolerance: K5 and the plain stages add A's terms in the same order and the
# box's 8 children in another; float32 contractions into FMAs move a value by
# a few ulp: 1e-5 · max|plain| in float32, 1e-12 in float64.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("runs on the card (K5 is a CUDA kernel): need a GPU "
                    "(torch.cuda.is_available() is False)")
    return torch.device("cuda")


_GPU_CASES = [("kershaw16", _wave_pc, (16, 16, 16), 60),
              ("kershaw32", _wave_pc, (32, 32, 32), 600),
              ("kershaw64", _wave_pc, (64, 64, 64), 600),
              ("odd", _wave_pc, (7, 6, 5), 20),
              ("scalar", _transport_pc, (9, 7, 5), 20)]
_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", _GPU_CASES, ids=[c[0] for c in _GPU_CASES])
def test_k5_stages_match_plain(cuda, case, dtype):
    from circulantpreconditioner_tpu_torch.ops import vcycle_sweep as vs

    pc = _pc(case, cuda, dtype)
    coarse = _coarse(pc)
    assert coarse
    tol = _TOL[dtype]
    for l in coarse:
        L = pc.levels[l]
        N, Nc = int(np.prod(L.shape_xyz)), int(np.prod(L.cshape_xyz))
        r, z = _rand(L.b * N, cuda, dtype, 1), _rand(L.b * N, cuda, dtype, 2)
        zc = _rand(L.b * Nc, cuda, dtype, 3)
        before = vs.VCycleSweepKernel.launches
        pairs = [(vs.smooth_cuda(L.Dinv, r, OMEGA), ap._grid_smooth_fm(L, OMEGA, r)),
                 (vs.sweep_cuda(L.stencil, L.Dinv, L.cshape_xyz, OMEGA, r, z),
                  ap._sweep_plain(L, OMEGA, r, z)),
                 (vs.restrict_cuda(L.stencil, L.cnt_inv, L.cshape_xyz, r, z),
                  ap._GRID.restrict(L, r, z)),
                 (vs.sweep_cuda(L.stencil, L.Dinv, L.cshape_xyz, OMEGA, r, z, zc),
                  ap._sweep_plain(L, OMEGA, r, z, zc))]
        torch.cuda.synchronize()
        assert vs.VCycleSweepKernel.launches == before + 4
        for got, want in pairs:
            assert _relerr(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", _GPU_CASES, ids=[c[0] for c in _GPU_CASES])
def test_k5_applies_match_plain_vcycle(cuda, case, dtype):
    """apply_fm and the cell-major apply through K5 against the same
    hierarchy on the generic stages; three K5 launches per coarse level and
    every coarse visit fused."""
    from circulantpreconditioner_tpu_torch.ops.vcycle_sweep import VCycleSweepKernel

    pc = _pc(case, cuda, dtype)
    g = _rand(pc.b * int(np.prod(pc.levels[0].shape_xyz)), cuda, dtype, 5)
    STATS.reset()
    before = VCycleSweepKernel.launches
    fused_fm, fused_cm = pc.apply_fm(g), pc.apply(g)
    torch.cuda.synchronize()
    n_coarse = len(_coarse(pc))
    assert VCycleSweepKernel.launches == before + 2 * 3 * n_coarse
    assert (STATS.vcycle_levels_fused, STATS.vcycle_levels_plain) == (2 * n_coarse, 0)
    generic = _unfused(pc)
    tol = 10 * _TOL[dtype]  # the whole V-cycle: the stages' rounding, carried through
    assert _relerr(fused_fm, generic.apply_fm(g)) <= tol
    assert _relerr(fused_cm, generic.apply(g)) <= tol


@pytest.mark.gpu
def test_k5_runs_a_level_above_grid_last(cuda):
    """On the card, K5 runs a flat level above a periodic one (three
    launches), the periodic level the generic stages; the apply as on the
    generic stages."""
    from circulantpreconditioner_tpu_torch.ops.vcycle_sweep import VCycleSweepKernel

    pc = _mixed_pc(cuda, torch.float32)
    g = _rand(4 * 18 * 8 * 12, cuda, torch.float32, 8)
    STATS.reset()
    before = VCycleSweepKernel.launches
    out = pc.apply(g)
    torch.cuda.synchronize()
    assert VCycleSweepKernel.launches == before + 3
    assert (STATS.vcycle_levels_fused, STATS.vcycle_levels_plain) == (1, 1)
    assert _relerr(out, _unfused(pc).apply(g)) <= 10 * _TOL[torch.float32]


@pytest.mark.gpu
def test_k5_captured_vcycle_replays_bit_for_bit(cuda):
    """A V-cycle captured in a GraphSet replays its eager warm-up's answer
    bit for bit; each replay adds its K5 launches and level visits."""
    from circulantpreconditioner_tpu_torch.ops.vcycle_sweep import VCycleSweepKernel
    from circulantpreconditioner_tpu_torch.utils.graphs import GraphSet

    pc = _wave_pc((32, 32, 32), cuda, torch.float32)
    g = _rand(4 * 32 ** 3, cuda, torch.float32, 6)
    out = torch.zeros_like(g)
    graphs = GraphSet(cuda)
    STATS.reset()
    before = VCycleSweepKernel.launches
    graphs.run("vc", lambda: out.copy_(pc.apply_fm(g)))  # the eager warm-up, then the capture
    eager = out.clone()
    assert VCycleSweepKernel.launches == before + 3 and STATS.vcycle_levels_fused == 1
    for _ in range(5):
        out.zero_()
        graphs.run("vc", lambda: out.copy_(pc.apply_fm(g)))
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert VCycleSweepKernel.launches == before + 18
    assert (STATS.vcycle_levels_fused, STATS.vcycle_levels_plain) == (6, 0)


@pytest.mark.gpu
def test_k5_wrapper_rejects_what_it_cannot_take(cuda):
    from circulantpreconditioner_tpu_torch.ops import vcycle_sweep as vs

    pc = _wave_pc((16, 16, 16), cuda, torch.float32, bottom_max=60)
    L = pc.levels[1]
    N = int(np.prod(L.shape_xyz))
    r = torch.ones(4 * N, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        vs.smooth_cuda(L.Dinv, r.cpu(), OMEGA)
    with pytest.raises(ValueError, match="float64"):
        vs.restrict_cuda(L.stencil, L.cnt_inv, L.cshape_xyz, r.double(), r.double())
    with pytest.raises(ValueError, match="values"):
        vs.sweep_cuda(L.stencil, L.Dinv, L.cshape_xyz, OMEGA, r, r[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        vs.sweep_cuda(L.stencil, L.Dinv, L.cshape_xyz, OMEGA, r,
                      torch.ones(2 * 4 * N, device=cuda)[::2])
    with pytest.raises(ValueError, match="boxes"):
        vs.restrict_cuda(L.stencil, L.cnt_inv, (3, 4, 4), r, r)

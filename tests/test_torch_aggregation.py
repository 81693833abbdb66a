"""The port's AggregationVCyclePC (the algebraic aggregation V-cycle) and the
supercell level of GridVCyclePC (cells_per_site = 6, the tet meshes) against
the JAX package on Kershaw and Kershaw-tet wave systems (float64 on the CPU,
the same NumPy inputs).

Tolerances:
- the hierarchy: level sizes equal, Dinv, cnt_inv and bot_inv to 1e-12 ×
  their largest entry (both assemble D and invert in float64; the two
  packages' D differ by an ulp in places, which the inverses carry);
- one V-cycle apply: 1e-10 × max|z_JAX|;
- right-preconditioned GMRES: the same iteration count, x within
  1e-10 × max|x|.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_tet_mesh as j_ktet
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.models.wave import _identity_plus as j_identity_plus
from circulantpreconditioner_tpu.solvers import make_gmres as j_make_gmres
from circulantpreconditioner_tpu.solvers.aggregation_pc import AggregationVCyclePC as JAgg
from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC as JGrid
from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh as t_kershaw
from circulantpreconditioner_tpu_torch.mesh import kershaw_tet_mesh as t_ktet
from circulantpreconditioner_tpu_torch.models import WaveSystem as TWave
from circulantpreconditioner_tpu_torch.models.transport import _identity_plus as t_identity_plus
from circulantpreconditioner_tpu_torch.solvers import AggregationVCyclePC as TAgg
from circulantpreconditioner_tpu_torch.solvers import make_gmres as t_make_gmres
from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC as TGrid
from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import (
    _GridLevel,
    _Level,
    _prolong,
    _prolong_fm,
    _restrict,
    _restrict_fm,
    _smooth,
    _smooth_fm,
)

CPU = torch.device("cpu")
BOUNDS = ((-0.5, 0.5),) * 3


def _models(n):
    mj = JWave(j_kershaw(BOUNDS, (n,) * 3), cfl=1e3 / 3, dtype=jnp.float64)
    mt = TWave(t_kershaw(BOUNDS, (n,) * 3), cfl=1e3 / 3, device=CPU, dtype=torch.float64)
    return mj, mt


def _pcs(mj, mt, fine_apply=True, **kw):
    pj = JAgg.from_bsr(mj.divergence, A0_apply=mj.implicit_matvec() if fine_apply else None,
                       shift=1.0, dtype=jnp.float64, **kw)
    pt = TAgg.from_bsr(mt.divergence, A0_apply=mt.implicit_matvec() if fine_apply else None,
                       shift=1.0, dtype=torch.float64, **kw)
    return pj, pt


def _close(x, ref, tol):
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_transfers_are_partition_of_unity():
    """R·P = I for the mean restriction and the piecewise-constant
    prolongation, with a ragged last aggregate, as the JAX package's."""
    n, b, factor = 11, 4, 4
    n_agg = -(-n // factor)
    cnt = np.bincount(np.arange(n) // factor, minlength=n_agg).astype(float)
    L = _Level(A=None, Dinv=torch.zeros((n, b, b)), cnt_inv=torch.as_tensor(1.0 / cnt),
               n=n, b=b, factor=factor, n_agg=n_agg)
    rng = np.random.default_rng(0)
    zc = torch.as_tensor(rng.standard_normal(n_agg * b))
    _close(_restrict(L, _prolong(L, zc)), zc.numpy(), 1e-15)
    r = rng.standard_normal(n * b)
    want = np.stack([r.reshape(n, b)[k * factor:(k + 1) * factor].mean(0) for k in range(n_agg)])
    _close(_restrict(L, torch.as_tensor(r)), want.reshape(-1), 1e-15)


@pytest.mark.parametrize("n,bottom_max,levels", [(8, 200, 2), (12, 1200, 2), (12, 100, 4)])
def test_hierarchy_and_apply_match_jax(n, bottom_max, levels):
    mj, mt = _models(n)
    pj, pt = _pcs(mj, mt, bottom_max=bottom_max)
    assert pt.n_levels == pj.n_levels == levels
    for Lj, Lt in zip(pj.levels, pt.levels):
        assert (Lt.n, Lt.b, Lt.factor, Lt.n_agg) == (Lj.n, Lj.b, Lj.factor, Lj.n_agg)
        _close(Lt.Dinv, Lj.Dinv, 1e-12)
        _close(Lt.cnt_inv, Lj.cnt_inv, 1e-15)
    _close(pt.bot_inv, pj.bot_inv, 1e-12)
    r = np.random.default_rng(1).standard_normal(mj.divergence.shape[0])
    _close(pt.apply(torch.as_tensor(r)), jax.jit(pj.apply)(jnp.asarray(r)), 1e-10)


def test_windowed_fine_level_matches_jax():
    """A0_apply=None: the fine level is the clustered-window operator of D."""
    mj, mt = _models(8)
    pj, pt = _pcs(mj, mt, fine_apply=False, bottom_max=100)
    assert pt.n_levels == pj.n_levels == 3
    r = np.random.default_rng(2).standard_normal(mj.divergence.shape[0])
    _close(pt.levels[0].A(torch.as_tensor(r)), mj.implicit_matvec()(jnp.asarray(r)), 1e-12)
    _close(pt.apply(torch.as_tensor(r)), jax.jit(pj.apply)(jnp.asarray(r)), 1e-10)


def test_bottom_only_hierarchy_is_exact_inverse():
    mj, mt = _models(4)
    pt = TAgg.from_bsr(mt.divergence, shift=1.0, bottom_max=10**6)
    assert pt.n_levels == 1
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(mt.divergence.shape[0]))
    x = pt.apply(r)
    assert (torch.linalg.norm(mt.implicit_matvec()(x) - r) / torch.linalg.norm(r)).item() < 1e-10


@pytest.mark.parametrize("n", [8, 12])
def test_gmres_iterations_equal_jax(n):
    """Right-preconditioned GMRES on I + D at cfl 1e3/3, as the drivers'
    --pc aggvcycle runs it."""
    mj, mt = _models(n)
    pj, pt = _pcs(mj, mt)
    rj = j_make_gmres(mj.implicit_matvec(), pj.apply_partial(), side="right")(
        mj.initial_state(), mj.initial_state())
    U0 = mt.initial_state()
    rt = t_make_gmres(mt.implicit_matvec(), pt.apply, side="right")(U0, U0)
    assert bool(rj.converged) and rt.converged
    assert rt.iters == int(rj.iters)
    _close(rt.x, rj.x, 1e-10)


# --- GridVCyclePC with cells_per_site = 6: the tet meshes' supercell level ---

UNIT = ((0.0, 1.0),) * 3


def _tet_models(n, cfl=1e3 / 3):
    mj = JWave(j_ktet(UNIT, (n,) * 3), cfl=cfl, dtype=jnp.float64)
    mt = TWave(t_ktet(UNIT, (n,) * 3), cfl=cfl, device=CPU, dtype=torch.float64)
    return mj, mt


def _tet_grid_pcs(mj, mt, route, **kw):
    """The two ways the JAX package builds the supercell V-cycle. "drv": its
    wave_implicit driver (the model's cell-major dense supercell matvec, no
    field-major one, so from_grid_model builds its own dense op0; the port's
    model gives the block-sparse one in both layouts); "bench":
    bench_suite.py's Kershaw-tet rung (the block-sparse supercell operator,
    field-major, as both fine-level applies)."""
    if route == "drv":
        aj = dict(A0_apply=mj.implicit_matvec(), A0_apply_fm=mj.implicit_matvec_fm())
        at = dict(A0_apply=mt.implicit_matvec(), A0_apply_fm=mt.implicit_matvec_fm())
    else:
        A_fm_j = jax.tree_util.Partial(j_identity_plus, mj.divergence_op_fm(flat=True))
        A_fm_t = functools.partial(t_identity_plus, mt.divergence_op_fm(flat=True))
        aj, at = dict(A0_apply=A_fm_j, A0_apply_fm=A_fm_j), dict(A0_apply=A_fm_t, A0_apply_fm=A_fm_t)
    pj = JGrid.from_grid_model(mj.divergence, mj.mesh.topology_shape, cells_per_site=6,
                               shift=1.0, dtype=jnp.float64, **aj, **kw)
    pt = TGrid.from_grid_model(mt.divergence, mt.mesh.topology_shape, cells_per_site=6,
                               shift=1.0, dtype=torch.float64, **at, **kw)
    return pj, pt


def test_supercell_level_transfers():
    """The field-major aggregation transfers of a supercell level: R·P = I,
    and each is its cell-major counterpart in the other layout."""
    n_agg, factor, b = 5, 6, 4
    rng = np.random.default_rng(6)
    Dinv = torch.as_tensor(rng.standard_normal((n_agg * factor, b, b)))
    L = _Level(A=None, Dinv=Dinv, cnt_inv=torch.full((n_agg,), 1.0 / factor, dtype=torch.float64),
               n=n_agg * factor, b=b, factor=factor, n_agg=n_agg)
    zc = torch.as_tensor(rng.standard_normal(n_agg * b))
    _close(_restrict_fm(L, _prolong_fm(L, zc)), zc.numpy(), 1e-15)
    r = torch.as_tensor(rng.standard_normal(n_agg * factor * b))
    to_fm = lambda v, rows: v.reshape(-1, rows).T.reshape(-1)  # noqa: E731
    _close(_restrict_fm(L, to_fm(r, factor * b)), to_fm(_restrict(L, r), b).numpy(), 1e-15)
    _close(_prolong_fm(L, to_fm(zc, b)), to_fm(_prolong(L, zc), factor * b).numpy(), 1e-15)
    _close(_smooth_fm(L, 0.8, to_fm(r, factor * b)), to_fm(_smooth(L, 0.8, r), factor * b).numpy(),
           1e-14)


@pytest.mark.parametrize("route", ["drv", "bench"])
def test_supercell_grid_vcycle_matches_jax(route):
    """The hierarchy (a supercell aggregation level, then 2×2×2 grid levels)
    and one apply in each layout, against the JAX package's, by both of its
    routes."""
    mj, mt = _tet_models(6)
    pj, pt = _tet_grid_pcs(mj, mt, route, bottom_max=30)
    assert pt.n_levels == pj.n_levels == 3
    assert isinstance(pt.levels[0], _Level) and isinstance(pt.levels[1], _GridLevel)
    L0 = pt.levels[0]
    assert (L0.n, L0.b, L0.factor, L0.n_agg) == (6 * 216, 4, 6, 216)
    assert L0.A_fm is not None
    for Lj, Lt in zip(pj.levels, pt.levels):
        _close(Lt.Dinv, Lj.Dinv, 1e-12)
        _close(Lt.cnt_inv, Lj.cnt_inv, 1e-15)
    # the port keeps its bottom field-major: JAX's with rows and columns permuted
    fm = np.arange(pj.bot_inv.shape[0]).reshape(-1, 4).T.reshape(-1)
    _close(pt.bot_inv, np.asarray(pj.bot_inv)[np.ix_(fm, fm)], 1e-12)
    r = np.random.default_rng(7).standard_normal(mj.divergence.shape[0])
    g = mt.pack_fm(torch.as_tensor(r)).reshape(-1)
    _close(pt.apply_fm(g), jax.jit(pj.apply_fm)(jnp.asarray(g.numpy())), 1e-10)
    if route == "drv":  # the cell-major apply is the driver's
        _close(pt.apply(torch.as_tensor(r)), jax.jit(pj.apply)(jnp.asarray(r)), 1e-10)


def test_supercell_grid_vcycle_fm_matches_cell_major():
    """apply_fm on the supercell layout equals apply, as the JAX package's
    tests/test_aggregation_pc.py::test_grid_vcycle_fm_matches_cell_major
    holds it (there in float32 to 2e-4; here in float64)."""
    _, mt = _tet_models(6)
    pc = TGrid.from_grid_model(mt.divergence, mt.mesh.topology_shape, cells_per_site=6,
                               shift=1.0, bottom_max=30)
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(mt.divergence.shape[0]))
    z_fm = pc.apply_fm(mt.pack_fm(r).reshape(-1))
    _close(mt.unpack_fm(z_fm.reshape(mt.fm_block, -1)), pc.apply(r).numpy(), 1e-12)


@pytest.mark.parametrize("route", ["drv", "bench"])
def test_supercell_gmres_iterations_equal_jax(route):
    """Right-preconditioned GMRES + the supercell grid V-cycle on Kershaw-tet
    8³ at cfl 1e3/3: "drv" as the JAX wave_implicit driver runs it (cell-major
    GMRES over the dense supercell matvec, the cell-major cycle), "bench" as
    bench_suite.py's Kershaw-tet rung (field-major GMRES over the block-sparse
    operator, apply_fm)."""
    mj, mt = _tet_models(8)
    pj, pt = _tet_grid_pcs(mj, mt, route)
    U0j, U0t = mj.initial_state(), mt.initial_state()
    if route == "drv":
        rj = j_make_gmres(mj.implicit_matvec(), pj.apply_partial(), side="right")(U0j, U0j)
        rt = t_make_gmres(mt.implicit_matvec(), pt.apply, side="right")(U0t, U0t)
        xt = rt.x
    else:
        A_j = jax.tree_util.Partial(j_identity_plus, mj.divergence_op_fm(flat=True))
        G0j = mj.pack_fm(np.asarray(U0j)).reshape(-1)
        rj = j_make_gmres(A_j, pj.apply_fm_partial(), side="right")(G0j, G0j)
        rj = type("R", (), dict(converged=rj.converged, iters=rj.iters,
                                x=mj.unpack_fm(rj.x)))
        A_t = functools.partial(t_identity_plus, mt.divergence_op_fm(flat=True))
        G0t = mt.pack_fm(U0t).reshape(-1)
        rt = t_make_gmres(A_t, pt.apply_fm, side="right")(G0t, G0t)
        xt = mt.unpack_fm(rt.x)
    assert bool(rj.converged) and rt.converged
    assert rt.iters == int(rj.iters)
    _close(xt, rj.x, 1e-10)

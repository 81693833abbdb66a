"""The port's AggregationVCyclePC (the algebraic aggregation V-cycle) against
the JAX package on Kershaw wave systems (float64 on the CPU, the same NumPy
inputs).

Tolerances:
- the hierarchy: level sizes equal, Dinv, cnt_inv and bot_inv to 1e-12 ×
  their largest entry (both assemble D and invert in float64; the two
  packages' D differ by an ulp in places, which the inverses carry);
- one V-cycle apply: 1e-10 × max|z_JAX|;
- right-preconditioned GMRES: the same iteration count, x within
  1e-10 × max|x|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.solvers import make_gmres as j_make_gmres
from circulantpreconditioner_tpu.solvers.aggregation_pc import AggregationVCyclePC as JAgg
from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh as t_kershaw
from circulantpreconditioner_tpu_torch.models import WaveSystem as TWave
from circulantpreconditioner_tpu_torch.solvers import AggregationVCyclePC as TAgg
from circulantpreconditioner_tpu_torch.solvers import make_gmres as t_make_gmres
from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import (
    _Level,
    _prolong,
    _restrict,
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

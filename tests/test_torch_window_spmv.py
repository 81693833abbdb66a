"""The port's clustered-window SpMV (ops/window_spmv.py) against the JAX
package in float64 on the CPU: the same source units and windows, matvec and
matvec_multi, the drop-in divergence operators, and the window selection of
the projection preconditioners.

Tolerances: src and W equal entry for entry (the same host build); applies
1e-12 × max|reference| (the same float64 products, summed in another
order)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.csr import BSRMatrix as JBSR
from circulantpreconditioner_tpu.ops.csr import CSRMatrix as JCSR
from circulantpreconditioner_tpu.ops.window_spmv import WindowedBlockOperator as JWin
from circulantpreconditioner_tpu.solvers import circulant_pc as jpc
from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix as TBSR
from circulantpreconditioner_tpu_torch.ops.csr import CSRMatrix as TCSR
from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator as TWin
from circulantpreconditioner_tpu_torch.solvers import circulant_pc as tpc

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)


def _close(x_torch, x_ref, tol=1e-12):
    x_ref = np.asarray(x_ref)
    x = x_torch.numpy()
    assert x.shape == x_ref.shape
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=tol * max(np.abs(x_ref).max(), 1.0))


def _same_layout(t, j):
    assert (t.n_brows, t.b, t.G, t.unit, t.n_bcols) == (j.n_brows, j.b, j.G, j.unit, j.n_bcols)
    np.testing.assert_array_equal(t.src.numpy(), np.asarray(j.src))
    np.testing.assert_array_equal(t.W.numpy(), np.asarray(j.W))
    assert t.shape == j.shape and t.window_bytes == j.window_bytes


@pytest.mark.parametrize("n,b,G,unit", [(37, 1, 8, 1), (64, 4, 8, 2), (100, 4, 16, 4),
                                        (129, 2, 8, 2), (41, 3, 8, None)])
def test_block_windows_match_jax(n, b, G, unit):
    rng = np.random.default_rng(n)
    rows, cols = [], []
    for i in range(n):
        for j in np.unique(np.clip(i + rng.integers(-9, 10, rng.integers(1, 6)), 0, n - 1)):
            rows.append(i)
            cols.append(int(j))
    blocks = rng.standard_normal((len(rows), b, b))
    Aj = JBSR.from_block_coo(n, n, rows, cols, blocks, dtype=jnp.float64)
    At = TBSR.from_block_coo(n, n, rows, cols, blocks, **F64)
    Wj, Wt = JWin.from_bsr(Aj, G=G, unit=unit), TWin.from_bsr(At, G=G, unit=unit)
    _same_layout(Wt, Wj)
    x = rng.standard_normal(n * b)
    _close(Wt.matvec(torch.as_tensor(x)), Wj.matvec(jnp.asarray(x)))
    _close(Wt(torch.as_tensor(x)), At.matvec(torch.as_tensor(x)).numpy())


def test_rectangular_multivector_matches_jax():
    rng = np.random.default_rng(7)
    n_rows, n_cols, m = 53, 131, 4
    dens = sp.random(n_rows, n_cols, density=0.08, random_state=3, format="csr")
    dens.data[:] = rng.standard_normal(dens.nnz)
    Wj = JWin.from_csr(JCSR.from_scipy(dens, dtype=jnp.float64), G=8, unit=8)
    Wt = TWin.from_csr(TCSR.from_scipy(dens, **F64), G=8, unit=8)
    _same_layout(Wt, Wj)
    x, X = rng.standard_normal(n_cols), rng.standard_normal((n_cols, m))
    _close(Wt.matvec(torch.as_tensor(x)), Wj.matvec(jnp.asarray(x)))
    _close(Wt.matvec_multi(torch.as_tensor(X)), Wj.matvec_multi(jnp.asarray(X)))
    _close(Wt.matvec_multi(torch.as_tensor(X)), dens @ X)
    # the CSR multivector matvec (the projection's fallback form) agrees too
    _close(TCSR.from_scipy(dens, **F64).matvec(torch.as_tensor(X)), dens @ X)


def test_empty_cluster_points_at_own_unit():
    rows = np.array([0, 1, 30, 31])
    blocks = np.ones((4, 1, 1))
    Wj = JWin.from_block_coo(32, rows, rows, blocks, G=8, unit=2, dtype=jnp.float64)
    Wt = TWin.from_block_coo(32, rows, rows, blocks, G=8, unit=2, **F64)
    _same_layout(Wt, Wj)
    assert Wt.src[1].min() >= 4 and Wt.src[2].min() >= 8


def test_divergence_window_operators_match_jax():
    """divergence_op('window') of both models, on a Kershaw mesh."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as jk
    from circulantpreconditioner_tpu.models import TransportEquation as JTr
    from circulantpreconditioner_tpu.models import WaveSystem as JWave
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh as tk
    from circulantpreconditioner_tpu_torch.models import TransportEquation as TTr
    from circulantpreconditioner_tpu_torch.models import WaveSystem as TWave

    bounds, n = ((-0.5, 0.5),) * 3, (5, 4, 3)
    rng = np.random.default_rng(5)
    mj = JWave(jk(bounds, n), cfl=1.0, dtype=jnp.float64)
    mt = TWave(tk(bounds, n), cfl=1.0, **F64)
    x = rng.standard_normal(60 * 4)
    _close(mt.divergence_op("window")(torch.as_tensor(x)),
           mj.divergence_op("window")(jnp.asarray(x)))
    tj = JTr(jk(bounds, n), (1.0, 0.3, 0.0), cfl=2.0, dtype=jnp.float64)
    tt = TTr(tk(bounds, n), (1.0, 0.3, 0.0), cfl=2.0, **F64)
    x = rng.standard_normal(60)
    for op in ("window", "varying", "matrix"):
        _close(tt.divergence_op(op)(torch.as_tensor(x)), tj.divergence_op(op)(jnp.asarray(x)))


@pytest.mark.parametrize("max_bytes", [256 * 2**20, 4096, 0])
def test_window_selection_matches_jax(max_bytes):
    """_try_window keeps the window form exactly where the JAX package does."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as jk
    from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh as tk

    bounds, n = ((-0.5, 0.5),) * 3, (6, 6, 6)
    mj, mt = jk(bounds, n), tk(bounds, n)
    n_xyz, _, _, bbox = tpc.derive_grid_context(mt, [0.0] * 3, 0.1)
    Pj, Pbj = jpc.build_projection_matrices(mj, n_xyz, bbox, dtype=jnp.float64)
    Pt, Pbt = tpc.build_projection_matrices(mt, n_xyz, bbox, **F64)
    for j, t in ((Pj, Pt), (Pbj, Pbt)):
        wj, wt = jpc._try_window(j, max_bytes), tpc._try_window(t, max_bytes)
        assert (wj is None) == (wt is None)
        if wt is not None:
            _same_layout(wt, wj)

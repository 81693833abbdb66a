"""The port's supercell stencils on tet meshes (6 cells per grid site)
against the JAX package: the dense supercell VaryingStencilOperator (M = 24
for the wave system, applied by one contraction per offset; M = 6 for the scalar
transport and diffusion operators, unrolled) and the block-sparse
SupercellStencilOperator, for the wave, transport and diffusion models, in
the three layouts (cell-major `matvec`, field-major `matvec_fm`, and its flat
`matvec_fm_flat`), and the wave model's supercell routes.

Float64 on the CPU, the same NumPy inputs on both sides. Tolerance 1e-12 ×
max|reference|: the same float64 coefficients (equal bit for bit), summed in
another order (the batched supercell contraction sums a sub-row's terms in
one reduction, the JAX package one by one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import circulantpreconditioner_tpu.mesh.unstructured as ju
import circulantpreconditioner_tpu.models as jm
import circulantpreconditioner_tpu_torch.mesh.unstructured as tu
import circulantpreconditioner_tpu_torch.models as tm
from circulantpreconditioner_tpu.ops import stencil as js
from circulantpreconditioner_tpu_torch.ops import stencil as ts

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
TOL = 1e-12
UNIT = ((0.0, 1.0),) * 3


def _close(x, ref, tol=TOL):
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-300))


def _models(kind, n=(3, 3, 4), family="kershaw_tet_mesh", periodic=False):
    """(JAX model, port model, m) of `kind` on the same tet mesh. An extent
    of 2 couples a site to one neighbour from both sides (the wrap), which
    takes the grid_last layout; 3 and more keep the flat one."""
    mj, mt = getattr(ju, family)(UNIT, n), getattr(tu, family)(UNIT, n)
    if periodic:
        mj.set_periodic()
        mt.set_periodic()
    if kind == "wave":
        return jm.WaveSystem(mj, cfl=10.0, dtype=jnp.float64), tm.WaveSystem(mt, cfl=10.0, **F64), 4
    if kind == "transport":
        v = [1.0, 0.5, -0.2]
        return (jm.TransportEquation(mj, velocity=v, cfl=3.0, dtype=jnp.float64),
                tm.TransportEquation(mt, velocity=v, cfl=3.0, **F64), 1)
    return (jm.DiffusionEquation(mj, nu=0.5, cfl=20.0, dtype=jnp.float64),
            tm.DiffusionEquation(mt, nu=0.5, cfl=20.0, **F64), 1)


def _varying(model_j, model_t, m):
    build_j = js.VaryingStencilOperator.from_bsr if m > 1 else js.VaryingStencilOperator.from_csr
    build_t = ts.VaryingStencilOperator.from_bsr if m > 1 else ts.VaryingStencilOperator.from_csr
    shape = model_t.mesh.topology_shape
    return (build_j(model_j.divergence, shape, cells_per_site=6),
            build_t(model_t.divergence, shape, cells_per_site=6))


def _check_layouts(op_t, op_j, M, n_sites, rng):
    """matvec, matvec_fm and matvec_fm_flat against the JAX operator's."""
    x = rng.standard_normal(M * n_sites)
    _close(op_t.matvec(torch.as_tensor(x)), op_j.matvec(jnp.asarray(x)))
    g = x.reshape(-1, M).T.copy()
    _close(op_t.matvec_fm(torch.as_tensor(g)), op_j.matvec_fm(jnp.asarray(g)))
    _close(op_t.matvec_fm_flat(torch.as_tensor(g.reshape(-1))),
           op_j.matvec_fm_flat(jnp.asarray(g.reshape(-1))))
    # and the field-major form is the cell-major one in the other layout
    _close(op_t.matvec_fm(torch.as_tensor(g)).T.reshape(-1), op_t.matvec(torch.as_tensor(x)))


@pytest.mark.parametrize("kind", ["wave", "transport", "diffusion"])
def test_dense_supercell_varying_matches_jax(kind):
    wj, wt, m = _models(kind)
    Vj, Vt = _varying(wj, wt, m)
    assert Vt.m == Vj.m == 6 * m and Vt.layout == Vj.layout == "flat"
    assert Vt.offsets == Vj.offsets
    for a, b in zip(Vt.coefs, Vj.coefs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # the same coefficients
    rng = np.random.default_rng(0)
    _check_layouts(Vt, Vj, 6 * m, int(np.prod(wt.mesh.topology_shape)), rng)
    x = rng.standard_normal(6 * m * int(np.prod(wt.mesh.topology_shape)))
    _close(Vt.matvec(torch.as_tensor(x)), wt.divergence.matvec(torch.as_tensor(x)))


@pytest.mark.parametrize("kind", ["wave", "transport", "diffusion"])
def test_block_sparse_supercell_matches_jax(kind):
    wj, wt, m = _models(kind)
    Vj, Vt = _varying(wj, wt, m)
    Sj = js.SupercellStencilOperator.from_varying(Vj, m, 6)
    St = ts.SupercellStencilOperator.from_varying(Vt, m, 6)
    assert (St.offsets, St.pair_idx, St.M) == (Sj.offsets, Sj.pair_idx, Sj.M)
    rng = np.random.default_rng(1)
    _check_layouts(St, Sj, 6 * m, int(np.prod(wt.mesh.topology_shape)), rng)
    x = rng.standard_normal(6 * m * int(np.prod(wt.mesh.topology_shape)))
    _close(St.matvec(torch.as_tensor(x)), Vt.matvec(torch.as_tensor(x)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_host_decomposition_is_the_dense_ones(dtype):
    """SupercellStencilOperator.from_bsr, the wave model's, decomposes D's
    blocks on the host without the dense form: the same offsets, sub-blocks,
    tables and coefficients, bit for bit, as from_varying on the dense
    VaryingStencilOperator; and on a periodic tet mesh (grid_last) neither
    has a block-sparse form."""
    mesh = tu.kershaw_tet_mesh(UNIT, (4, 3, 5))
    wt = tm.WaveSystem(mesh, cfl=10.0, device=CPU, dtype=dtype)
    St = ts.SupercellStencilOperator.from_bsr(wt.divergence, mesh.topology_shape, 6)
    Sv = ts.SupercellStencilOperator.from_varying(wt.varying_operator, 4, 6)
    assert (St.offsets, St.pair_idx, St.M) == (Sv.offsets, Sv.pair_idx, Sv.M)
    for a, b in zip(St.rows + St.cols + St.coefs, Sv.rows + Sv.cols + Sv.coefs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the model's operator, the normal form of the same blocks: the same pairs
    Sn = wt.supercell_operator
    assert {(0, k, k) for k in range(6)} | {
        (o, k, c) for k in range(6) for o, c in zip(Sn.slot_offset[k], Sn.slot_col[k])} == {
        (o, r, c) for o, pairs in zip(St.offsets, St.pair_idx) for r, c in pairs}
    _, wp, _ = _models("wave", n=(3, 2, 3), family="tet_mesh", periodic=True)
    assert ts.SupercellStencilOperator.from_bsr(wp.divergence, wp.mesh.topology_shape, 6) is None


def test_supercell_sub_block_pattern():
    """The 6-tet split of a hex: 18 of the 36 diagonal sub-blocks (each tet,
    its two face neighbours in the ring about the 0-6 diagonal), and 2 per
    face-neighbour offset (the two triangles of the shared hex face): 30
    pairs. Padding is needed nowhere."""
    wj, wt, m = _models("wave", n=(3, 3, 3))
    St = ts.SupercellStencilOperator.from_varying(_varying(wj, wt, m)[1], m, 6)
    counts = dict(zip(St.offsets, map(len, St.pair_idx)))
    assert counts.pop(0) == 18 and sorted(counts.values()) == [2] * 6
    for pairs, cols, C in zip(St.pair_idx, St.cols, St.coefs):
        assert C.shape[:2] == cols.shape and C.shape[0] * C.shape[1] == len(pairs)
    # not flat, or not M = m·g: no block-sparse form
    assert ts.SupercellStencilOperator.from_varying(_varying(wj, wt, m)[1], m, 3) is None


def test_dense_einsum_apply_equals_unrolled():
    """M = 24 > _UNROLL_MAX: one contraction per offset; the unrolled m² form
    computes the same sums."""
    wj, wt, m = _models("wave", n=(2, 3, 2))
    Vt = _varying(wj, wt, m)[1]
    unrolled = ts.VaryingStencilOperator(Vt.shape_zyx, Vt.m, Vt.offsets, Vt.coefs, Vt.layout)
    unrolled._UNROLL_MAX = Vt.m
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(24 * 12))
    _close(Vt.matvec(x), unrolled.matvec(x))


@pytest.mark.parametrize("kind,n", [("transport", (2, 2, 2)), ("wave", (3, 2, 3))])
def test_periodic_tets_take_grid_last(kind, n):
    """set_periodic on a tet mesh: the wraps couple sites across the grid,
    so the supercell stencil takes the grid_last layout (per-axis rolls), as
    in the JAX package; no block-sparse form then."""
    wj, wt, m = _models(kind, n=n, family="tet_mesh", periodic=True)
    Vj, Vt = _varying(wj, wt, m)
    assert Vt.layout == Vj.layout == "grid_last" and Vt.offsets == Vj.offsets
    rng = np.random.default_rng(3)
    x = rng.standard_normal(wt.mesh.n_cells * m)
    _close(Vt.matvec(torch.as_tensor(x)), Vj.matvec(jnp.asarray(x)))
    _close(Vt.matvec(torch.as_tensor(x)), wt.divergence.matvec(torch.as_tensor(x)))
    g = x.reshape((-1, 6 * m)).T.reshape((6 * m,) + Vt.shape_zyx).copy()
    _close(Vt.matvec_fm(torch.as_tensor(g)), Vj.matvec_fm(jnp.asarray(g)))
    _close(wt.divergence_op()(torch.as_tensor(x)), wj.divergence_op()(jnp.asarray(x)))
    assert ts.SupercellStencilOperator.from_varying(Vt, m, 6) is None


@pytest.mark.parametrize("kind", ["transport", "diffusion"])
def test_scalar_models_take_the_dense_supercell_stencil(kind):
    """TransportEquation and DiffusionEquation on a tet mesh: 'auto' is the
    dense supercell VaryingStencilOperator (M = 6), as the JAX package's
    tests/test_stencil.py asserts."""
    wj, wt, _ = _models(kind, family="tet_mesh")
    D = wt.divergence_op()
    assert isinstance(D.__self__, ts.VaryingStencilOperator) and D.__self__.m == 6
    assert wj.divergence_op().func is js.VaryingStencilOperator.matvec
    x = np.random.default_rng(4).standard_normal(wt.mesh.n_cells)
    _close(D(torch.as_tensor(x)), wj.divergence_op()(jnp.asarray(x)))
    _close(wt.implicit_matvec()(torch.as_tensor(x)), wj.implicit_matvec()(jnp.asarray(x)))


def test_wave_model_supercell_routes():
    """WaveSystem on a tet mesh: D is the supercell normal form in both
    layouts ('auto'; the dense one stays as 'varying'), and the
    field-major implicit matvec on (24, nSites) fields is the JAX package's
    cell-major one after the relayout. The JAX package has no field-major
    implicit matvec there (its GMRES runs cell-major); the port's stepper
    runs field-major."""
    wj, wt, _ = _models("wave")
    assert wt.fm_block == wj.fm_block == 24 and wt.cells_per_site == 6
    assert wt.normal_operator is None
    D = wt.divergence_op()
    assert isinstance(D.__self__, ts.SupercellNormalOperator)
    assert isinstance(wt.divergence_op("varying").__self__, ts.VaryingStencilOperator)
    assert isinstance(wt.divergence_op_fm().__self__, ts.SupercellNormalOperator)
    assert wj.implicit_matvec_fm() is None and wt.implicit_stepper_fm() is not None
    with pytest.raises(ValueError, match="normal-form"):
        wt.divergence_op_fm("normal")
    U = wt.initial_state()
    G = wt.pack_fm(U)
    assert G.shape == (24, wt.mesh.n_cells // 6)
    np.testing.assert_array_equal(wt.unpack_fm(G).numpy(), U.numpy())
    _close(G, wj.pack_fm(np.asarray(wj.initial_state())))
    x = np.random.default_rng(5).standard_normal(wt.mesh.n_cells * 4)
    _close(D(torch.as_tensor(x)), wj.divergence_op()(jnp.asarray(x)))
    g = torch.as_tensor(x.reshape(-1, 24).T.copy())
    _close(wt.unpack_fm(wt.implicit_matvec_fm()(g.reshape(-1))),
           wj.implicit_matvec()(jnp.asarray(x)))


def test_explicit_field_major_steps_match_jax():
    """Five explicit steps of the field-major supercell loop (the explicit
    driver's route) against the JAX package's, and against the cell-major
    dense steps."""
    mj, mt = ju.tet_mesh(UNIT, (4, 3, 3)), tu.tet_mesh(UNIT, (4, 3, 3))
    wj = jm.WaveSystem(mj, cfl=1.0 / 3, dtype=jnp.float64)
    wt = tm.WaveSystem(mt, cfl=1.0 / 3, **F64)
    sj, st, sc = wj.explicit_stepper_fm(), wt.explicit_stepper_fm(), wt.explicit_stepper()
    Gj, Gt, U = wj.pack_fm(np.asarray(wj.initial_state())), wt.pack_fm(wt.initial_state()), \
        wt.initial_state()
    for _ in range(5):
        Gj, nj = sj(Gj)
        Gt, nt = st(Gt)
        U, _ = sc(U)
        np.testing.assert_allclose(nt.item(), float(nj), rtol=1e-12)
    _close(Gt, Gj)
    _close(wt.unpack_fm(Gt), U)

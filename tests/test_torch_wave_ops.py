"""The port's wave-system operators against the JAX package: BSRMatrix, the
wave assembly, the cartesian, varying and normal-form stencils, and the
module that holds kernel K2 (ops/plane_stencil.py), which on the CPU runs
K2's plain version.

Float64 on the CPU, the same NumPy inputs on both sides. Tolerance 1e-13 ×
max|reference|: the same float64 arithmetic, with sums in another order
(the JAX package's face order may differ, see test_torch_wave_mesh.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh as j_cart
from circulantpreconditioner_tpu.mesh.structured import set_group_at_plane as j_group
from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.ops import assembly as ja
from circulantpreconditioner_tpu.ops import stencil as js
from circulantpreconditioner_tpu.ops.csr import BSRMatrix as JBSR
from circulantpreconditioner_tpu.ops.pallas_stencil import make_plane_stencil_matvec as j_plane
from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh as t_cart
from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh as t_kershaw
from circulantpreconditioner_tpu_torch.mesh import set_group_at_plane as t_group
from circulantpreconditioner_tpu_torch.ops import assembly as ta
from circulantpreconditioner_tpu_torch.ops import stencil as ts
from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix as TBSR
from circulantpreconditioner_tpu_torch.ops.plane_stencil import (
    PlaneStencilMatvec,
    make_plane_stencil_matvec,
)

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
TOL = 1e-13
DT, C0 = 3e-5, 700.0


def _close(x_torch, x_ref, tol=TOL):
    x_ref = np.asarray(x_ref)
    x = x_torch.numpy() if isinstance(x_torch, torch.Tensor) else np.asarray(x_torch)
    assert x.shape == x_ref.shape
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=tol * max(np.abs(x_ref).max(), 1e-300))


def _mesh_pair(kind, n, periodic=False, neumann=False):
    if kind == "kershaw":
        bounds = ((0.0, 1.0),) * 3
        return j_kershaw(bounds, n), t_kershaw(bounds, n)
    bounds = ((-0.5, 0.5),) * len(n)
    mj, mt = j_cart(bounds, n, periodic=periodic), t_cart(bounds, n, periodic=periodic)
    if neumann:  # the x = 0.5 plane becomes Neumann (a no-op), the rest stays Wall
        j_group(mj, 0, 0.5, "Neumann")
        t_group(mt, 0, 0.5, "Neumann")
    return mj, mt


def test_bsr_matvec_blockdiag_and_csr_match_jax():
    """The case of tests/test_csr.py::test_bsr_matvec_and_blockdiag, duplicate
    diagonal blocks included."""
    rng = np.random.default_rng(3)
    nb, b = 12, 3
    brows, bcols, blocks = [], [], []
    for i in range(nb):
        for j in [i, (i + 1) % nb, (i - 1) % nb, i]:
            brows.append(i)
            bcols.append(j)
            blocks.append(rng.normal(size=(b, b)))
    blocks = np.array(blocks)
    Aj = JBSR.from_block_coo(nb, nb, brows, bcols, blocks, dtype=jnp.float64)
    At = TBSR.from_block_coo(nb, nb, brows, bcols, blocks, **F64)
    assert At.shape == Aj.shape and At.block_size == b and At.n_brows == nb
    _close(At.to_dense(), Aj.to_dense())
    x = rng.normal(size=nb * b)
    _close(At.matvec(torch.as_tensor(x)), Aj.matvec(jnp.asarray(x)))
    _close(At.block_diagonal(), Aj.block_diagonal())
    _close(At.to_csr().matvec(torch.as_tensor(x)), Aj.to_csr(dtype=jnp.float64).matvec(
        jnp.asarray(x)))
    np.testing.assert_array_equal(At.brow_ids.numpy(), np.asarray(Aj.brow_ids))
    np.testing.assert_array_equal(At.indices.numpy(), np.asarray(Aj.indices))


@pytest.mark.parametrize("kind,n,periodic,neumann", [
    ("cart", (5, 4), False, False), ("cart", (5, 4), True, False),
    ("cart", (4, 3, 5), False, False), ("cart", (4, 3, 5), True, False),
    ("cart", (4, 3, 5), False, True), ("kershaw", (4, 3, 2), False, False),
    ("kershaw", (5, 4, 6), False, False)])
def test_wave_divergence_bsr_matches_jax(kind, n, periodic, neumann):
    mj, mt = _mesh_pair(kind, n, periodic, neumann)
    Dj = ja.wave_divergence_bsr(mj, DT, C0, dtype=jnp.float64)
    Dt = ta.wave_divergence_bsr(mt, DT, C0, **F64)
    _close(Dt.to_dense(), Dj.to_dense())
    x = np.random.default_rng(1).random(Dt.shape[0])
    _close(Dt.matvec(torch.as_tensor(x)), Dj.matvec(jnp.asarray(x)))


def test_wave_jacobians_and_block_stencil_match_jax():
    nrm = np.random.default_rng(2).normal(size=(7, 3))
    for a, b in zip(ta.wave_jacobian_blocks(nrm, C0), ja.wave_jacobian_blocks(nrm, C0)):
        _close(a, b)
    for dim in (2, 3):
        oj, bj = ja.wave_block_stencil(dim, DT, C0, [0.1, 0.2, 0.05][:dim])
        ot, bt = ta.wave_block_stencil(dim, DT, C0, [0.1, 0.2, 0.05][:dim])
        assert ot == oj
        _close(bt, bj)


@pytest.mark.parametrize("n,periodic", [((5, 4), False), ((5, 4), True), ((4, 3, 5), False),
                                        ((4, 3, 5), True)])
def test_wave_stencil_operator_matches_jax(n, periodic):
    mj, mt = _mesh_pair("cart", n, periodic)
    bc = "periodic" if periodic else "wall"
    Sj = js.WaveStencilOperator.create(n, DT, C0, mj.spacing, bc=bc, dtype=jnp.float64)
    St = ts.WaveStencilOperator.create(n, DT, C0, mt.spacing, bc=bc, **F64)
    U = np.random.default_rng(0).random(mt.n_cells * (len(n) + 1))
    _close(St.matvec(torch.as_tensor(U)), Sj.matvec(jnp.asarray(U)))
    # and the assembled operator, as tests/test_stencil.py holds the JAX one
    _close(St.matvec(torch.as_tensor(U)),
           ta.wave_divergence_bsr(mt, DT, C0, **F64).matvec(torch.as_tensor(U)))


def _varying_pair(kind, n, periodic=False):
    mj, mt = _mesh_pair(kind, n, periodic)
    shape = mt.topology_shape
    Vj = js.VaryingStencilOperator.from_bsr(ja.wave_divergence_bsr(mj, DT, C0,
                                                                   dtype=jnp.float64), shape)
    Vt = ts.VaryingStencilOperator.from_bsr(ta.wave_divergence_bsr(mt, DT, C0, **F64), shape)
    return Vj, Vt


def _fm_input(V, rng):
    shp = (V.m, int(np.prod(V.shape_zyx))) if V.layout == "flat" else (V.m,) + V.shape_zyx
    return rng.random(shp)


@pytest.mark.parametrize("kind,n,periodic,layout", [
    ("kershaw", (5, 4, 6), False, "flat"), ("cart", (4, 3, 5), False, "flat"),
    ("cart", (5, 4), False, "flat"), ("cart", (4, 3, 5), True, "grid_last")])
def test_varying_and_normal_stencils_match_jax(kind, n, periodic, layout):
    rng = np.random.default_rng(5)
    Vj, Vt = _varying_pair(kind, n, periodic)
    assert Vt.layout == Vj.layout == layout
    assert Vt.offsets == Vj.offsets and Vt.m == Vj.m and Vt.shape_zyx == Vj.shape_zyx
    for a, b in zip(Vt.coefs, Vj.coefs):
        _close(a, b)
    Wj = js.WaveNormalStencilOperator.from_varying(Vj, C0)
    Wt = ts.WaveNormalStencilOperator.from_varying(Vt, C0)
    assert Wj is not None and Wt is not None and Wt.offsets == Wj.offsets
    x = rng.random(Vt.m * int(np.prod(Vt.shape_zyx)))
    g = _fm_input(Vt, rng)
    for opj, opt in ((Vj, Vt), (Wj, Wt)):
        _close(opt.matvec(torch.as_tensor(x)), opj.matvec(jnp.asarray(x)))
        _close(opt.matvec_fm(torch.as_tensor(g)), opj.matvec_fm(jnp.asarray(g)))
        _close(opt.matvec_fm_flat(torch.as_tensor(g.reshape(-1))),
               opj.matvec_fm_flat(jnp.asarray(g.reshape(-1))))
    # the from-arrays constructors take the JAX operators' arrays
    Vt2 = ts.VaryingStencilOperator.from_arrays(Vj.shape_zyx, Vj.m, Vj.offsets,
                                                [np.asarray(c) for c in Vj.coefs], Vj.layout,
                                                **F64)
    Wt2 = ts.WaveNormalStencilOperator.from_arrays(Wj.shape_zyx, Wj.c0, Wj.offsets, Wj.layout,
                                                   *[np.asarray(a) for a in Wj.arrays], **F64)
    _close(Vt2.matvec_fm(torch.as_tensor(g)), Vj.matvec_fm(jnp.asarray(g)))
    _close(Wt2.matvec_fm(torch.as_tensor(g)), Wj.matvec_fm(jnp.asarray(g)))


def test_normal_form_returns_none_where_jax_does():
    rng = np.random.default_rng(6)
    Vj, Vt = _varying_pair("kershaw", (5, 4, 6))
    assert Vj.layout == "flat"
    # a dense block that is not of the wave form
    bad = [c.copy() for c in map(np.asarray, Vj.coefs)]
    k = 0 if Vj.offsets[0] != 0 else 1
    bad[k] = bad[k] + rng.random(bad[k].shape)
    Vj_bad = js.VaryingStencilOperator(Vj.shape_zyx, Vj.m, Vj.offsets,
                                       tuple(jnp.asarray(c) for c in bad), Vj.layout)
    Vt_bad = ts.VaryingStencilOperator.from_arrays(Vj.shape_zyx, Vj.m, Vj.offsets, bad,
                                                   Vj.layout, **F64)
    assert js.WaveNormalStencilOperator.from_varying(Vj_bad, C0) is None
    assert ts.WaveNormalStencilOperator.from_varying(Vt_bad, C0) is None
    # no diagonal offset
    keep = [i for i, o in enumerate(Vj.offsets) if o != 0]
    Vj_nod = js.VaryingStencilOperator(Vj.shape_zyx, Vj.m, tuple(Vj.offsets[i] for i in keep),
                                       tuple(Vj.coefs[i] for i in keep), Vj.layout)
    Vt_nod = ts.VaryingStencilOperator(Vt.shape_zyx, Vt.m, tuple(Vt.offsets[i] for i in keep),
                                       tuple(Vt.coefs[i] for i in keep), Vt.layout)
    assert js.WaveNormalStencilOperator.from_varying(Vj_nod, C0) is None
    assert ts.WaveNormalStencilOperator.from_varying(Vt_nod, C0) is None
    # a block size that is not 2, 3 or 4
    assert ts.WaveNormalStencilOperator.from_varying(
        ts.VaryingStencilOperator((1, 1, 3), 5, (0,), [torch.ones(5, 5, 3)]), C0) is None


def test_varying_stencil_rejects_non_stencil():
    with pytest.raises(ValueError, match="face-neighbour"):
        ts.VaryingStencilOperator.from_blocks([0, 0], [0, 2], np.ones((2, 1, 1)), (4, 2, 2),
                                              **F64)
    with pytest.raises(ValueError, match="diagonal neighbours"):
        ts.VaryingStencilOperator.from_blocks([0, 0], [0, 5], np.ones((2, 1, 1)), (2, 2, 2),
                                              **F64)


def _normal_pair(n):
    Vj, Vt = _varying_pair("kershaw", n)
    return (js.WaveNormalStencilOperator.from_varying(Vj, C0),
            ts.WaveNormalStencilOperator.from_varying(Vt, C0))


def test_plane_stencil_module_matches_jax_kernel():
    """K2's module on the CPU (its plain version) against the JAX Pallas
    kernel in interpret mode, at the JAX test's shape (tests/test_pallas.py)."""
    Wj, Wt = _normal_pair((16, 8, 5))
    mj = j_plane(Wj, interpret=True)
    mt = make_plane_stencil_matvec(Wt)
    assert mj is not None and isinstance(mt, PlaneStencilMatvec)
    rng = np.random.default_rng(0)
    g = rng.random((4, 16 * 8 * 5))
    before = PlaneStencilMatvec.launches
    ref = np.asarray(mj(jnp.asarray(g)))
    _close(mt(torch.as_tensor(g)), ref)
    _close(mt(torch.as_tensor(g.reshape(4, 5, 8, 16))), ref.reshape(4, 5, 8, 16))
    _close(mt(torch.as_tensor(g.reshape(-1))), ref.reshape(-1))
    assert PlaneStencilMatvec.launches == before  # the CPU runs no kernel


def test_plane_stencil_takes_ragged_planes():
    """At (5, 4, 6) the plane is 20 cells: the Pallas kernel refuses it (a
    Mosaic lane rule), the port's accepts it and equals Wn.matvec_fm."""
    Wj, Wt = _normal_pair((5, 4, 6))
    assert j_plane(Wj, interpret=True) is None
    mt = make_plane_stencil_matvec(Wt)
    assert mt is not None
    g = np.random.default_rng(1).random((4, 5 * 4 * 6))
    _close(mt(torch.as_tensor(g)), Wj.matvec_fm(jnp.asarray(g)))
    with pytest.raises(ValueError, match="values"):
        mt(torch.zeros(4, 7, dtype=torch.float64))


def test_plane_stencil_contract():
    _, Vt = _varying_pair("cart", (4, 3, 5), periodic=True)  # grid_last
    assert make_plane_stencil_matvec(ts.WaveNormalStencilOperator.from_varying(Vt, C0)) is None
    _, Wt = _normal_pair((5, 4, 6))
    far = ts.WaveNormalStencilOperator(Wt.shape_zyx, C0, Wt.offsets[:-1] + (2 * 5 * 4 + 1,),
                                       Wt.layout, Wt.arrays)
    assert make_plane_stencil_matvec(far) is None  # reaches beyond one plane

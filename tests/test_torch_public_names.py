"""The small public names of the JAX package that the port carries too, each
against the JAX function on the same input (float64 on the CPU): the
transport column, spectrum and eigenvalue field; BoundaryGroup,
Mesh.group_code and Mesh.max_neighbours; the identity preconditioner; the
circulant operators' spectra and sizes; CSRMatrix.nnz and to_dense.

Spectra are built in complex128 on the host in both packages: the bar is
1e-15 relative (float64) and 1e-7 (float32, one rounding each)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import circulantpreconditioner_tpu as jcp
import circulantpreconditioner_tpu_torch as tcp
from circulantpreconditioner_tpu.mesh import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.mesh.core import BoundaryGroup as JBoundaryGroup
from circulantpreconditioner_tpu.mesh.structured import cartesian_mesh as j_cartesian
from circulantpreconditioner_tpu.ops.assembly import wave_block_stencil
from circulantpreconditioner_tpu.ops.circulant import BlockCirculantOperator as JBlock
from circulantpreconditioner_tpu.ops.csr import CSRMatrix as JCSR
from circulantpreconditioner_tpu.solvers import preconditioners as jpcs
from circulantpreconditioner_tpu_torch.mesh import BoundaryGroup, kershaw_mesh
from circulantpreconditioner_tpu_torch.mesh.structured import cartesian_mesh
from circulantpreconditioner_tpu_torch.ops import BlockCirculantOperator, CSRMatrix
from circulantpreconditioner_tpu_torch.ops import eigenvalue_diagonal as ops_eigenvalue_diagonal
from circulantpreconditioner_tpu_torch.solvers import preconditioners as tpcs

TOL = {torch.float32: 1e-7, torch.float64: 1e-15}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _close(t: torch.Tensor, j, dtype) -> None:
    j = np.asarray(j)
    assert t.dtype == (torch.complex128 if dtype == torch.float64 else torch.complex64) \
        or t.dtype == dtype
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=TOL[dtype] * max(np.abs(j).max(), 1))


@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transport_column_and_spectrum(n, dtype):
    col = tcp.transport_column(n, dtype=dtype)
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcp.transport_column(n, JDT[dtype])))
    assert col.dtype == dtype
    _close(tcp.transport_spectrum(n, dtype=dtype), jcp.transport_spectrum(n, JDT[dtype]), dtype)
    # the spectrum is the column's DFT
    np.testing.assert_allclose(tcp.transport_spectrum(n, dtype=torch.float64).numpy(),
                               np.fft.fft(col.double().numpy()), atol=1e-14)


@pytest.mark.parametrize("rfft", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,lams", [((6, 5, 8), (0.3, 0.2, 0.9)), ((4, 7), (1.5, 0.0)),
                                        ((9,), (55.5,))])
def test_eigenvalue_diagonal(shape, lams, dtype, rfft):
    lam = tcp.eigenvalue_diagonal(shape, lams, dtype=dtype, rfft=rfft)
    _close(lam, jcp.eigenvalue_diagonal(shape, lams, JDT[dtype], rfft=rfft), dtype)
    assert ops_eigenvalue_diagonal is tcp.eigenvalue_diagonal
    with pytest.raises(ValueError):
        tcp.eigenvalue_diagonal(shape, lams + (0.1,))


def test_circulant_operator_spectra_and_sizes():
    shape, lams = (6, 5, 8), (0.3, 0.2, 0.9)
    jop = jcp.CirculantTransportOperator.create(shape, lams, dtype=jnp.float64)
    top = tcp.CirculantTransportOperator.create(shape, lams, device=torch.device("cpu"),
                                                dtype=torch.float64)
    _close(top.lam_rfft, jop.lam_rfft, torch.float64)
    _close(top.lam_full, jop.lam_full, torch.float64)
    assert (top.ndim, top.size) == (jop.ndim, jop.size) == (3, 240)


def test_block_circulant_inv_symbol():
    shape = (4, 5, 6)
    offsets, blocks = wave_block_stencil(3, 0.01, 1.0, (0.1, 0.1, 0.1))
    jop = JBlock.from_stencil(shape, offsets, blocks, dtype=jnp.float64)
    top = BlockCirculantOperator.from_stencil(shape, offsets, blocks,
                                              device=torch.device("cpu"), dtype=torch.float64)
    _close(top.inv_symbol, jop.inv_symbol, torch.float64)


@pytest.mark.parametrize("family", ["cartesian", "kershaw"])
def test_mesh_group_code_and_max_neighbours(family):
    bounds = ((-0.5, 0.5),) * 3
    if family == "cartesian":
        jm, tm = j_cartesian(bounds, (4, 3, 5)), cartesian_mesh(bounds, (4, 3, 5))
    else:
        jm, tm = j_kershaw(bounds, (4, 4, 4)), kershaw_mesh(bounds, (4, 4, 4))
    assert tm.max_neighbours() == jm.max_neighbours() == 6
    assert jm.groups and tm.groups == jm.groups
    for name in jm.groups:
        assert tm.group_code(name) == jm.group_code(name)
    with pytest.raises(KeyError):
        tm.group_code("no such group")


def test_boundary_group():
    g, jg = BoundaryGroup("Wall", 3), JBoundaryGroup("Wall", 3)
    assert (g.name, g.code) == (jg.name, jg.code)
    assert g == BoundaryGroup(name="Wall", code=3)


def test_identity_preconditioner():
    r = np.random.default_rng(4).normal(size=17)
    np.testing.assert_array_equal(tpcs.identity()(torch.as_tensor(r)).numpy(),
                                  np.asarray(jpcs.identity()(jnp.asarray(r))))


def test_csr_nnz_and_to_dense():
    A = sp.random(12, 9, density=0.3, random_state=np.random.default_rng(5), format="csr")
    jA = JCSR.from_scipy(A, dtype=jnp.float64)
    tA = CSRMatrix.from_scipy(A, device=torch.device("cpu"), dtype=torch.float64)
    assert tA.nnz == jA.nnz == A.nnz
    np.testing.assert_array_equal(tA.to_dense(), jA.to_dense())

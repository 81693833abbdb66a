"""The supercell normal form (ops/stencil.SupercellNormalOperator), whose apply
is kernel K7 on the card (ops/supercell_stencil.py), on the CPU: its host
decomposition of the wave system's D on the tet meshes, its plain version
against the JAX package's block-sparse SupercellStencilOperator, the model's
choice between it and the block-sparse form, and the wrapper's refusals and
counters. K7 itself runs in tests/test_torch_gpu.py.

Float64, the same NumPy inputs on both sides. Tolerances: the sub-blocks
1e-14 × the largest (s and n̂ are a quotient of the block's own entries,
rebuilt in float64); the applies 1e-12 × max|y| (the same coefficients up to
that rounding, summed in another order).
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
from circulantpreconditioner_tpu_torch.ops import supercell_stencil as k7
from circulantpreconditioner_tpu_torch.utils.graphs import STATS

CPU = torch.device("cpu")
F64 = dict(device=CPU, dtype=torch.float64)
UNIT = ((0.0, 1.0),) * 3
FAMILIES = ["tet_mesh", "kershaw_tet_mesh"]


def _close(x, ref, tol=1e-12):
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * np.abs(ref).max())


def _wave(family, n=(5, 4, 3), **kw):
    return tm.WaveSystem(getattr(tu, family)(UNIT, n), cfl=10.0, **(kw or F64))


def _normal_sub_blocks(S):
    """The normal form's m×m sub-blocks as float64 (m, m, N), keyed (flat
    offset, sub-row, sub-column): the diagonal blocks at offset 0 and each
    slot's s·(A − |A|)(n̂)/2."""
    diag, s, nvec = (a.double().numpy() for a in S.arrays)
    out = {(0, k, k): diag[k] for k in range(S.g)}
    for k in range(S.g):
        for f in range(S.F):
            out[(S.slot_offset[k][f], k, S.slot_col[k][f])] = ts._wave_block(s[k, f], nvec[k, f],
                                                                            S.c0)
    return out


def _block_sparse_sub_blocks(B):
    """The block-sparse operator's sub-blocks, keyed (flat offset, sub-row,
    sub-column), as float64 (m, m, N)."""
    out = {}
    for off, rows, cols, C in zip(B.offsets, B.rows, B.cols, B.coefs):
        for a, r in enumerate(rows.tolist()):
            for k, c in enumerate(cols[a].tolist()):
                if (r, c) in B.pair_idx[B.offsets.index(off)]:
                    out[(off, r, c)] = C[a, k].double().numpy()
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_host_normal_form_reproduces_every_sub_block(family):
    """Every non-zero 4×4 sub-block of D (the block-sparse form's, the dense
    form's own coefficients) is the normal form's: each tet's diagonal block,
    and per face slot s·(A − |A|)(n̂)/2 at the slot's offset and sub-column."""
    w = _wave(family)
    S = ts.SupercellNormalOperator.from_blocks(*w.divergence.coo_numpy(), w.mesh.topology_shape,
                                               6, w.c0, **F64)
    B = ts.SupercellStencilOperator.from_bsr(w.divergence, w.mesh.topology_shape, 6)
    got, want = _normal_sub_blocks(S), _block_sparse_sub_blocks(B)
    assert set(got) == set(want) and len(want) == 30
    scale = max(np.abs(C).max() for C in want.values())
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 1e-14 * scale


def test_every_tet_couples_through_its_four_faces():
    """The 6-tet split of a hex: 4 face slots a tet, over the offsets
    0, ±1, ±nx, ±nx·ny; s ≠ 0 on each interior face side, 2 per interior
    face (the count supercell_spmv_roofline's least bytes take), and s = 0
    on the 4·(nx·ny + ny·nz + nx·nz) boundary triangles."""
    nx, ny, nz = 5, 4, 3
    S = _wave("kershaw_tet_mesh", (nx, ny, nz)).supercell_operator
    assert isinstance(S, ts.SupercellNormalOperator) and (S.g, S.F, S.m) == (6, 4, 4)
    assert {o for r in S.slot_offset for o in r} == {0, 1, -1, nx, -nx, nx * ny, -nx * ny}
    s = S.arrays[1]
    boundary = 4 * (nx * ny + ny * nz + nx * nz)
    assert int((s != 0).sum()) == 24 * nx * ny * nz - boundary
    interior = (slice(None), slice(None), slice(1, nz - 1), slice(1, ny - 1), slice(1, nx - 1))
    assert bool((s.reshape(6, 4, nz, ny, nx)[interior] != 0).all())


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_apply_matches_jax(family):
    """The plain version (the CPU apply) against the JAX package's
    block-sparse SupercellStencilOperator, in the cell-major and the
    field-major layouts; the model's routes take it."""
    n = (4, 3, 5)
    wj = jm.WaveSystem(getattr(ju, family)(UNIT, n), cfl=10.0, dtype=jnp.float64)
    wt = _wave(family, n)
    Sj = js.SupercellStencilOperator.from_varying(
        js.VaryingStencilOperator.from_bsr(wj.divergence, wt.mesh.topology_shape,
                                           cells_per_site=6), 4, 6)
    S = wt.supercell_operator
    assert isinstance(S, ts.SupercellNormalOperator)
    x = np.random.default_rng(7).standard_normal(24 * S.N)
    g = x.reshape(-1, 24).T.copy()
    _close(S.matvec(torch.as_tensor(x)), Sj.matvec(jnp.asarray(x)))
    _close(S.matvec_fm(torch.as_tensor(g)), Sj.matvec_fm(jnp.asarray(g)))
    _close(S.matvec_fm_flat(torch.as_tensor(g.reshape(-1))),
           Sj.matvec_fm_flat(jnp.asarray(g.reshape(-1))))
    _close(wt.divergence_op()(torch.as_tensor(x)), Sj.matvec(jnp.asarray(x)))
    _close(wt.divergence_op_fm(flat=True)(torch.as_tensor(g.reshape(-1))),
           Sj.matvec_fm_flat(jnp.asarray(g.reshape(-1))))


def test_float32_normal_form_is_the_float64_operator():
    """In the configuration's float32, D's blocks decompose as well: the
    apply lies within float32 rounding of the float64 BSR matvec."""
    w32 = _wave("kershaw_tet_mesh", dtype=torch.float32, device=CPU)
    w64 = _wave("kershaw_tet_mesh")
    S = w32.supercell_operator
    assert isinstance(S, ts.SupercellNormalOperator) and S.arrays[0].dtype == torch.float32
    x = np.random.default_rng(8).standard_normal(w64.divergence.shape[0])
    _close(S.matvec(torch.as_tensor(x, dtype=torch.float32)).double(),
           w64.divergence.matvec(torch.as_tensor(x)), 1e-6)


def test_a_sub_block_off_the_wave_form_takes_the_block_sparse_form():
    """One off-diagonal sub-block changed off s·(A − |A|)(n̂)/2 (its p-row
    only): no normal form, so the model's supercell operator is the
    block-sparse stencil, which holds the changed block, and its applies
    count as plain."""
    w = _wave("kershaw_tet_mesh")
    D = w.divergence
    rows, cols, _ = D.coo_numpy()
    i = int(np.flatnonzero(rows != cols)[3])
    D.blocks[i, 0, 1] += 1e-3 * D.blocks.abs().max()
    S = w.supercell_operator
    assert type(S) is ts.SupercellStencilOperator
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(D.shape[0]))
    STATS.reset()
    _close(w.divergence_op()(x), D.matvec(x))
    assert (STATS.supercell_fused, STATS.supercell_plain) == (0, 1)


def test_a_table_beyond_k7_is_the_normal_form_and_the_kernel_refuses_it():
    """A fifth coupling on tet 0, of wave form, to tet 3 of the next site in
    x (tet 0 couples there only to tet 2): the host still builds the normal form (F = 5, not
    the block-sparse form), whose plain apply is the extended D's product;
    K7, which takes 4 slots a tet, raises on it instead of another form
    being taken."""
    nx, ny, nz = 5, 4, 3
    w = _wave("kershaw_tet_mesh", (nx, ny, nz))
    rows, cols, blocks = w.divergence.coo_numpy()
    z, y, x = np.meshgrid(range(nz), range(ny), range(nx - 1), indexing="ij")
    site = ((z * ny + y) * nx + x).reshape(-1)
    rng = np.random.default_rng(10)
    n = rng.standard_normal((3, site.size))
    extra = ts._wave_block(rng.uniform(0.5, 1.0, site.size), n / np.linalg.norm(n, axis=0), w.c0)
    rows = np.concatenate([rows, 6 * site])
    cols = np.concatenate([cols, 6 * (site + 1) + 3])
    blocks = np.concatenate([blocks, np.moveaxis(extra, -1, 0)])
    S = ts.SupercellNormalOperator.from_blocks(rows, cols, blocks, w.mesh.topology_shape, 6,
                                               w.c0, **F64)
    assert isinstance(S, ts.SupercellNormalOperator) and (S.g, S.F) == (6, 5)
    assert (S.slot_offset[0][-1], S.slot_col[0][-1]) == (1, 3)
    v = np.random.default_rng(11).standard_normal(24 * S.N)
    ref = np.zeros((6 * S.N, 4))
    np.add.at(ref, rows, np.einsum("bij,bj->bi", blocks, v.reshape(-1, 4)[cols]))
    _close(S.matvec(torch.as_tensor(v)), ref.reshape(-1))
    with pytest.raises(ValueError, match="at most 6 cells a site and 4 slots a cell"):
        k7.supercell_stencil_cuda(S, torch.as_tensor(v.reshape(-1, 24).T.copy()))


def test_periodic_tets_have_no_normal_form():
    """A periodic tet mesh couples sites across the wraps: no flat layout,
    so neither supercell form (the dense grid_last stencil takes D)."""
    mesh = tu.tet_mesh(UNIT, (3, 2, 3))
    mesh.set_periodic()
    w = tm.WaveSystem(mesh, cfl=10.0, **F64)
    assert ts.SupercellNormalOperator.from_blocks(*w.divergence.coo_numpy(), mesh.topology_shape,
                                                  6, w.c0, **F64) is None
    assert w.supercell_operator is None
    assert isinstance(w.divergence_op().__self__, ts.VaryingStencilOperator)


def test_cpu_applies_run_the_plain_version_and_count_it():
    """On the CPU each apply is the plain version, counted in
    STATS.supercell_plain; K7 launches nothing. The wrapper takes (M, N) and
    flat field-major input and returns the shape it was given."""
    S = _wave("tet_mesh").supercell_operator
    g = torch.randn(S.M, S.N, dtype=torch.float64)
    launches = k7.SupercellStencilKernel.launches
    STATS.reset()
    y = k7.apply(S, g)
    _close(k7.apply(S, g.reshape(-1)), y.reshape(-1), 0.0)
    _close(y, S.plain_fm(g), 0.0)
    assert (STATS.supercell_fused, STATS.supercell_plain) == (0, 2)
    assert k7.SupercellStencilKernel.launches == launches
    with pytest.raises(ValueError, match="values"):
        k7.apply(S, g[:, :-1])


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "table"])
def test_the_kernel_wrapper_refuses_what_k7_cannot_take(case):
    """supercell_stencil_cuda raises before it loads the library: a dtype
    other than float32 and float64, a shape that is not the operator's, a
    tensor off the card, a slot table outside the grid (the card's cases,
    contiguity among them, are in tests/test_torch_gpu.py)."""
    S = _wave("tet_mesh").supercell_operator
    g = torch.randn(S.M, S.N, dtype=torch.float64)
    if case == "dtype":
        g, match = g.half(), "float32 or float64"
    elif case == "shape":
        g, match = g[:, :-1], "shape"
    elif case == "device":
        match = "CUDA tensors"
    else:
        S.slot_offset = ((S.N,) + S.slot_offset[0][1:],) + S.slot_offset[1:]
        match = "outside"
    with pytest.raises(ValueError, match=match):
        k7.supercell_stencil_cuda(S, g)

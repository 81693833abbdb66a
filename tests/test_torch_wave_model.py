"""The port's WaveSystem, pbjacobi and GridVCyclePC against the JAX package
on Kershaw grids (float64 on the CPU, the same NumPy inputs).

Tolerances:
- dt, the initial state and the field-major packing: exact (1e-15);
- explicit steps and the V-cycle apply: 1e-12 × max|reference| (the same
  float64 arithmetic, sums in another order);
- implicit steps: equal GMRES iterations in every step, and states to 1e-10
  relative. GMRES with no preconditioner runs at cfl 10: at the drivers'
  cfl 1e3/3 unpreconditioned GMRES amplifies roundoff so far that the JAX
  package against itself, with its other face-extraction route, changes the
  state at 1e-4 and the iterations of a step by one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh as j_kershaw
from circulantpreconditioner_tpu.models import WaveSystem as JWave
from circulantpreconditioner_tpu.models import run_time_loop as j_run
from circulantpreconditioner_tpu.solvers import preconditioners as jpcs
from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC as JGrid
from circulantpreconditioner_tpu_torch.mesh import kershaw_mesh as t_kershaw
from circulantpreconditioner_tpu_torch.models import WaveSystem as TWave
from circulantpreconditioner_tpu_torch.models import run_time_loop as t_run
from circulantpreconditioner_tpu_torch.solvers import preconditioners as tpcs
from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC as TGrid

CPU = torch.device("cpu")
BOUNDS = ((-0.5, 0.5),) * 3


def _close(x_torch, x_ref, tol):
    x_ref = np.asarray(x_ref)
    x = x_torch.numpy() if isinstance(x_torch, torch.Tensor) else np.asarray(x_torch)
    assert x.shape == x_ref.shape
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=tol * np.abs(x_ref).max())


def _models(n, cfl):
    return (JWave(j_kershaw(BOUNDS, n), cfl=cfl, dtype=jnp.float64),
            TWave(t_kershaw(BOUNDS, n), cfl=cfl, device=CPU, dtype=torch.float64))


def test_dt_initial_state_and_packing_match_jax():
    mj, mt = _models((6, 5, 4), 1.0 / 3)
    assert mt.dt == pytest.approx(mj.dt, rel=1e-15)
    assert mt.nb == mj.nb == 4 and mt.fm_block == mj.fm_block == 4
    U = mt.initial_state()
    assert U.dtype == torch.float64 and U.device == CPU
    _close(U, mj.initial_state(), 0)
    G = mt.pack_fm(U)
    assert G.shape == (4, mt.mesh.n_cells) and G.device == CPU and G.is_contiguous()
    _close(G, mj.pack_fm(np.asarray(mj.initial_state())), 0)
    _close(mt.unpack_fm(G), mj.unpack_fm(np.asarray(G)), 0)
    _close(mt.unpack_fm(G.reshape(-1)), U, 0)
    np.testing.assert_array_equal(mt.unpack_fm(G.numpy()), U.numpy())  # NumPy in, NumPy out
    for a, b in zip(mt.split_fields(U), mj.split_fields(mj.initial_state())):
        _close(a, b, 0)


@pytest.mark.parametrize("operator", ["auto", "normal", "varying", "matrix"])
def test_divergence_op_forms_match_jax(operator):
    mj, mt = _models((5, 4, 6), 10.0)
    U = np.random.default_rng(2).random(mt.mesh.n_cells * 4) * 1e7
    _close(mt.divergence_op(operator)(torch.as_tensor(U)),
           mj.divergence_op(operator)(jnp.asarray(U)), 1e-12)


def test_explicit_steps_match_jax():
    mj, mt = _models((8, 8, 8), 1.0 / 3)
    kw = dict(tmax=1e9, ntmax=5, log=None)
    rj = j_run(mj.explicit_stepper_fm(), mj.pack_fm(mj.initial_state()), mj.dt, **kw)
    rt = t_run(mt.explicit_stepper_fm(), mt.pack_fm(mt.initial_state()), mt.dt, **kw)
    assert rt.iterations == rj.iterations == 5
    _close(mt.unpack_fm(rt.state), mj.unpack_fm(rj.state), 1e-12)
    _close([d["dnorm"] for d in rt.diagnostics], [d["dnorm"] for d in rj.diagnostics], 1e-12)
    # the cell-major stepper takes the same steps
    rc = t_run(mt.explicit_stepper(), mt.initial_state(), mt.dt, **kw)
    _close(rc.state, mj.unpack_fm(rj.state), 1e-12)


def _vcycles(n):
    mj, mt = _models(n, 1e3 / 3)
    pj = JGrid.from_grid_model(mj.divergence, n, A0_apply=mj.implicit_matvec(),
                               A0_apply_fm=mj.implicit_matvec_fm(), dtype=jnp.float64)
    pt = TGrid.from_grid_model(mt.divergence, n, A0_apply=mt.implicit_matvec(),
                               A0_apply_fm=mt.implicit_matvec_fm())
    return mj, mt, pj, pt


def test_grid_vcycle_matches_jax():
    """Kershaw 12³: one grid level above the 600-site bottom."""
    mj, mt, pj, pt = _vcycles((12, 12, 12))
    assert pt.n_levels == pj.n_levels == 2
    r = np.random.default_rng(7).standard_normal(mt.mesh.n_cells * 4)
    _close(pt.apply_fm(torch.as_tensor(r)), pj.apply_fm(jnp.asarray(r)), 1e-12)
    _close(pt.apply(torch.as_tensor(r)), pj.apply(jnp.asarray(r)), 1e-12)
    # the field-major form is the cell-major one in the other layout
    _close(mt.unpack_fm(pt.apply_fm(mt.pack_fm(torch.as_tensor(r)).reshape(-1))),
           pt.apply(torch.as_tensor(r)), 1e-12)


def test_grid_vcycle_levels_and_transfers():
    """Odd extents (truncated boxes): restriction of a prolonged vector is the
    identity on grid levels (field-major) and on a supercell mesh's first
    level (both layouts); on a periodic grid apply_fm runs the grid_last
    levels' field-major stencils and equals the cell-major apply."""
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.solvers import aggregation_pc as ag

    nx, ny, nz, b = 5, 4, 3, 4
    cnt = np.zeros((2, 2, 3))
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                cnt[z // 2, y // 2, x // 2] += 1
    L = ag._GridLevel(Dinv=torch.zeros(nx * ny * nz, b, b),
                      cnt_inv=torch.as_tensor((1.0 / cnt)[..., None]),
                      shape_xyz=(nx, ny, nz), cshape_xyz=(3, 2, 2), b=b)
    zc = torch.as_tensor(np.random.default_rng(3).standard_normal(12 * b))
    _close(ag._grid_restrict_fm(L, ag._grid_prolong_fm(L, zc)), zc, 1e-15)
    # a supercell mesh (6 tets per site): an aggregation level first, whose
    # transfers are reshapes in both layouts
    from circulantpreconditioner_tpu_torch.mesh import tet_mesh

    tet = TWave(tet_mesh(((-0.5, 0.5),) * 3, (4, 4, 4)), cfl=1.0, device=CPU,
                dtype=torch.float64)
    pt = TGrid.from_grid_model(tet.divergence, (4, 4, 4), cells_per_site=6, bottom_max=8)
    L0 = pt.levels[0]
    assert isinstance(L0, ag._Level) and (L0.n, L0.factor, L0.n_agg) == (384, 6, 64)
    assert [type(L) for L in pt.levels[1:]] == [ag._GridLevel] and pt.n_levels == 3
    zc = torch.as_tensor(np.random.default_rng(4).standard_normal(64 * b))
    _close(ag._restrict(L0, ag._prolong(L0, zc)), zc, 1e-15)
    _close(ag._restrict_fm(L0, ag._prolong_fm(L0, zc)), zc, 1e-15)
    per = TWave(cartesian_mesh(((-0.5, 0.5),) * 3, (12, 10, 8), periodic=True), cfl=10.0,
                device=CPU, dtype=torch.float64)
    pc = TGrid.from_grid_model(per.divergence, (12, 10, 8), bottom_max=100)
    assert [L.stencil.layout for L in pc.levels[1:]] == ["grid_last"]
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(per.mesh.n_cells * b))
    z_fm = pc.apply_fm(r.reshape(-1, b).T.reshape(-1)).reshape(b, -1).T.reshape(-1)
    _close(z_fm, pc.apply(r).numpy(), 1e-12)
    # and the JAX package's cell-major apply, whose periodic levels run cell-major
    from circulantpreconditioner_tpu.mesh.structured import cartesian_mesh as j_cartesian

    perj = JWave(j_cartesian(((-0.5, 0.5),) * 3, (12, 10, 8), periodic=True), cfl=10.0,
                 dtype=jnp.float64)
    pj = JGrid.from_grid_model(perj.divergence, (12, 10, 8), bottom_max=100, dtype=jnp.float64)
    _close(pc.apply(r), pj.apply(jnp.asarray(r.numpy())), 1e-12)


@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("pc", ["none", "pbjacobi", "gridmg"])
def test_implicit_fm_steps_match_jax(n, pc):
    shape = (n, n, n)
    if pc == "gridmg":
        mj, mt, pj, pt = _vcycles(shape)
        Mj, Mt = pj.apply_fm_partial(), pt.apply_fm
    else:
        mj, mt = _models(shape, 10.0 if pc == "none" else 1e3 / 3)
        Mj = Mt = None
        if pc == "pbjacobi":
            Mj = jpcs.pbjacobi_fm(mj.divergence, shift=1.0)
            Mt = tpcs.pbjacobi_fm(mt.divergence, shift=1.0)
    kw = dict(tmax=1e9, ntmax=2, log=None)
    rj = j_run(mj.implicit_stepper_fm(M_fm=Mj, side="right"),
               mj.pack_fm(mj.initial_state()).reshape(-1), mj.dt, **kw)
    rt = t_run(mt.implicit_stepper_fm(M_fm=Mt, side="right"),
               mt.pack_fm(mt.initial_state()).reshape(-1), mt.dt, **kw)
    its = lambda r: [d["extras"][0] for d in r.diagnostics]  # noqa: E731
    assert its(rt) == its(rj)
    assert all(d["extras"][2] for d in rt.diagnostics)
    _close(rt.state, rj.state, 1e-10)


def test_pbjacobi_cell_major_and_composites_match_jax():
    mj, mt = _models((5, 4, 6), 1e3 / 3)
    r = np.random.default_rng(9).standard_normal(mt.mesh.n_cells * 4)
    rt_, rj_ = torch.as_tensor(r), jnp.asarray(r)
    Pj, Pt = jpcs.pbjacobi(mj.divergence, shift=1.0), tpcs.pbjacobi(mt.divergence, shift=1.0)
    _close(Pt(rt_), Pj(rj_), 1e-12)
    Fj = jpcs.pbjacobi_fm(mj.divergence, shift=1.0)
    Ft = tpcs.pbjacobi_fm(mt.divergence, shift=1.0)
    Aj, At = mj.implicit_matvec_fm(), mt.implicit_matvec_fm()
    _close(tpcs.cell_major_adapter(Pt, 4)(rt_), jpcs.cell_major_adapter(Pj, 4)(rj_), 1e-12)
    _close(tpcs.additive(Ft, Ft)(rt_), jpcs.additive(Fj, Fj)(rj_), 1e-12)
    _close(tpcs.multiplicative(At, Ft, Ft)(rt_), jpcs.multiplicative(Aj, Fj, Fj)(rj_), 1e-12)


def test_not_ported_members_raise():
    """The direct solvers are ported (tests/test_torch_block_circulant.py,
    test_torch_dct_wave.py); on a Kershaw mesh they raise as the JAX ones do,
    since they need a structured grid. The window operator is ported too."""
    mj, mt = _models((4, 4, 4), 1.0)
    for call in (lambda: mt.block_circulant_operator, mt.block_fft_stepper,
                 mt.dct_fft_stepper, mt.dct_fft_stepper_fm):
        with pytest.raises(ValueError, match="structured"):
            call()
    x = np.random.default_rng(8).standard_normal(64 * 4)
    _close(mt.divergence_op("window")(torch.as_tensor(x)),
           mj.divergence_op("window")(jnp.asarray(x)), 1e-12)

"""drivers/wave_implicit.py on a mesh whose topology is a grid: field-major
GMRES right (the driver's `implicit_stepper_fm`), restart 30, with

- pc "gridmg": the grid V-cycle (`GridVCyclePC.from_grid_model`, apply_fm);
- pc "dct2lm": the multiplicative two-level cycle of the DCT projection PC
  (`DCTBlockProjectionPC` at the tier `precision`) and point-block Jacobi.

The state is packed field-major before the loop and unpacked after it, as
the driver does."""

from __future__ import annotations

from portbench.routes import Route, dtype_of, implicit_request, port_mesh


def _preconditioner(mix, mesh, model, device, dtype):
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

    if mix["pc"] == "gridmg":
        from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import GridVCyclePC

        pc = GridVCyclePC.from_grid_model(
            model.divergence, mesh.topology_shape, cells_per_site=model.cells_per_site,
            A0_apply=model.implicit_matvec(), A0_apply_fm=model.implicit_matvec_fm(),
            shift=1.0, dtype=dtype)
        return pc.apply_fm
    if mix["pc"] == "dct2lm":
        from circulantpreconditioner_tpu_torch.solvers.circulant_pc import DCTBlockProjectionPC

        coarse = DCTBlockProjectionPC(mesh, model.dt, model.c0, device=device, dtype=dtype,
                                      precision=mix["precision"])
        return pcs.multiplicative(model.implicit_matvec_fm(),
                                  pcs.cell_major_adapter(coarse.apply, model.nb),
                                  pcs.pbjacobi_fm(model.divergence, shift=1.0))
    raise ValueError(f"wave_gmres takes pc 'gridmg' or 'dct2lm', got {mix['pc']!r}")


def build(config: dict, mix: dict, device) -> Route:
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    if mix["boundary"] != "wall":
        raise ValueError("wave_gmres runs the wall-bounded mesh")
    dtype = dtype_of(config)
    mesh = port_mesh(config, periodic=False)
    model = WaveSystem(mesh, c0=config["c0"], cfl=config["cfl"], device=device, dtype=dtype)
    M = _preconditioner(mix, mesh, model, device, dtype)
    g = config["gmres"]
    step = model.implicit_stepper_fm(M_fm=M, rtol=g["rtol"], atol=g["atol"],
                                     maxiter=g["maxits"], restart=g["restart"], side="right")
    if step is None:
        raise ValueError("the mesh has no field-major form")
    return Route(implicit_request(step, model.dt, mix["steps_per_request"],
                                  pack=lambda U: model.pack_fm(U).reshape(-1),
                                  unpack=model.unpack_fm),
                 mix["steps_per_request"], step)

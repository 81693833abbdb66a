"""portbench: the end-to-end benchmark of circulantpreconditioner_tpu_torch.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m portbench.run --workload wave_kershaw64.gmres_gridmg --seed 7 \
        --seconds 30 --trace 0

`BENCHMARK.json` at the repository root names the cells and the metrics.
What belongs to one configuration, traffic mix, per-layer metric or cell is a
file of its own, found by name:

- `configs/<config>.json`: the deployment (mesh, physics, solver settings);
- `traffic/<mix>.json`: the route through the port, the request generator's
  parameters (steps per request, the spread of the initial states), warm-up;
- `routes/<route>.py`: how a route builds its stepper from the port's public
  API, as the port's driver builds it;
- `metrics/<metric>.py`: the reader of one per-layer metric;
- `limits/<cell>.json`: the limits of the comparison that decides `correct`;
- `reference/families/<family>.py`: the reference's geometry of a mesh
  family other than the cartesian and Kershaw lattices;
- `reference/kinds/<kind>.py`: a check kind other than `error` and
  `direct_error`: the reference's answers, the readings and the control.

`reference/` is the plain reference: frozen copies of the mesh generators
and the upwind assembly, in NumPy and SciPy, that import nothing of the port.
Nothing here imports jax or circulantpreconditioner_tpu.
"""

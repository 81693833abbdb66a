"""Rank workers for tests/test_torch_parallel*.py: worlds of P gloo ranks on
the CPU, each rank a spawned process running the port's distributed layer
on its block, in float64.

`spawn(fn, P, tmp_path, *args)` starts the world, runs `fn(*args)` in every
rank and returns each rank's result; the world is joined within its own time
limit, so a hung collective fails one test instead of the suite. The store is
a file in tmp_path (no TCP port). The checks below build their inputs from
fixed seeds with NumPy, as the tests build the JAX package's; the JAX side
is computed in the test process. This module imports torch and the port,
never jax.
"""

from __future__ import annotations

import collections
import contextlib
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

F64 = dict(device=torch.device("cpu"), dtype=torch.float64)
PENCIL = {1: (1, 1), 2: (2, 1), 4: (2, 2)}  # pencil (p, q) for each world size


def _entry(rank: int, P: int, store: str, out_dir: str, fn, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=P)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _entry_multihost(rank: int, P: int, coordinator: str, out_dir: str) -> None:
    """A rank that joins its world through init_multihost, as a user would."""
    from circulantpreconditioner_tpu_torch.parallel import (
        gather_to_host0,
        global_device_mesh,
        init_multihost,
    )

    torch.set_num_threads(1)
    init_multihost(coordinator, P, rank, device="cpu")
    try:
        mesh = global_device_mesh()
        result = (mesh.shape, mesh.coords, gather_to_host0(torch.full((2,), float(rank))))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _run_world(entry, args, P: int, out_dir: str, name: str, timeout: float) -> list:
    """Start P spawned processes entry(rank, *args), join them within
    `timeout` seconds, and return the results each wrote to out_dir."""
    ctx = mp.start_processes(entry, args=args, nprocs=P, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"a world of {P} ranks running {name} did not end "
                                   f"within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(P):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:  # written by _entry
            results.append(pickle.load(f))
    return results


def spawn(fn, P: int, tmp_path, *args, timeout: float = 300.0) -> list:
    """fn(*args) in each rank of a world of P gloo ranks; the ranks' results."""
    out_dir = os.path.join(str(tmp_path), f"world{P}_{fn.__name__}")
    os.makedirs(out_dir)
    return _run_world(_entry, (P, os.path.join(out_dir, "store"), out_dir, fn, args), P,
                      out_dir, fn.__name__, timeout)


def spawn_multihost(P: int, tmp_path, timeout: float = 120.0) -> list:
    """A world of P ranks joined by init_multihost at a free localhost port:
    each rank's (mesh shape, its coordinates, gather_to_host0's result)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_dir = os.path.join(str(tmp_path), f"multihost{P}")
    os.makedirs(out_dir)
    return _run_world(_entry_multihost, (P, f"localhost:{port}", out_dir), P, out_dir,
                      "init_multihost", timeout)


@contextlib.contextmanager
def count_collectives():
    """Counts the torch.distributed collectives called inside the block, by
    name (all_gather_single and all_gather_into_tensor as "all_gather"); a
    collective that calls another counts once."""
    counts = collections.Counter()
    names = ("all_to_all_single", "all_to_all", "all_gather_into_tensor", "all_gather_single",
             "all_gather", "all_reduce", "broadcast", "reduce_scatter_tensor", "gather",
             "scatter", "send", "recv", "isend", "irecv", "batch_isend_irecv")
    originals = {n: getattr(dist, n) for n in names if hasattr(dist, n)}
    depth = [0]

    def wrap(name, f):
        key = "all_gather" if name.startswith("all_gather") else name

        def counted(*a, **k):
            if depth[0] == 0:
                counts[key] += 1
            depth[0] += 1
            try:
                return f(*a, **k)
            finally:
                depth[0] -= 1
        return counted

    for n, f in originals.items():
        setattr(dist, n, wrap(n, f))
    try:
        yield counts
    finally:
        for n, f in originals.items():
            setattr(dist, n, f)


def np_(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# --- shared inputs ---------------------------------------------------------


def banded_bsr_coo(n: int = 203, b: int = 4, seed: int = 11):
    """A random banded block matrix, the stand-in for an RCM-ordered mesh
    operator of the JAX package's test_distributed.py: (rows, cols, blocks)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        for j in np.unique(np.clip(i + rng.integers(-6, 7, 4), 0, n - 1)):
            rows.append(i)
            cols.append(int(j))
    return np.asarray(rows), np.asarray(cols), rng.standard_normal((len(rows), b, b))


def kershaw8_wave(cfl: float = 333.0):
    from circulantpreconditioner_tpu_torch.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem

    km = kershaw_mesh(((0.0, 1.0),) * 3, (8, 8, 8))
    return km, WaveSystem(km, cfl=cfl, **F64)


# --- rank checks -----------------------------------------------------------


def ops_checks() -> dict:
    """The distributed operators on this world's mesh; arrays are the
    gathered results (every rank holds them)."""
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import TransportEquation, WaveSystem
    from circulantpreconditioner_tpu_torch.ops.assembly import wave_block_stencil
    from circulantpreconditioner_tpu_torch.ops.circulant import CirculantTransportOperator
    from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix
    from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator
    from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator
    from circulantpreconditioner_tpu_torch.parallel import (
        HaloELLMatrix,
        HaloWindowOperator,
        PencilCirculantSolver,
        ShardedELLMatrix,
        SlabBlockCirculantSolver,
        SlabCirculantSolver,
        SlabStencilOperator,
        device_mesh,
        device_mesh_2d,
        gather_to_host0,
        sharded_pbjacobi,
    )
    from circulantpreconditioner_tpu_torch.parallel.fft_dist import make_distributed_fft3

    P = dist.get_world_size()
    dm = device_mesh()
    out = {}

    # ShardedELLMatrix: 63 cells, the padding path
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (9, 7))
    A = WaveSystem(m, cfl=100.0, **F64).divergence.to_csr(torch.float64)
    As = ShardedELLMatrix(A, dm)
    x = np.random.default_rng(2).random(A.shape[1])
    out["sharded_ell"] = np_(As.unshard_vector(As.matvec(As.shard_vector(x))))
    out["sharded_ell_local"] = np_(A.matvec(torch.as_tensor(x)))

    # HaloELLMatrix, and the collectives of one apply
    m = cartesian_mesh(((-0.5, 0.5),) * 3, (4, 4, 16))
    A = WaveSystem(m, cfl=100.0, **F64).divergence.to_csr(torch.float64)
    Ah = HaloELLMatrix(A, dm)
    x = np.random.default_rng(5).random(A.shape[1])
    xs = Ah.shard_vector(x)
    with count_collectives() as counts:
        y = Ah.matvec(xs)
    out["halo_ell"] = np_(Ah.unshard_vector(y))
    out["halo_ell_local"] = np_(A.matvec(torch.as_tensor(x)))
    out["halo_ell_w"] = Ah.halo
    out["halo_ell_collectives"] = dict(counts)
    As = ShardedELLMatrix(A, dm)
    xs = As.shard_vector(x)
    with count_collectives() as counts:
        As.matvec(xs)
    out["sharded_ell_collectives"] = dict(counts)

    # the wide band: a periodic 1D transport operator
    t = TransportEquation(cartesian_mesh(((-0.5, 0.5),), (64,), periodic=True), [1.0],
                          cfl=10.0, **F64)
    try:
        HaloELLMatrix(t.divergence, dm)
        out["wide_band"] = None
    except ValueError as e:
        out["wide_band"] = str(e)

    # SlabStencilOperator: the flat layout (wave, wall) and grid_last (periodic)
    rng = np.random.default_rng(0)
    km = kershaw_mesh(((0.0, 1.0),) * 3, (4, 3, 8))
    V = VaryingStencilOperator.from_bsr(WaveSystem(km, cfl=10.0, **F64).divergence,
                                        km.topology_shape)
    S = SlabStencilOperator(V, dm)
    x = rng.random(km.n_cells * 4)
    with count_collectives() as counts:
        y = S.matvec(S.shard_vector(x))
    out["slab_flat"] = np_(S.unshard_vector(y))
    out["slab_flat_local"] = np_(V.matvec(torch.as_tensor(x)))
    out["slab_flat_layout"] = V.layout
    out["slab_collectives"] = dict(counts)
    km2 = kershaw_mesh(((0.0, 1.0),) * 3, (4, 4, 8))
    km2.set_periodic()
    t2 = TransportEquation(km2, [1.0, 0.5, -0.2], cfl=3.0, **F64)
    V2 = VaryingStencilOperator.from_csr(t2.divergence, km2.topology_shape)
    S2 = SlabStencilOperator(V2, dm)
    x2 = rng.random(km2.n_cells)
    out["slab_grid_last"] = np_(S2.unshard_vector(S2.matvec(S2.shard_vector(x2))))
    out["slab_grid_last_local"] = np_(V2.matvec(torch.as_tensor(x2)))
    out["slab_grid_last_layout"] = V2.layout

    # HaloWindowOperator on the random banded block matrix
    rows, cols, blocks = banded_bsr_coo()
    B = BSRMatrix.from_block_coo(203, 203, rows, cols, blocks, **F64)
    W = WindowedBlockOperator.from_bsr(B, G=8, unit=2)
    H = HaloWindowOperator(W, dm)
    x = np.random.default_rng(12).standard_normal(203 * 4)
    with count_collectives() as counts:
        y = H.matvec(H.shard_vector(x))
    out["window"] = np_(H.unshard_vector(y))
    out["window_local"] = np_(W.matvec(torch.as_tensor(x)))
    out["window_halo_units"] = H.halo_units
    out["window_collectives"] = dict(counts)

    # sharded_pbjacobi
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (6, 16))
    D = WaveSystem(m, cfl=200.0, **F64).divergence
    b = D.block_size
    Ah = HaloELLMatrix(D.to_csr(torch.float64), dm, row_multiple=b)
    Dinv = np.linalg.inv(np_(D.block_diagonal()) + np.eye(b)[None, :, :])
    M = sharded_pbjacobi(Dinv, Ah.n_padded, dm, dtype=torch.float64)
    r = np.random.default_rng(8).random(D.shape[0])
    out["pbjacobi"] = np_(Ah.unshard_vector(M(Ah.shard_vector(r))))

    # the slab and pencil circulant solves, the distributed FFT
    op = CirculantTransportOperator.create((16, 8, 12), (0.3, 0.8, 2.0), **F64)
    slab = SlabCirculantSolver.from_operator(op, dm)
    bb = np.random.default_rng(1).random((16, 8, 12))
    with count_collectives() as counts:
        xs = slab.solve(slab.shard(bb))
    out["slab_solve"] = np_(slab.unshard(xs))
    out["slab_solve_local"] = np_(op.solve(torch.as_tensor(bb)))
    out["slab_solve_collectives"] = dict(counts)
    dm2 = device_mesh_2d(PENCIL[P])
    rng = np.random.default_rng(3)
    for shape in ((8, 8, 6), (8, 8, 7)):
        op = CirculantTransportOperator.create(shape, (0.4, -0.3, 5.0), **F64)
        pen = PencilCirculantSolver.from_operator(op, dm2)
        bb = rng.random(shape)
        xp = pen.unshard(pen.solve(pen.shard(bb)))
        key = "pencil_" + "x".join(map(str, shape))
        out[key] = np_(xp)
        out[key + "_local"] = np_(op.solve(torch.as_tensor(bb)))
        out[key + "_residual"] = float((op.matvec(xp) - torch.as_tensor(bb)).abs().max())
    rng = np.random.default_rng(0)
    v = rng.random((8, 8, 4)) + 1j * rng.random((8, 8, 4))
    fwd, inv = make_distributed_fft3(dm), make_distributed_fft3(dm, inverse=True)
    vs = torch.as_tensor(v).reshape(P, -1, 8, 4)[dm.coords["shard"]]
    vh = fwd(vs)
    out["fft3"] = np_(dm.all_gather(vh, "shard"))
    out["fft3_back"] = np_(dm.all_gather(inv(vh), "shard"))

    # the all-matmul block-circulant slab solve
    offsets, blocks = wave_block_stencil(3, 0.01, 700.0, (1 / 6, 1 / 8, 1 / 8))
    sb = SlabBlockCirculantSolver.from_stencil((8, 8, 6), offsets, blocks, dm,
                                               dtype=torch.float64, precision="highest")
    bvec = np.random.default_rng(7).random(8 * 8 * 6 * 4)
    with count_collectives() as counts:
        xb = sb.solve(sb.shard(bvec))
    out["slab_block"] = np_(sb.unshard(xb)).reshape(-1)
    out["slab_block_collectives"] = dict(counts)

    full = gather_to_host0(torch.full((2, 3), float(dist.get_rank())))
    out["gather_to_host0"] = full
    return out


def pc_checks() -> dict:
    """The distributed projection PC (both forms), its exchange plan, and the
    sharded GMRES over each distributed operator."""
    from circulantpreconditioner_tpu_torch.mesh import cartesian_mesh
    from circulantpreconditioner_tpu_torch.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.ops.stencil import VaryingStencilOperator
    from circulantpreconditioner_tpu_torch.parallel import (
        DistributedBlockCirculantPC,
        HaloELLMatrix,
        ShardedELLMatrix,
        SlabStencilOperator,
        device_mesh,
        sharded_pbjacobi,
    )
    from circulantpreconditioner_tpu_torch.solvers import make_gmres
    from circulantpreconditioner_tpu_torch.solvers import preconditioners as pcs

    dm = device_mesh()
    out = {}

    def solve(name, A, M, op, b, **kw):
        res = make_gmres(A, M, allreduce=dm.all_reduce, **kw)(b, b)
        out[name] = (np_(op.unshard_vector(res.x)), res.iters, res.converged)

    # the projection PC, halo and all-gather forms
    km, model = kershaw8_wave()
    D = model.divergence
    Ah = HaloELLMatrix(D.to_csr(torch.float64), dm, row_multiple=4)
    r = Ah.shard_vector(np.random.default_rng(9).random(D.shape[0]))
    for halo in (True, False):
        pc = DistributedBlockCirculantPC(km, model.dt, model.c0, dm, Ah.n_padded,
                                         dtype=torch.float64, precision="highest", halo=halo)
        with count_collectives() as counts:
            z = pc.apply(r)
        key = "pc_halo" if halo else "pc_gather"
        out[key] = np_(Ah.unshard_vector(z))
        out[key + "_collectives"] = dict(counts)
        out["pc_grid"] = pc.n_xyz
        if halo:
            out["pc_halo_widths"] = (pc.halo_fwd, pc.halo_bak)

    # sharded GMRES: the halo SpMV, no PC
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (6, 16))
    w = WaveSystem(m, cfl=200.0, **F64)
    A = HaloELLMatrix(w.divergence.to_csr(torch.float64), dm)
    b = A.shard_vector(w.initial_state())
    for tol in (1e-10, 1e-8):
        solve(f"gmres_halo_{tol:g}", lambda v: v + A.matvec(v), None, A, b, rtol=tol,
              atol=tol * 1e-2, maxiter=500)
    # the all-gather SpMV
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (8, 8))
    w = WaveSystem(m, cfl=1e3 / 2, **F64)
    A = ShardedELLMatrix(w.divergence.to_csr(torch.float64), dm)
    b = A.shard_vector(w.initial_state())
    solve("gmres_allgather", lambda v: v + A.matvec(v), None, A, b, rtol=1e-10, atol=1e-12,
          maxiter=500)
    # the slab stencil, GMRES on the flattened slab
    k = kershaw_mesh(((0.0, 1.0),) * 3, (4, 4, 8))
    w = WaveSystem(k, cfl=50.0, **F64)
    S = SlabStencilOperator(VaryingStencilOperator.from_bsr(w.divergence, k.topology_shape), dm)
    b = S.shard_vector(w.initial_state())
    slab = b.shape
    res = make_gmres(lambda v: (v.reshape(slab) + S.matvec(v.reshape(slab))).reshape(-1),
                     rtol=1e-8, atol=1e-10, maxiter=500, allreduce=dm.all_reduce)(
        b.reshape(-1), b.reshape(-1))
    out["gmres_slab"] = (np_(S.unshard_vector(res.x.reshape(slab))), res.iters, res.converged)
    # point-block Jacobi, left
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (8, 16))
    w = WaveSystem(m, cfl=100.0, **F64)
    D2 = w.divergence
    b2 = D2.block_size
    A = HaloELLMatrix(D2.to_csr(torch.float64), dm, row_multiple=b2)
    Dinv = np.linalg.inv(np_(D2.block_diagonal()) + np.eye(b2)[None, :, :])
    M = sharded_pbjacobi(Dinv, A.n_padded, dm, dtype=torch.float64)
    b = A.shard_vector(w.initial_state())
    solve("gmres_pbjacobi", lambda v: v + A.matvec(v), M, A, b, rtol=1e-8, atol=1e-10,
          maxiter=500)
    # the true-residual check (right) across ranks: the upwind transport
    # problem of test_torch_true_residual.py, M Jacobi plus a term ‖r‖·e
    # that makes it non-linear, so that the estimate lies
    from circulantpreconditioner_tpu_torch.models import TransportEquation
    from circulantpreconditioner_tpu_torch.utils.graphs import STATS

    def gnorm(v):
        return torch.sqrt(dm.all_reduce(torch.dot(v, v).reshape(1)))[0]

    t = TransportEquation(cartesian_mesh(((-0.5, 0.5),) * 3, (8, 6, 5), periodic=False),
                          (1.0, 0.5, 0.25), cfl=20.0, **F64)
    A = HaloELLMatrix(t.divergence, dm)
    dinv = A.shard_vector(np_(1.0 / (t.divergence.diagonal() + 1.0)))
    b = A.shard_vector(np.random.default_rng(0).normal(size=t.mesh.n_cells) + 600.0)
    e = A.shard_vector(np.random.default_rng(5).random(t.mesh.n_cells))
    e = e * (1e-3 / gnorm(e))
    forced = STATS.true_restarts
    res = make_gmres(lambda v: v + A.matvec(v), lambda r: dinv * r + gnorm(r) * e, rtol=1e-8,
                     atol=0.0, maxiter=500, side="right", allreduce=dm.all_reduce,
                     true_residual=True)(b)
    true = gnorm(b - res.x - A.matvec(res.x))
    out["gmres_true_residual"] = (np_(A.unshard_vector(res.x)), res.iters, res.converged,
                                  STATS.true_restarts - forced, res.resnorm, float(true),
                                  float(gnorm(b)))
    # circulant2l on Kershaw 8^3: the projection PC + pbjacobi, right
    coarse = DistributedBlockCirculantPC(km, model.dt, model.c0, dm, Ah.n_padded,
                                         dtype=torch.float64, precision="highest")
    Dinv = np.linalg.inv(np_(D.block_diagonal()) + np.eye(4)[None, :, :])
    M = pcs.additive(coarse.apply, sharded_pbjacobi(Dinv, Ah.n_padded, dm, dtype=torch.float64))
    b = Ah.shard_vector(model.initial_state())
    solve("gmres_circulant2l", lambda v: v + Ah.matvec(v), M, Ah, b, rtol=1e-8, atol=1e-10,
          maxiter=500, side="right")
    return out


def driver_runs(runs) -> list:
    """Each (driver name, argv) run as `main(argv + ["--device", "cpu"])` in
    this rank: (gathered final state, GMRES iterations per step, rank 0's
    stdout) per run."""
    import importlib
    import io

    out = []
    for name, argv in runs:
        main = importlib.import_module(f"circulantpreconditioner_tpu_torch.drivers.{name}").main
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = main(list(argv) + ["--device", "cpu"])
        its = [d["extras"][0] for d in res.diagnostics if d["extras"]]
        out.append((np_(res.state).reshape(-1), its, res.iterations, text.getvalue()))
    return out


def vcycle_checks(cases, gmres_case) -> dict:
    """The sharded grid V-cycle (parallel/vcycle_dist.py) on this world's
    mesh. cases: (n, bottom_max, cfl) Kershaw n³ wave systems, each applied to
    a residual from a fixed seed, with the one-device GridVCyclePC's apply_fm
    beside it and the collectives of one apply; gmres_case: (n, bottom_max,
    cfl, rtol), the row-sharded field-major GMRES right-preconditioned by it,
    and the same solve on one device. Arrays are gathered, field-major."""
    from circulantpreconditioner_tpu_torch.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu_torch.models import WaveSystem
    from circulantpreconditioner_tpu_torch.parallel import SlabGridVCyclePC, device_mesh
    from circulantpreconditioner_tpu_torch.solvers import make_gmres

    P = dist.get_world_size()
    dm = device_mesh()
    out = {}

    def wave(n, cfl, shape=None):
        km = kershaw_mesh(((0.0, 1.0),) * 3, shape or (n, n, n))
        return WaveSystem(km, cfl=cfl, **F64)

    for n, bottom_max, cfl in cases:
        model = wave(n, cfl)
        spc = SlabGridVCyclePC.from_wave_model(model, dm, bottom_max=bottom_max)
        r_cm = np.random.default_rng(n).random(model.divergence.shape[0])
        g = torch.as_tensor(r_cm).reshape(-1, 4).T.reshape(-1)
        rs = spc.shard(g)
        with count_collectives() as counts:
            z = spc.apply(rs)
        out[("apply", n)] = {"z": np_(spc.unshard(z)), "z_1dev": np_(spc.pc.apply_fm(g)),
                             "collectives": dict(counts), "sharded_levels": len(spc.levels),
                             "levels": len(spc.pc.levels), "gather_level": spc.gather_level,
                             "gather_values": spc.gather_values, "describe": spc.describe()}

    n, bottom_max, cfl, rtol = gmres_case
    model = wave(n, cfl)
    spc = SlabGridVCyclePC.from_wave_model(model, dm, bottom_max=bottom_max)
    g0 = model.pack_fm(model.initial_state()).reshape(-1)
    b = spc.shard(g0)
    res = make_gmres(spc.fine, spc.apply, rtol=rtol, atol=rtol, maxiter=100, side="right",
                     allreduce=dm.all_reduce)(b, b)
    one = make_gmres(model.implicit_matvec_fm(), spc.pc.apply_fm, rtol=rtol, atol=rtol,
                     maxiter=100, side="right")(g0, g0)
    out["gmres"] = {"x": np_(spc.unshard(res.x)), "iters": res.iters,
                    "converged": res.converged, "x_1dev": np_(one.x), "iters_1dev": one.iters}

    # nz must divide over the ranks (nz = 2P + 1 does for P = 1 only)
    try:
        SlabGridVCyclePC.from_wave_model(wave(4, cfl, (4, 4, 2 * P + 1)), dm, bottom_max=8)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def bench_dist_checks(n: int) -> dict:
    """The distributed rows of the port's bench_suite.py on this world: the
    row's case (`dist_case`) at Kershaw n³ in float64, gathered; the record
    `dist_record` makes of it (with stand-in times); and `dist_worker` run
    with stand-ins for the case and the timer (fake counts, a fake clock):
    its exit code and rank 0's printed record, for counts that pass the
    gates and for a circulant2l count that misses them."""
    import io

    from circulantpreconditioner_tpu_torch import bench as tb
    from circulantpreconditioner_tpu_torch import bench_suite as ts
    from circulantpreconditioner_tpu_torch.parallel import device_mesh

    dm = device_mesh()
    P = dist.get_world_size()
    case = ts.dist_case(n, mesh=dm, **F64)
    out = {"circ": (np_(case.extra["unshard_circ"](case.circ.state)), case.circ.iters,
                    case.circ.converged),
           "grid": (np_(case.extra["unshard_grid"](case.grid.state)), case.grid.iters,
                    case.grid.converged),
           "grid_1dev": None if case.grid_1dev is None else (
               np_(case.grid_1dev.state), case.grid_1dev.iters, case.grid_1dev.converged),
           "levels": case.extra["gridmg_levels"]}
    fake_t = {"ms": 1.0, "chain": {}, "launches_per_step": {"K1": 0, "K2": 0, "K3": 0},
              "device_ms_per_step": 1.0}
    out["record"] = ts.dist_record(n, P, case, fake_t, fake_t, fake_t["launches_per_step"],
                                   ts.dist_cards(dm.device))
    case.release()

    def fake_case(circ_iters, grid_iters, one_iters):
        def k(iters):
            return ts.KrylovCase(None, None, iters, True, None)
        return lambda n_, mesh, device, precision: ts.DistCase(
            k(circ_iters), k(grid_iters), k(one_iters) if dist.get_rank() == 0 else None,
            {"unknowns": 4 * n_**3, "pc_halo_fwd": 1, "pc_halo_bak": 1, "spmv_halo": 1,
             "gridmg_levels": "fake"})

    def fake_time(case_, mesh, chains):
        # a fake clock: 5 ms per chain plus 40 ms per step
        chain = lambda K: 5e-3 + 40e-3 * K  # noqa: E731
        t = tb.paired_chain_estimate(chain, *chains)
        return {"ms": t.per_s * 1e3, "chain": t.as_dict(),
                "launches_per_step": {"K1": 0, "K2": 100, "K3": 0}, "device_ms_per_step": 30.0}

    patched = {"dist_case": None, "dist_time": fake_time,
               "one_device_launches": lambda c: {"K1": 0, "K2": 100, "K3": 0}}
    saved = {k: getattr(ts, k) for k in patched}
    try:
        for name, counts in (("pass", (99, 33, 33)), ("miss", (120, 33, 33))):
            patched["dist_case"] = fake_case(*counts)
            for k, v in patched.items():
                setattr(ts, k, v)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = ts.dist_worker(32, device="cpu")
            out[name] = (rc, text.getvalue())
    finally:
        for k, v in saved.items():
            setattr(ts, k, v)
    return out

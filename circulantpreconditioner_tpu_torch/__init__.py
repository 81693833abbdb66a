"""circulantpreconditioner_tpu_torch — PyTorch + CUDA port of
circulantpreconditioner_tpu, for one NVIDIA H100.

Slice 1, the main path: implicit upwind transport C = I + Σ_d λ_d (I − shift_d)
on a periodic cartesian grid, solved directly (FFT → divide by Λ → inverse
FFT, or as dense DFT contractions) and used as the preconditioner inside
GMRES. The fused 3D circulant solve runs in a hand-written CUDA kernel
(ops/fused_circulant.py, csrc/fused_circulant.cu).

Slice 2: the wave system on cartesian, hexa and Kershaw grids, stepped
explicitly or by GMRES with point-block Jacobi or the grid V-cycle
preconditioner. Its field-major SpMV runs in a hand-written CUDA kernel
(ops/plane_stencil.py, csrc/plane_stencil.cu).

Slice 3: the block-circulant and wall-boundary DCT/DST direct solves, the
clustered-window SpMV, and the cartesian-projection FFT preconditioners for
non-cartesian meshes (solvers/circulant_pc.py) in both implicit drivers. The
staged DFT solver's complex y/z stages can run in a hand-written CUDA kernel
(ops/complex_matmul.py, csrc/complex_matmul.cu).

Slice 6: ILU(0) and block-Jacobi ILU(0) (the implicit wave driver's default
preconditioner), the algebraic aggregation V-cycle, CG and BiCGStab, and the
diffusion equation (model, assembly, projection preconditioner, driver). No
TPU kernel lies on these paths: they run in plain PyTorch on the card.

Slice 7: the tetrahedral meshes and the supercell stencil path.

Slice 8: mesh files in, results out: the Gmsh, MED and typ3 readers (node
welding, non-conforming repair, grid-topology recovery, RCM renumbering),
the VTK and MED writers and the profiling utilities (utils/profiling.py).
MED files need h5py, which is imported only when one is read or written.

Slice 9: the distributed layer on torch.distributed, one process per device
(parallel/: the slab and pencil FFT solves, the halo, slab and window SpMVs,
the distributed projection PC) and the drivers' --shard modes. This module
does not import it, so importing the package opens no process group.

This package imports torch, numpy and scipy, never jax; the JAX package is
the reference it is tested against (tests/test_torch_*.py).
"""

__version__ = "0.1.0"

from circulantpreconditioner_tpu_torch.utils.device import resolve_device  # noqa: F401
from circulantpreconditioner_tpu_torch.mesh import (  # noqa: F401
    Mesh,
    cartesian_mesh,
    hex_mesh,
    kershaw_mesh,
)
from circulantpreconditioner_tpu_torch.ops import (  # noqa: F401
    BlockCirculantOperator,
    BSRMatrix,
    CirculantTransportOperator,
    CSRMatrix,
    DCTBlockWaveSolver,
    DenseCirculantSolver,
    FusedCirculantSolver,
    IdentitySolver,
    MatmulBlockCirculantSolver,
    MatmulCirculantSolver,
    TransportStencilOperator,
    VaryingStencilOperator,
    WaveNormalStencilOperator,
    WaveStencilOperator,
    WindowedBlockOperator,
    eigenvalue_diagonal,
    make_circulant_solver,
    make_plane_stencil_matvec,
    transport_column,
    transport_spectrum,
)
from circulantpreconditioner_tpu_torch.solvers import (  # noqa: F401
    AggregationVCyclePC,
    KrylovResult,
    bicgstab,
    cg,
    gmres,
    make_bicgstab,
    make_cg,
    make_gmres,
)
from circulantpreconditioner_tpu_torch.models import (  # noqa: F401
    DiffusionEquation,
    TimeLoopResult,
    TransportEquation,
    WaveSystem,
    run_time_loop,
    scan_steps,
)

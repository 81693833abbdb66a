from circulantpreconditioner_tpu_torch.ops.circulant import (  # noqa: F401
    BlockCirculantOperator,
    CirculantTransportOperator,
    eigenvalue_diagonal,
    np_eigenvalue_diagonal,
    np_transport_spectrum,
    stencil_symbol,
    transport_column,
    transport_spectrum,
)
from circulantpreconditioner_tpu_torch.ops.complex_matmul import (  # noqa: F401
    ComplexMatmulKernel,
    complex_matmul_reference,
)
from circulantpreconditioner_tpu_torch.ops.csr import BSRMatrix, CSRMatrix  # noqa: F401
from circulantpreconditioner_tpu_torch.ops.dct_wave import DCTBlockWaveSolver  # noqa: F401
from circulantpreconditioner_tpu_torch.ops.dft_matmul import (  # noqa: F401
    MatmulBlockCirculantSolver,
    MatmulCirculantSolver,
)
from circulantpreconditioner_tpu_torch.ops.fused_circulant import (  # noqa: F401
    FusedCirculantSolver,
    fused_circulant_reference,
)
from circulantpreconditioner_tpu_torch.ops.spectral_collapse import (  # noqa: F401
    DenseCirculantSolver,
    IdentitySolver,
    make_circulant_solver,
)
from circulantpreconditioner_tpu_torch.ops.stencil import (  # noqa: F401
    TransportStencilOperator,
    VaryingStencilOperator,
    WaveNormalStencilOperator,
    WaveStencilOperator,
)
from circulantpreconditioner_tpu_torch.ops.plane_stencil import (  # noqa: F401
    PlaneStencilMatvec,
    make_plane_stencil_matvec,
)
from circulantpreconditioner_tpu_torch.ops.window_spmv import WindowedBlockOperator  # noqa: F401

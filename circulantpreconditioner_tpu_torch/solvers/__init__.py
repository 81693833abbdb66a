from circulantpreconditioner_tpu_torch.solvers.gmres import (  # noqa: F401
    KrylovResult,
    gmres,
    make_gmres,
)
from circulantpreconditioner_tpu_torch.solvers.cg import cg, make_cg  # noqa: F401
from circulantpreconditioner_tpu_torch.solvers.bicgstab import bicgstab, make_bicgstab  # noqa: F401
from circulantpreconditioner_tpu_torch.solvers import preconditioners  # noqa: F401
from circulantpreconditioner_tpu_torch.solvers.aggregation_pc import (  # noqa: F401
    AggregationVCyclePC,
)

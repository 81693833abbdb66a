"""The distributed layer on torch.distributed, one process per device (see
mesh_utils.py). Importing it opens no process group: `rank_world`,
`init_multihost` or the caller's own init_process_group does."""

from circulantpreconditioner_tpu_torch.parallel.mesh_utils import (  # noqa: F401
    RankMesh,
    device_mesh,
    device_mesh_2d,
)
from circulantpreconditioner_tpu_torch.parallel.fft_dist import (  # noqa: F401
    PencilCirculantSolver,
    SlabCirculantSolver,
)
from circulantpreconditioner_tpu_torch.parallel.spmv_dist import (  # noqa: F401
    HaloELLMatrix,
    ShardedELLMatrix,
)
from circulantpreconditioner_tpu_torch.parallel.multihost import (  # noqa: F401
    gather_to_host0,
    global_device_mesh,
    init_multihost,
    rank_world,
)
from circulantpreconditioner_tpu_torch.parallel.stencil_dist import SlabStencilOperator  # noqa: F401
from circulantpreconditioner_tpu_torch.parallel.window_dist import HaloWindowOperator  # noqa: F401
from circulantpreconditioner_tpu_torch.parallel.pc_dist import (  # noqa: F401
    DistributedBlockCirculantPC,
    SlabBlockCirculantSolver,
    sharded_pbjacobi,
)
from circulantpreconditioner_tpu_torch.parallel.vcycle_dist import (  # noqa: F401
    SlabFmStencil,
    SlabGridVCyclePC,
)

from circulantpreconditioner_tpu_torch.mesh.core import BoundaryGroup, Mesh  # noqa: F401
from circulantpreconditioner_tpu_torch.mesh.med import read_med, read_mesh  # noqa: F401
from circulantpreconditioner_tpu_torch.mesh.structured import (  # noqa: F401
    cartesian_mesh,
    set_group_at_plane,
)
from circulantpreconditioner_tpu_torch.mesh.typ3 import read_typ3  # noqa: F401
from circulantpreconditioner_tpu_torch.mesh.unstructured import (  # noqa: F401
    build_mesh_from_cells,
    hex_mesh,
    kershaw_mesh,
    kershaw_tet_mesh,
    read_gmsh,
    tet_mesh,
)

from circulantpreconditioner_tpu_torch.io.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from circulantpreconditioner_tpu_torch.io.med_io import (  # noqa: F401
    med_cell_order,
    read_med_field,
    write_med,
)
from circulantpreconditioner_tpu_torch.io.vtk import write_vtk  # noqa: F401

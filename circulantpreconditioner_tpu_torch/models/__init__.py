from circulantpreconditioner_tpu_torch.models.runner import (  # noqa: F401
    TimeLoopResult,
    run_time_loop,
    scan_steps,
)
from circulantpreconditioner_tpu_torch.models.transport import (  # noqa: F401
    TransportEquation,
    spherical_explosion_scalar,
)
from circulantpreconditioner_tpu_torch.models.wave import (  # noqa: F401
    C0,
    P0,
    WaveSystem,
    spherical_explosion_wave,
)
from circulantpreconditioner_tpu_torch.models.diffusion import DiffusionEquation  # noqa: F401

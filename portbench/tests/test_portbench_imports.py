"""Nothing portbench runs imports jax or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's); the
reference imports nothing of the port either."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from portbench.run import forbidden_modules

REPO = Path(__file__).resolve().parents[2]


def test_top_level_names_compared_whole():
    assert forbidden_modules(["circulantpreconditioner_tpu_torch.ops.circulant", "numpy"]) == []
    assert forbidden_modules(["circulantpreconditioner_tpu.ops"]) == ["circulantpreconditioner_tpu"]
    assert forbidden_modules(["jax._src.core", "jaxlib.xla_client", "flax"]) == [
        "flax", "jax", "jaxlib"]
    assert forbidden_modules(["jaxtyping", "flaxen"]) == []


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    return set(out.stdout.split())


def test_the_harness_and_routes_load_no_jax():
    loaded = _loaded_after(
        "import portbench.run, portbench.control, portbench.trace, portbench.roofline\n"
        "import portbench.routes.transport_gmres, portbench.routes.transport_direct\n"
        "import portbench.routes.wave_gmres, portbench.metrics.k2_roofline\n"
        "import circulantpreconditioner_tpu_torch.models")
    assert not loaded & {"jax", "jaxlib", "flax", "circulantpreconditioner_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import portbench.reference.checks, portbench.reference.control, "
                           "portbench.reference.operators, portbench.reference.mesh")
    assert not loaded & {"jax", "jaxlib", "flax", "circulantpreconditioner_tpu",
                         "circulantpreconditioner_tpu_torch"}

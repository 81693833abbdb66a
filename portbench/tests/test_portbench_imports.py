"""Nothing portbench runs imports jax or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's); the
reference imports nothing of the port either."""

from __future__ import annotations

import pkgutil
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


def every_module(package: str) -> list[str]:
    """The modules of a package of the benchmark, those added later too."""
    path = REPO.joinpath(*package.split("."))
    return [f"{package}.{m.name}" for m in pkgutil.iter_modules([str(path)])]


def test_the_harness_and_routes_load_no_jax():
    modules = every_module("portbench.routes") + every_module("portbench.metrics")
    assert "portbench.routes.wave_gmres" in modules
    loaded = _loaded_after(
        "import portbench.run, portbench.control, portbench.trace, portbench.roofline\n"
        f"import {', '.join(modules)}\n"
        "import circulantpreconditioner_tpu_torch.models")
    assert not loaded & {"jax", "jaxlib", "flax", "circulantpreconditioner_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    modules = (every_module("portbench.reference") + every_module("portbench.reference.families")
               + every_module("portbench.reference.kinds"))
    assert "portbench.reference.families.kershawtet" in modules
    loaded = _loaded_after(f"import {', '.join(modules)}")
    assert not loaded & {"jax", "jaxlib", "flax", "circulantpreconditioner_tpu",
                         "circulantpreconditioner_tpu_torch"}

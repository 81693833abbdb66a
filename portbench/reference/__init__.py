"""The plain reference of portbench: frozen copies of the mesh generators and
of the upwind assembly of the transport and wave operators, in NumPy and
SciPy (float64), with the comparisons that decide `correct` and their
lower-precision controls. It imports nothing of
circulantpreconditioner_tpu_torch, of circulantpreconditioner_tpu or of jax.

A configuration's geometry is found by its mesh family (`family`): the
cartesian and Kershaw lattices in reference/mesh.py, any other family `<f>`
in reference/families/<f>.py. A check kind other than the built-in ones is
found by name in reference/kinds/ (reference/checks.py).
"""

from __future__ import annotations

import importlib
from types import ModuleType

LATTICES = ("cartesian", "kershaw")


def family(mesh: dict) -> ModuleType:
    """The module holding `cell_centres(mesh)` and `geometry(mesh, periodic)`
    for the configuration's `mesh` entry."""
    name = mesh["family"]
    if name in LATTICES:
        return importlib.import_module("portbench.reference.mesh")
    return importlib.import_module(f"portbench.reference.families.{name}")

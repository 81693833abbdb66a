"""Mesh families of the reference beyond the cartesian and Kershaw lattices
(reference/mesh.py): `families/<family>.py` for a configuration whose
`mesh.family` is `<family>`, found by `portbench.reference.family`. Each
module gives `cell_centres(mesh)` and `geometry(mesh, periodic)` (a
reference.mesh.Geometry, any number of faces a cell) and imports nothing of
the port."""

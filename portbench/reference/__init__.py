"""The plain reference of portbench: frozen copies of the cartesian and
Kershaw mesh generators and of the upwind assembly of the transport and
wave operators, in NumPy and SciPy (float64), with the comparisons that
decide `correct` and their lower-precision controls. It imports nothing of
circulantpreconditioner_tpu_torch, of circulantpreconditioner_tpu or of jax.
"""

"""Device-side numerical core (JAX/XLA).

Everything from FEM stiffness assembly through the linear solve and field
post-processing runs here as jittable functions over flat arrays — the
device replacement for the reference's scipy-sparse pipeline
(solver.py:171-213, 469-560, 767-780).

64-bit floats are enabled globally: the solver's accuracy gates (1e-9
residual, 1e-6 V parity vs scipy) are defined in f64.  The hot paths run
f32 with f64 iterative refinement on the device.
"""

import jax

jax.config.update("jax_enable_x64", True)

from . import assembly, cg, schur, spmv, postproc  # noqa: E402,F401

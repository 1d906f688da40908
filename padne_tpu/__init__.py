"""padne_tpu — a DC power-delivery-network analyzer for KiCad projects.

A ground-up rebuild of the capabilities of the reference padne tool:
KiCad project loading, copper geometry extraction, constrained-Delaunay
meshing (native C++ core), FEM assembly and an iterative linear solve
in JAX/XLA that runs on an NVIDIA GPU (or the CPU), field
post-processing, visualization and export.

Keep this import light: heavy numerical dependencies (jax) load lazily in
the modules that need them.
"""

__version__ = "0.1.0"


def _tune_allocator() -> None:
    """Keep large allocations on the reusable glibc heap.

    By default glibc serves multi-MB allocations via mmap and returns the
    pages to the kernel on free, so every large numpy temporary pays
    first-touch page faults again.  On virtualized hosts those faults can
    run at ~100-400 MB/s (measured here) while warm pages stream at
    ~7 GB/s — a 4-20x slowdown on the whole host-side pipeline (meshing,
    ELL packing, AMG setup).  Raising M_MMAP_THRESHOLD and disabling
    mmap-backed malloc keeps freed pages warm; process peak RSS then
    tracks peak live usage, which this workload is fine with.
    Opt out with PADNE_TPU_NO_MALLOC_TUNE=1.
    """
    import ctypes
    import os
    import sys

    if os.environ.get("PADNE_TPU_NO_MALLOC_TUNE") == "1":
        return
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 2**31 - 1)  # M_MMAP_THRESHOLD
        libc.mallopt(-4, 0)          # M_MMAP_MAX
    except OSError:  # non-glibc (musl etc.)
        pass


_tune_allocator()

from . import units, sexp  # noqa: E402,F401  (cheap, no heavy deps)

__all__ = [
    "units",
    "sexp",
    "geom",
    "mesh",
    "problem",
    "kicad",
    "solver",
    "ops",
    "parallel",
]

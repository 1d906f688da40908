"""Host-side profile of the DIA solver setup at the bench workload.

Runs on CPU (JAX_PLATFORMS=cpu) so the device upload is ~free and the
timings isolate HOST compute: ELL->CSR, Hilbert ordering, pack_dia,
Galerkin products, coarse eigh.  Usage:

    JAX_PLATFORMS=cpu python benchmarks/profile_setup.py [target_dof]
"""

import cProfile
import pathlib
import pstats
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]

# Host profiling: keep the device out of the measurement.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    target_dof = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000

    import boardgen
    from padne_tpu import kicad, mesh, runtime, solver
    from padne_tpu.ops import schur

    runtime.enable_compile_cache()
    work = tempfile.TemporaryDirectory(prefix="padne_profile_")
    pro = boardgen.gen_bench_4layer(
        pathlib.Path(work.name))
    prob = kicad.load_kicad_project(pro)
    area = sum(layer.shape.area for layer in prob.layers)
    size = max(0.05, (area / (0.43 * target_dof)) ** 0.5)
    cfg = mesh.Mesher.Config(
        maximum_size=size, variable_size_maximum_factor=1.0
    )
    t0 = time.time()
    system, meshes, *_ = solver.build_system(prob, mesher_config=cfg)
    print(f"mesh+assemble {time.time()-t0:.1f}s n={system.n}",
          flush=True)

    prof = cProfile.Profile()
    t0 = time.time()
    prof.enable()
    dia_solver = schur.DiaBorderedSolver(system)
    prof.disable()
    print(f"setup {time.time()-t0:.1f}s", flush=True)
    st = pstats.Stats(prof)
    st.sort_stats("cumulative").print_stats(40)


if __name__ == "__main__":
    main()

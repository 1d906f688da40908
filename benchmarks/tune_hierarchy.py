"""AMG-quality sweep: CG iteration counts per hierarchy variant.

Iteration count is backend-independent, so preconditioner quality can
be tuned on the CPU (JAX_PLATFORMS=cpu) as well as on the GPU; the
platform is whatever JAX_PLATFORMS selects.  Runs the bench board at a
reduced DoF target through the full DiaBorderedSolver and reports
iterations / passes / setup host time per variant.

Usage: python benchmarks/tune_hierarchy.py [target_dof] [variant ...]
"""

import pathlib
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]

VARIANTS = {
    "base": {},
    "coarse6000": {"coarse_size": 6000},
    "coarse1500": {"coarse_size": 1500},
    "smooth3": {"smooth_levels": 3},
    "smooth1": {"smooth_levels": 1},
    "cap16": {"cap": 16},
    "theta12": {"theta": 0.12},
    "theta5": {"theta": 0.05},
    "drop3": {"drop_tol": 1e-3},
    "offs12": {"max_offsets": 12},
    "cov99": {"coverage": 0.99},
}


def main():
    target = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000
    names = sys.argv[2:] or list(VARIANTS)

    import boardgen
    from padne_tpu import cli, kicad, mesh, solver
    from padne_tpu.ops import amg, schur

    cli.configure_jax()
    # Build the system once at the target density.
    work = tempfile.TemporaryDirectory(prefix="padne_tune_")
    pro = boardgen.gen_bench_4layer(
        pathlib.Path(work.name))
    prob = kicad.load_kicad_project(pro)
    area = sum(layer.shape.area for layer in prob.layers)
    size = max(0.05, (area / (0.43 * target)) ** 0.5)
    cfg = mesh.Mesher.Config(maximum_size=size,
                             variable_size_maximum_factor=1.0)
    system, *_ = solver.build_system(prob, mesher_config=cfg)
    print(f"n={system.n} m={system.border.m}", flush=True)
    bnorm = float(np.sqrt((system.r_core**2).sum()
                          + (system.border.rhs**2).sum()))

    base_build = amg.build_hierarchy_dia

    for name in names:
        kw = VARIANTS[name]

        def patched(ell, coords, **inner):
            inner = {**inner, **kw}
            inner.setdefault("coarse_size", 3000)
            return base_build(ell, coords, **{
                k: v for k, v in inner.items()})

        amg.build_hierarchy_dia = patched
        try:
            t0 = time.time()
            ds = schur.DiaBorderedSolver(system)
            t_setup = time.time() - t0
            t0 = time.time()
            res = ds.solve(target_residual=1e-8 * bnorm,
                           max_refinements=12)
            t_solve = time.time() - t0
            lv = ds.hierarchy.levels
            print(f"{name:12s} iters={res.cg_iterations:4d} "
                  f"passes={res.refinement_steps + 1} "
                  f"rel={res.residual_norm / bnorm:.2e} "
                  f"setup={t_setup:.1f}s solve={t_solve:.1f}s "
                  f"levels={[l.pack.np_ for l in lv]} "
                  f"rem={[len(l.pack.rem_rows) for l in lv]}",
                  flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"{name:12s} FAILED: {e}", flush=True)
        finally:
            amg.build_hierarchy_dia = base_build


if __name__ == "__main__":
    main()

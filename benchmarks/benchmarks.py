"""Pipeline-stage benchmark suite.

Role parity with the reference's 15 ASV suites (benchmarks/benchmarks.py
in padne): per-stage timings + tracked scale counters for every pipeline
phase, runnable standalone (no asv dependency):

    python benchmarks/benchmarks.py [--json] [--boards DIR] [--quick]

Covers: polygon booleans, mesh generation (3 geometries x 3 mesher
configs) + triangle/memory counters, board loading, connectivity,
node indexing, system assembly, linear solve (Jacobi vs AMG), distance
maps, post-processing, SpMV throughput.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from padne_tpu import runtime  # noqa: E402

# The platform is whatever JAX_PLATFORMS selects (JAX_PLATFORMS=cpu for
# a host-only run); the solve rows name it through track.py's machine
# fingerprint.
runtime.enable_compile_cache()


def _timer(fn, *args, repeat=3, **kw):
    best = float("inf")
    out = None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        best = min(best, time.perf_counter() - t0)
    return best, out


class Results:
    def __init__(self):
        self.rows = []

    def add(self, suite, name, value, unit):
        self.rows.append(
            {"suite": suite, "name": name, "value": value, "unit": unit}
        )
        print(f"{suite:28s} {name:42s} {value:12.6g} {unit}")


def bench_geometry(res: Results, quick: bool):
    from padne_tpu import geom

    rng = np.random.default_rng(3)
    prims = []
    n_prims = 300 if quick else 2000
    for _ in range(n_prims):
        x0, y0 = rng.uniform(0, 80, 2)
        ang = rng.uniform(0, 2 * np.pi)
        prims.append(
            geom.stroke_segment(
                x0, y0, x0 + 4 * np.cos(ang), y0 + 4 * np.sin(ang), 0.3
            )
        )
    t, mp = _timer(geom.union_all, prims, repeat=1 if quick else 3)
    res.add("geometry", f"union_{n_prims}_tracks", t, "s")

    plane = geom.box(0, 0, 80, 80)
    holes = [geom.circle(*rng.uniform(5, 75, 2), 0.2, 16) for _ in range(200)]
    t, _ = _timer(geom.difference, plane, holes)
    res.add("geometry", "punch_200_holes", t, "s")

    pts = rng.uniform(0, 80, (5000, 2))
    t, _ = _timer(mp.classify_points, pts)
    res.add("geometry", "classify_5000_points", t, "s")


def bench_meshing(res: Results, quick: bool):
    from padne_tpu import geom, mesh

    geoms = {
        "square_20mm": geom.box(0, 0, 20, 20),
        "holey_plane": geom.difference(
            geom.box(0, 0, 30, 30), geom.box(12, 12, 18, 18)
        ).geoms[0],
        "annulus": geom.difference(
            geom.circle(0, 0, 12, 64), geom.circle(0, 0, 2, 64)
        ).geoms[0],
    }
    configs = {
        "default": mesh.Mesher.Config(),
        "relaxed": mesh.Mesher.Config.RELAXED,
        "fixed_density": mesh.Mesher.Config(variable_size_maximum_factor=1.0),
    }
    for gname, g in geoms.items():
        for cname, cfg in configs.items():
            mesher = mesh.Mesher(cfg)
            t, m = _timer(mesher.poly_to_mesh, g, repeat=1 if quick else 3)
            res.add("meshing", f"{gname}/{cname}", t, "s")
            res.add("meshing", f"{gname}/{cname}/triangles", m.num_faces, "tris")

    # Derived-structure build (edges/boundary/cotans) on the largest mesh.
    m = mesh.Mesher(configs["fixed_density"]).poly_to_mesh(geoms["square_20mm"])
    t, _ = _timer(lambda: mesh.TriMesh(m.vertices, m.triangles).cotan_edge_weights)
    res.add("meshing", "derived_structures+cotans", t, "s")
    mem = m.vertices.nbytes + m.triangles.nbytes
    res.add("meshing", "mesh_arrays_bytes", mem, "B")


def bench_distance_map(res: Results, quick: bool):
    from padne_tpu import geom

    poly = geom.difference(
        geom.box(0, 0, 60, 60), geom.box(20, 20, 40, 40)
    ).geoms[0]
    t, dm = _timer(geom.DistanceMap, poly, 1.0)
    res.add("distance_map", "build_60mm_q1.0", t, "s")
    pts = np.random.default_rng(0).uniform(0, 60, (1000, 2))
    t, _ = _timer(dm.query_many, pts)
    res.add("distance_map", "query_1000", t, "s")


def bench_loading(res: Results, boards_dir: pathlib.Path, quick: bool):
    from padne_tpu import kicad

    names = ["simple_geometry", "via_tht_4layer", "two_big_planes"]
    if not quick:
        names.append("many_meshes")
    for name in names:
        pro = boards_dir / name / f"{name}.kicad_pro"
        if not pro.exists():
            continue
        t, prob = _timer(
            kicad.load_kicad_project, pro, repeat=1 if quick else 2
        )
        res.add("loading", name, t, "s")


def bench_solver(res: Results, boards_dir: pathlib.Path, quick: bool):
    import warnings

    from padne_tpu import kicad, mesh, solver
    from padne_tpu.ops import schur

    name = "via_tht_4layer"
    pro = boards_dir / name / f"{name}.kicad_pro"
    if not pro.exists():
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prob = kicad.load_kicad_project(pro)

        t, (indices, _, pairs) = _timer(solver.compute_connectivity, prob)
        res.add("solver", "connectivity", t, "s")

        mesher = mesh.Mesher()
        t, (meshes, m2l) = _timer(
            solver.generate_meshes_for_problem, prob, mesher, pairs, indices,
            repeat=1,
        )
        res.add("solver", "generate_meshes", t, "s")
        res.add("solver", "mesh_count", len(meshes), "meshes")

        vindex = solver.VertexIndexer.create(meshes)
        filtered = solver.filter_dead_networks(prob, indices, pairs)
        t, ni = _timer(
            solver.NodeIndexer.create, prob, meshes, m2l, vindex, filtered
        )
        res.add("solver", "node_indexer", t, "s")

        t, (system, _) = _timer(
            solver.assemble_core_system,
            prob, meshes, m2l, vindex, filtered, ni, repeat=1,
        )
        res.add("solver", "assemble_system", t, "s")
        res.add("solver", "system_size", system.n + system.border.m, "vars")

        t, result = _timer(schur.solve_bordered, system, repeat=1)
        res.add("solver", "solve_bordered", t, "s")
        res.add("solver", "residual_norm", result.residual_norm, "")


def bench_device(res: Results, quick: bool):
    import jax
    import jax.numpy as jnp

    from padne_tpu import geom, mesh
    from padne_tpu.ops import amg, assembly, cg
    from padne_tpu.ops.spmv import ell_matvec

    size = 0.6 if quick else 0.3
    m = mesh.Mesher(
        mesh.Mesher.Config(maximum_size=size, variable_size_maximum_factor=1.0)
    ).poly_to_mesh(geom.box(0, 0, 40, 40))
    ell = assembly.build_ell(
        m.num_vertices, m.edges.astype(np.int64), m.cotan_edge_weights
    )
    n = m.num_vertices
    res.add("device", "spmv_n", n, "rows")
    cols, vals, diag = ell.to_device()
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal((n, 8)), dtype=vals.dtype
    )
    f = jax.jit(lambda x: ell_matvec(cols, vals, diag, x))
    jax.block_until_ready(f(x))
    t, _ = _timer(lambda: jax.block_until_ready(f(x)), repeat=5)
    res.add("device", "ell_spmv_r8", t, "s")

    b = np.zeros((n, 4))
    rng = np.random.default_rng(1)
    for k in range(4):
        i, j = rng.integers(0, n, 2)
        b[i, k] += 1
        b[j, k] -= 1
    bj = jnp.asarray(b, dtype=vals.dtype)
    cid = jnp.zeros(n, dtype=jnp.int32)

    t, h = _timer(amg.build_hierarchy, ell, repeat=1)
    res.add("device", "amg_setup", t, "s")
    solver_amg = cg.make_pcg(cols, vals, diag, cid, 1, precond=amg.make_vcycle(h, dtype=vals.dtype))
    r = solver_amg(bj, 1e-8, 500)
    jax.block_until_ready(r.x)
    t, r = _timer(lambda: solver_amg(bj, 1e-8, 500), repeat=1)
    jax.block_until_ready(r.x)
    res.add("device", "amg_pcg_solve", t, "s")
    res.add("device", "amg_pcg_iterations", int(r.iterations), "iters")


def bench_native(res: Results, quick: bool):
    """The native assembly/setup kernels (pg_unique_edges, pg_build_ell,
    pg_pack_dia, pg_hilbert_order) at a representative size."""
    from padne_tpu import geom, mesh, native
    from padne_tpu.ops import bell, dia

    size = 0.5 if quick else 0.2
    m = mesh.Mesher(
        mesh.Mesher.Config(maximum_size=size,
                           variable_size_maximum_factor=1.0)
    ).poly_to_mesh(geom.box(0, 0, 40, 40))
    res.add("native", "mesh_n", m.num_vertices, "verts")

    t, (edges, inverse) = _timer(native.unique_edges, m.triangles)
    res.add("native", "unique_edges", t, "s")

    w = m.cotan_edge_weights
    t, _ = _timer(native.build_ell, m.num_vertices,
                  edges[:, 0].astype(np.int64),
                  edges[:, 1].astype(np.int64), w)
    res.add("native", "build_ell", t, "s")

    t, perm = _timer(bell.hilbert_order, m.vertices)
    res.add("native", "hilbert_order", t, "s")

    from padne_tpu.ops import assembly

    ell = assembly.build_ell(m.num_vertices, edges.astype(np.int64), w)
    t, pack = _timer(dia.pack_ell_as_dia, ell, perm=perm)
    res.add("native", "pack_dia", t, "s")
    res.add("native", "pack_dia_remainder", len(pack.rem_rows), "nnz")

    t, (ip, ix, dt_) = _timer(native.ell_to_csr, ell.cols, ell.vals,
                              ell.diag)
    res.add("native", "ell_to_csr", t, "s")

    import scipy.sparse

    A = scipy.sparse.csr_matrix((dt_, ix, ip),
                                shape=(m.num_vertices, m.num_vertices))
    t, Ap = _timer(native.csr_permute, A, perm)
    res.add("native", "csr_permute", t, "s")

    from padne_tpu.ops import amg

    d = np.asarray(Ap.diagonal())
    dinv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    strength = amg._strength_pattern(Ap, 0.08)
    agg, nc = amg._aggregate_capped(Ap, 8, 0.08, strength=strength)
    t, _ = _timer(native.galerkin, Ap, agg, nc, dinv, 0.4, 1e-4)
    res.add("native", "galerkin", t, "s")

    # Point classification: parse once, query many (the connectivity /
    # seed-placement hot loop).
    poly = geom.Polygon(
        [(0, 0), (40, 0), (40, 40), (0, 40)],
        holes=[[(x + 0.2, y + 0.2), (x + 0.8, y + 0.2),
                (x + 0.8, y + 0.8), (x + 0.2, y + 0.8)]
               for x in range(2, 38, 2) for y in range(2, 38, 2)],
    )
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 40, size=(20_000, 2))
    t, _ = _timer(poly.classify_points, pts)
    res.add("native", "classify_20k_pts_324_rings", t, "s")


def bench_postproc_export(res: Results, boards_dir: pathlib.Path,
                          quick: bool):
    """Post-processing + consumer stages (reference ASV analogs:
    PowerDensitySuite, NFormSuite, SpatialIndexSuite, RenderedMeshSuite,
    paraview; benchmarks.py:753-869)."""
    import tempfile
    import warnings

    import jax

    from padne_tpu import kicad, mesh, solver, ui
    from padne_tpu.io import htmlview, paraview
    from padne_tpu.ops import postproc

    name = "via_tht_4layer"
    pro = boards_dir / name / f"{name}.kicad_pro"
    if not pro.exists():
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol = solver.solve(kicad.load_kicad_project(pro))

    ls = sol.layer_solutions[0]
    m = ls.meshes[0]
    pot = ls.potentials[0]

    f = jax.jit(postproc.power_density)
    args_pd = (m.vertices, m.triangles, pot.values,
               sol.problem.layers[0].conductance)
    jax.block_until_ready(f(*args_pd))
    t, _ = _timer(lambda: jax.block_until_ready(f(*args_pd)), repeat=5)
    res.add("postproc", "power_density_jit", t, "s")

    t, _ = _timer(lambda: pot.d(), repeat=5)
    res.add("postproc", "zero_form_exterior_derivative", t, "s")

    viewer = ui.SolutionViewer(sol)
    viewer._probe_index()   # build the index outside the timed query
    x0, y0 = float(m.vertices[0, 0]), float(m.vertices[0, 1])
    t, _ = _timer(lambda: viewer.probe_value(x0, y0), repeat=5)
    res.add("postproc", "spatial_probe_query", t, "s")

    with tempfile.TemporaryDirectory() as td:
        t, _ = _timer(htmlview.export_html, sol,
                      pathlib.Path(td) / "v.html", repeat=1)
        res.add("export", "htmlview_export", t, "s")
        t, _ = _timer(paraview.export_solution, sol,
                      pathlib.Path(td) / "pv", repeat=1)
        res.add("export", "paraview_export", t, "s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--boards",
        type=pathlib.Path,
        default=pathlib.Path("/root/reference/tests/kicad"),
    )
    args = ap.parse_args()

    res = Results()
    bench_geometry(res, args.quick)
    bench_meshing(res, args.quick)
    bench_distance_map(res, args.quick)
    if args.boards.exists():
        bench_loading(res, args.boards, args.quick)
        bench_solver(res, args.boards, args.quick)
        bench_postproc_export(res, args.boards, args.quick)
    bench_device(res, args.quick)
    bench_native(res, args.quick)

    if args.json:
        print(json.dumps(res.rows))


if __name__ == "__main__":
    main()

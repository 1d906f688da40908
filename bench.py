"""North-star benchmark: the BASELINE.md workload — a 1M-DoF 4-layer
board solved to 1e-8 relative residual on one GPU.

The workload is generated (tests/boardgen.gen_bench_4layer): four
full-area copper planes, a 7x7 through-via stitching grid (each via
expands into the loader's hollow-cylinder resistor stack), two voltage
sources and two high-current loads — so the solve carries a real MNA
border (m > 1) and the meshes carry the full via-hole punching.

Pipeline timed per stage:
  load     KiCad project -> problem IR (host)
  mesh     connectivity + CDT meshing + FEM/MNA assembly (host)
  setup    AMG hierarchy + device upload (ops.schur.DiaBorderedSolver)
  solve    bordered Schur solve + f64 iterative refinement to
           1e-8 * ||rhs|| (median of 3 compile-warm runs)

Usage: python bench.py [target_dof]

Needs a GPU: without one it exits non-zero and prints no record.  The
device work runs in this one process.  Two probes run as subprocesses
pinned to the CPU (JAX_PLATFORMS=cpu): scipy's spsolve on the same
system, and a `padne-tpu serve` client against this process acting as
the daemon.

Prints ONE JSON line:
  {"metric": "solve_dof_per_sec", "value": N, "unit": "DoF/s",
   "detail": {...}}
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent


def _progress(msg, _t0=[None]):
    if _t0[0] is None:
        _t0[0] = time.time()
    print("[bench %7.1fs] %s" % (time.time() - _t0[0], msg),
          file=sys.stderr, flush=True)


def device_record() -> dict:
    """The GPU this run measures, as JAX and nvidia-smi report it.
    Raises SystemExit when the default device is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default device is "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs),
            "nvidia_smi": smi.stdout.strip().splitlines()}


def _save_system(system, v, path):
    """CoreSystem (+ our solution v) as flat arrays, for the probes."""
    from padne_tpu import serve

    np.savez(path, v=v, **serve._system_to_npz(system))


def _load_system(path):
    from padne_tpu import serve

    z = dict(np.load(path))
    return serve._system_from_npz(z), z["v"]


def _scipy_probe(path):
    """Head-to-head vs the reference's solver class: scipy spsolve
    (SuperLU, the reference's hot path, solver.py:767-780) on the SAME
    assembled system.  Prints one JSON line."""
    import scipy.sparse.linalg

    from padne_tpu import solver

    system, v_ours = _load_system(path)
    L, r = solver.system_to_scipy(system)
    t0 = time.time()
    z = scipy.sparse.linalg.spsolve(L, r)
    t_solve = time.time() - t0
    print(json.dumps({
        "reference_scipy_seconds": round(t_solve, 3),
        "reference_scipy_max_dv": float(np.max(np.abs(
            z[:system.n] - v_ours))),
    }))


def _serve_client_probe(path, socket_path):
    """What a `padne-tpu solve` client pays when a resident serve daemon
    (here: the bench process itself, hot) holds the card: load the
    pre-assembled system, ship it over the socket, get the solution.
    Prints one JSON line."""
    from padne_tpu import serve

    t0 = time.time()
    system, _ = _load_system(path)
    t_load = time.time() - t0
    bnorm = float(np.sqrt((system.r_core**2).sum()
                          + (system.border.rhs**2).sum()))
    t0 = time.time()
    res = serve.client_solve(system, target_residual=1e-8 * bnorm,
                             max_refinements=12, socket_path=socket_path)
    t_solve = time.time() - t0
    if res is None:
        print(json.dumps({"warm_serve_error": "no server"}))
        return
    print(json.dumps({
        "warm_serve_load_seconds": round(t_load, 3),
        "warm_serve_seconds": round(t_solve, 3),
        "warm_serve_rel_residual": res.residual_norm / bnorm,
    }))


def _run_probe(mode, args, timeout_s):
    """Run a probe of this script in a CPU-pinned subprocess; returns
    its parsed JSON or None."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    try:
        r = subprocess.run(
            [sys.executable, __file__, mode, *args], env=env,
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        _progress(f"{mode} probe timed out after {timeout_s}s")
        return None
    for line in reversed(r.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    _progress(f"{mode} probe produced no JSON (rc={r.returncode}): "
              f"{r.stderr[-300:]}")
    return None


def _kernel_times(dia_solver) -> dict:
    """Isolated times of the solve's device operators (median of 5
    calls after warm-up), on the CG layout (R = m + 1 columns)."""
    import jax
    import jax.numpy as jnp

    from padne_tpu.ops import comp, dia

    meta = dia_solver._meta0
    np_ = meta[0]
    r = dia_solver.m + 1
    out = {}

    def timed(fn, *args, reps=5):
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    xt = jnp.ones((r, np_), jnp.float32)
    out["cg_operator_ms"] = timed(jax.jit(
        lambda p, x: dia.dia_matvec_t(meta, p, x)),
        dia_solver._op_exact, xt)
    va, vp = dia_solver._vcycle_pair
    out["vcycle_ms"] = timed(jax.jit(va), vp, xt)
    c = dia_solver._comp
    if c is not None:
        cop = c["op"]
        out["comp_residual_ms"] = timed(jax.jit(
            lambda p, x: comp.matvec(cop, p, x)), cop.params, xt[0])
    return out


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--scipy-probe":
        _scipy_probe(sys.argv[2])
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--serve-probe":
        _serve_client_probe(sys.argv[2], sys.argv[3])
        return
    target_dof = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000

    import jax

    from padne_tpu import cli

    cli.configure_jax()
    device = device_record()

    import boardgen
    from padne_tpu import kicad, mesh, serve, solver
    from padne_tpu.ops import schur

    work = tempfile.TemporaryDirectory(prefix="padne_bench_")
    workdir = pathlib.Path(work.name)
    pro = boardgen.gen_bench_4layer(workdir / "board")

    t0 = time.time()
    prob = kicad.load_kicad_project(pro)
    t_load = time.time() - t0
    _progress(f"loaded: {len(prob.layers)} layers, "
              f"{len(prob.networks)} networks in {t_load:.1f}s")

    # Mesh density for the DoF target: vertices ~ area / (0.43 size^2).
    area = sum(layer.shape.area for layer in prob.layers)
    size = max(0.05, (area / (0.43 * target_dof)) ** 0.5)
    cfg = mesh.Mesher.Config(
        maximum_size=size, variable_size_maximum_factor=1.0
    )

    t0 = time.time()
    system, meshes, *_ = solver.build_system(prob, mesher_config=cfg)
    t_mesh = time.time() - t0
    n = system.n
    _progress(f"meshed+assembled n={n} (m={system.border.m}, "
              f"{len(meshes)} meshes) in {t_mesh:.1f}s")

    bnorm = float(np.sqrt((system.r_core**2).sum()
                          + (system.border.rhs**2).sum()))
    target_abs = 1e-8 * bnorm  # BASELINE.md row 1: 1e-8 relative

    t0 = time.time()
    dia_solver = schur.DiaBorderedSolver(system)
    t_setup = time.time() - t0
    _progress(f"AMG setup + upload in {t_setup:.1f}s")

    def run_solve():
        return dia_solver.solve(target_residual=target_abs,
                                max_refinements=12)

    _progress("warmup (compile)...")
    t0 = time.time()
    result = run_solve()
    _progress(f"warmup done in {time.time()-t0:.1f}s "
              f"(rel={result.residual_norm/bnorm:.2e})")

    times = []
    for run in range(3):
        t0 = time.time()
        result = run_solve()
        times.append(time.time() - t0)
        _progress(f"run {run}: {times[-1]:.2f}s "
                  f"iters={result.cg_iterations} "
                  f"passes={result.refinement_steps + 1} "
                  f"rel={result.residual_norm/bnorm:.2e}")
    t_solve = float(np.median(times))

    lv0 = dia_solver.hierarchy.levels[0]
    detail = {
        "amg_levels": [lv.pack.np_ for lv in dia_solver.hierarchy.levels],
        "level0_offsets": list(lv0.pack.offs),
        "level0_remainder": len(lv0.pack.rem_rows),
        "kernels": _kernel_times(dia_solver),
    }
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        detail["peak_device_bytes"] = stats["peak_bytes_in_use"]

    system_npz = str(workdir / "system.npz")
    _save_system(system, np.asarray(result.v), system_npz)
    # The daemon adopts the bench's own solver (preload): the warm path
    # a user hits when the daemon has already served this board.
    _progress("serve probe (CPU client -> this process as daemon)...")
    sock = str(workdir / "serve.sock")
    ready = threading.Event()
    srv = threading.Thread(target=serve.serve, daemon=True, kwargs=dict(
        socket_path=sock, max_requests=4, ready_event=ready,
        preload=[(system, dia_solver)]))
    srv.start()
    ready.wait(30)
    probe = _run_probe("--serve-probe", [system_npz, sock], 1500) or {}
    serve.shutdown(sock)
    srv.join(30)
    _progress("scipy (SuperLU) head-to-head probe...")
    probe.update(_run_probe("--scipy-probe", [system_npz], 900) or {
        "reference_scipy_seconds": None})
    work.cleanup()

    print(json.dumps({
        "metric": "solve_dof_per_sec",
        "value": round(n / t_solve, 1),
        "unit": "DoF/s",
        "detail": {
            "workload": "generated 4-layer PDN board (via grid + MNA "
                        "border)",
            "device": device,
            "dof": n,
            "n_layers": len(prob.layers),
            "n_meshes": len(meshes),
            "border_m": system.border.m,
            "solve_seconds": round(t_solve, 3),
            "load_seconds": round(t_load, 3),
            "mesh_seconds": round(t_mesh, 3),
            "amg_setup_seconds": round(t_setup, 3),
            "end_to_end_seconds": round(
                t_load + t_mesh + t_setup + t_solve, 3),
            "cg_iterations": result.cg_iterations,
            "refinement_passes": result.refinement_steps + 1,
            "refinement_ladder": result.refinement_ladder,
            "final_rel_residual": result.residual_norm / bnorm,
            "rhs_columns": system.border.m + 1,
            **probe,
            **detail,
        },
    }))


if __name__ == "__main__":
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    main()

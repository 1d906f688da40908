#!/usr/bin/env python3
"""GPU smoke check: the KiCad -> mesh -> solve path on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-4 on one card
    python chip_smoke.py --four     # phase 1 + the --tp 4 solve (4 cards)

One process drives the card; it is the only process that opens it.
Phases, in order (any failure exits non-zero, nothing is skipped):

1. device   the default device is a GPU; prints its kind and count, the
            nvidia-smi name and power limit, the compile cache and x64;
            builds the native CDT core.
2. kernels  the generated 4-layer benchmark board meshed uniform at
            ~1.09M DoF; every device operator of the solve against
            scipy CSR in f64 (the V-cycle against the same jitted
            function on the CPU backend), each with its tolerance and
            its median time.
3. main     `padne-tpu solve` in-process (padne_tpu.cli.main), then
            `padne-tpu info`; gates: relative residual <= 1e-8 on the
            full bordered system and max |dV| <= 1e-6 V against
            scipy.sparse.linalg.spsolve; asserts the device refinement
            ladder (ops.comp) ran.
4. served   `padne-tpu serve` on a thread of this process; a client
            `padne-tpu solve` as a subprocess without JAX_PLATFORMS must
            dispatch to it (a client that opened the card would fail for
            want of memory) and match phase 3 to 1e-6 V.
5. four     (--four only) `padne-tpu solve --tp 4` against the one-card
            solve of the same board, with the phase-3 gates.

Measured numbers go to earlier lines; the last line is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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
DOF = 1_000_000          # mesh-size target; gives ~1.09M DoF
RESIDUAL_GATE = 1e-8     # relative, full bordered system
DV_GATE = 1e-6           # volts, against scipy spsolve
TIMED_CALLS = 7          # median of this many calls after warm-up

# (tolerance, reason): relative error in the infinity norm.
TOLERANCES = {
    "l0_slab_xla_main": (1e-5, "f32 sum over ~10 nonzeros per row, "
                               "in another order"),
    "cg_operator": (1e-5, "f32 sum, remainder and slots included"),
    "ell_matvec": (1e-5, "f32 gather sum"),
    "comp_residual_f64": (1e-12, "f32 hi + lo values, f64 products"),
    "vcycle_gpu_vs_cpu": (1e-4, "f32 preconditioner, two backends"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the --tp 4 solve and its one-card "
                         "comparison (needs four GPUs)")
    return ap.parse_args(argv)


def select_phases(args) -> tuple:
    if args.four:
        return ("device", "four")
    return ("device", "kernels", "main", "served")


def say(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    say(f"== phase {name}")
    yield
    say(f"== phase {name} ok ({time.perf_counter() - t0:.3f} s)")


def timed_median(fn, *args) -> float:
    """Median wall time (s) of TIMED_CALLS calls after one warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def rel_inf(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------
def check_device() -> dict:
    import jax

    from padne_tpu import cli

    cli.configure_jax()
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {d0.platform} "
                         f"({d0.device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    say(f"device: {d0.platform} {d0.device_kind} x{len(devs)}")
    # One line per card, exactly as nvidia-smi prints it.
    for line in smi.stdout.strip().splitlines():
        say(line.strip())
    cache = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
             or jax.config.jax_compilation_cache_dir)
    n_cached = (len(list(pathlib.Path(cache).glob("*")))
                if cache and pathlib.Path(cache).is_dir() else 0)
    say(f"compile cache: {cache} ({n_cached} entries at start)")
    say(f"jax_enable_x64: {jax.config.jax_enable_x64}")
    t0 = time.perf_counter()
    import padne_tpu.native  # noqa: F401  (builds the CDT core once)
    say(f"native CDT core ready in {time.perf_counter() - t0:.3f} s")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# Board + system
# ---------------------------------------------------------------------------
def make_board(work: pathlib.Path, dof: int):
    """The benchmark board and the uniform mesh size that gives ~dof
    vertices (vertices ~ area / (0.43 size^2))."""
    from padne_tpu import kicad

    if str(REPO / "tests") not in sys.path:
        sys.path.insert(0, str(REPO / "tests"))
    import boardgen

    pro = boardgen.gen_bench_4layer(work / "board")
    prob = kicad.load_kicad_project(pro)
    area = sum(layer.shape.area for layer in prob.layers)
    size = max(0.05, (area / (0.43 * dof)) ** 0.5)
    return pro, size


def mesher_flags(size: float) -> list:
    return ["--mesh-size", repr(size), "--variable-size-maximum-factor",
            "1.0"]


def csr_padded(system, posmap, np0):
    """The core operator A (n x n, f64) in the solver's padded
    positions (np0 x np0)."""
    import scipy.sparse

    a = system.ell.to_scipy().tocoo()
    return scipy.sparse.csr_matrix(
        (a.data, (posmap[a.row], posmap[a.col])), shape=(np0, np0))


def slab_csr(pack):
    """The slab-resident entries of a level pack as f64 CSR (np_ x np_),
    without the remainder and the diagonal."""
    import scipy.sparse

    b, d = pack.b, len(pack.offs)
    hi = pack.widx_hi.astype(np.int64)
    t = hi // b
    rb, slot = t // d, t % d
    rows = rb * b + pack.widx_lo.astype(np.int64)
    cols = (rb + np.asarray(pack.offs, np.int64)[slot]) * b + hi % b
    return scipy.sparse.csr_matrix(
        (np.asarray(pack.wval, np.float64), (rows, cols)),
        shape=(pack.np_, pack.np_))


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------
def check_operators(dsolver, system, seed: int = 0) -> list:
    """Every device operator of the DIA solve against its f64 host
    reference.  Returns [(name, err, tol, median_ms)]; raises when an
    error exceeds its tolerance."""
    import jax
    import jax.numpy as jnp

    from padne_tpu.ops import comp, dia, spmv

    dsolver._join_comp()
    rng = np.random.default_rng(seed)
    meta0 = dsolver._meta0
    np0, b = meta0[0], meta0[1]
    dmax = dia._dmax(meta0[4])
    r = dsolver.m + 1
    op = dsolver._op_exact
    a_pad = csr_padded(system, dsolver.posmap, np0)
    x = rng.standard_normal((np0, r)).astype(np.float32)
    x64 = x.astype(np.float64)
    xt = jnp.asarray(x.T)
    out = []

    def record(name, err, fn, *args):
        tol = TOLERANCES[name][0]
        ms = timed_median(fn, *args) * 1e3
        out.append((name, err, tol, ms))
        say(f"kernel {name}: err {err:.3e} (tol {tol:.0e}, "
            f"{TOLERANCES[name][1]}); median {ms:.3f} ms over "
            f"{TIMED_CALLS} calls")
        if not err <= tol:
            raise AssertionError(f"{name}: error {err:.3e} > {tol:.0e}")

    # L0 slab contraction alone (no remainder, slots or diagonal).
    pack0 = dsolver.hierarchy.levels[0].pack
    f_slab = jax.jit(lambda w, xt: dia._xla_main(
        meta0, w, jnp.pad(xt, ((0, 0), (dmax * b, dmax * b)))))
    y = f_slab(op["w"], xt)
    record("l0_slab_xla_main", rel_inf(np.asarray(y).T,
                                       slab_csr(pack0) @ x64),
           f_slab, op["w"], xt)

    # The CG operator: slab + slots + remainder + diagonal.
    f_op = jax.jit(lambda prm, xt: dia.dia_matvec_t(meta0, prm, xt))
    y = f_op(op, xt)
    record("cg_operator", rel_inf(np.asarray(y).T, a_pad @ x64),
           f_op, op, xt)

    # The ELL gather matvec of the generic path, on the unpadded system.
    cols, vals, diag = system.ell.to_device(dtype=jnp.float32)
    xe = x[:system.n]
    f_ell = jax.jit(spmv.ell_matvec)
    y = f_ell(cols, vals, diag, jnp.asarray(xe))
    record("ell_matvec",
           rel_inf(y, system.ell.to_scipy() @ xe.astype(np.float64)),
           f_ell, cols, vals, diag, jnp.asarray(xe))
    del cols, vals, diag

    # The f64 refinement residual operator (ops.comp).
    cop = dsolver._comp["op"]
    x1 = jnp.asarray(x[:, 0])
    f_comp = jax.jit(lambda prm, v: comp.matvec(cop, prm, v))
    y = f_comp(cop.params, x1)
    record("comp_residual_f64", rel_inf(y, a_pad @ x64[:, 0]),
           f_comp, cop.params, x1)

    # One V-cycle application, GPU against the CPU backend.
    va, vp = dsolver._vcycle_pair
    f_v = jax.jit(va)
    z = np.asarray(f_v(vp, xt))
    cpu = jax.devices("cpu")[0]
    z_cpu = np.asarray(jax.jit(va)(jax.device_put(vp, cpu),
                                   jax.device_put(xt, cpu)))
    record("vcycle_gpu_vs_cpu", rel_inf(z, z_cpu), f_v, vp, xt)
    return out


def phase_kernels(work: pathlib.Path) -> None:
    from padne_tpu import mesh, solver, kicad
    from padne_tpu.ops import schur

    pro, size = make_board(work, DOF)
    prob = kicad.load_kicad_project(pro)
    cfg = mesh.Mesher.Config(maximum_size=size,
                             variable_size_maximum_factor=1.0)
    t0 = time.perf_counter()
    system, *_ = solver.build_system(prob, mesher_config=cfg)
    say(f"kernels: system n={system.n} m={system.border.m} built in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    dsolver = schur.DiaBorderedSolver(system)
    dsolver._join_comp()     # setup includes the comp operator build
    say(f"kernels: DIA setup {time.perf_counter() - t0:.3f} s, "
        f"np0={dsolver.np0}, L0 offsets "
        f"{dsolver.hierarchy.levels[0].pack.offs}, levels "
        f"{[lv.pack.np_ for lv in dsolver.hierarchy.levels]}")
    check_operators(dsolver, system)
    del dsolver
    gc.collect()


# ---------------------------------------------------------------------------
# Phases 3-5: the CLI path
# ---------------------------------------------------------------------------
class Spy:
    """Wraps the CLI's stage functions for the duration of one
    `padne-tpu solve`: stage wall times, plus the assembled system and
    the bordered solution for the gates."""

    def __init__(self):
        self.stages: dict = {}
        self.system = None
        self.result = None

    @contextlib.contextmanager
    def installed(self):
        from padne_tpu import kicad, solver
        from padne_tpu.ops import schur

        def timed(owner, attr, label, capture=None):
            orig = getattr(owner, attr)

            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                res = orig(*a, **kw)
                self.stages[label] = (self.stages.get(label, 0.0)
                                      + time.perf_counter() - t0)
                if capture is not None:
                    capture(a, res)
                return res

            setattr(owner, attr, wrapper)
            return owner, attr, orig

        def grab(a, res):
            self.system, self.result = a[0], res

        patches = [
            timed(kicad, "load_kicad_project", "load"),
            timed(solver, "build_system", "mesh+assemble"),
            timed(schur.DiaBorderedSolver, "__init__", "setup"),
            timed(schur.DiaBorderedSolver, "solve", "solve"),
            timed(schur, "solve_bordered", "setup+solve", grab),
        ]
        try:
            yield self
        finally:
            for owner, attr, orig in reversed(patches):
                setattr(owner, attr, orig)


def cli_solve(pro, out, size, extra=()) -> Spy:
    from padne_tpu import cli

    spy = Spy()
    with spy.installed():
        cli.main(["solve", str(pro), str(out), *mesher_flags(size),
                  *extra])
    return spy


def gate(spy: Spy, label: str) -> np.ndarray:
    """Relative residual and scipy gates on a captured solve; returns
    the scipy potentials."""
    import scipy.sparse.linalg

    from padne_tpu import solver

    system, res = spy.system, spy.result
    L, r = solver.system_to_scipy(system)
    z = np.concatenate([res.v, res.j])
    rel = float(np.linalg.norm(L @ z - r) / np.linalg.norm(r))
    t0 = time.perf_counter()
    z_ref = scipy.sparse.linalg.spsolve(L.tocsc(), r)
    t_ref = time.perf_counter() - t0
    dv = float(np.abs(z_ref[:system.n] - res.v).max())
    say(f"{label}: n={system.n} m={system.border.m} "
        f"rel_residual={rel:.3e} (gate {RESIDUAL_GATE:.0e}) "
        f"max|dV| vs spsolve={dv:.3e} V (gate {DV_GATE:.0e}; spsolve "
        f"{t_ref:.3f} s)")
    if not rel <= RESIDUAL_GATE:
        raise AssertionError(f"{label}: residual {rel:.3e}")
    if not dv <= DV_GATE:
        raise AssertionError(f"{label}: max|dV| {dv:.3e}")
    return z_ref


def report_solve(spy: Spy, label: str) -> None:
    import jax

    res = spy.result
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in spy.stages.items())
    say(f"{label}: stages: {stages}")
    say(f"{label}: cg_iterations={res.cg_iterations} "
        f"refinement_passes={res.refinement_steps} "
        f"ladder={res.refinement_ladder}")
    for d in jax.local_devices():
        stats = d.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        if peak is not None:
            say(f"{label}: peak device memory {d.id}: "
                f"{peak / 2**30:.3f} GiB")


def potentials(path) -> np.ndarray:
    from padne_tpu.io import solution as solution_io

    sol = solution_io.load_solution(path)
    return np.concatenate([p.values for ls in sol.layer_solutions
                           for p in ls.potentials])


def phase_main(work: pathlib.Path) -> pathlib.Path:
    from padne_tpu import cli

    pro, size = make_board(work, DOF)
    out = work / "out.npz"
    t0 = time.perf_counter()
    spy = cli_solve(pro, out, size)
    say(f"main: padne-tpu solve {time.perf_counter() - t0:.3f} s")
    report_solve(spy, "main")
    gate(spy, "main")
    # The device ladder ran, and no host one.
    if spy.result.refinement_ladder != "comp":
        raise AssertionError(
            f"main: refinement ladder {spy.result.refinement_ladder!r}, "
            f"expected the device ladder 'comp'")
    cli.main(["info", str(out)])
    return out


def socket_path(work: pathlib.Path) -> str:
    path = work / "serve.sock"
    if len(str(path)) > 100:    # AF_UNIX path limit
        path = pathlib.Path(tempfile.mkdtemp(prefix="pdn")) / "s.sock"
    return str(path)


def phase_served(work: pathlib.Path, ref_out: pathlib.Path):
    from padne_tpu import serve

    pro, size = make_board(work, DOF)
    sock = socket_path(work)
    ready = threading.Event()
    th = threading.Thread(target=serve.serve, daemon=True, kwargs=dict(
        socket_path=sock, max_requests=8, ready_event=ready))
    th.start()
    if not ready.wait(120):
        raise AssertionError("served: daemon did not come up")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PADNE_TPU_SOCKET"] = sock
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    out2 = work / "out_served.npz"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "padne_tpu.cli", "solve", str(pro),
             str(out2), *mesher_flags(size)],
            env=env, cwd=str(REPO), capture_output=True, text=True,
            timeout=900)
    finally:
        serve.shutdown(sock)
        th.join(60)
    wall = time.perf_counter() - t0
    log = proc.stderr
    if proc.returncode != 0 or "Resident solve server found" not in log \
            or "solving locally" in log:
        say(log[-4000:])
        raise AssertionError(f"served: client rc={proc.returncode}, "
                             f"did not dispatch to the daemon")
    dv = float(np.abs(potentials(out2) - potentials(ref_out)).max())
    say(f"served: client padne-tpu solve {wall:.3f} s (subprocess, no "
        f"JAX_PLATFORMS); max|dV| vs phase 3 = {dv:.3e} V "
        f"(gate {DV_GATE:.0e})")
    if not dv <= DV_GATE:
        raise AssertionError(f"served: max|dV| {dv:.3e}")


def phase_four(work: pathlib.Path) -> None:
    import jax

    if len(jax.devices()) < 4:
        raise AssertionError(f"four: {len(jax.devices())} device(s)")
    pro, size = make_board(work, DOF)
    out4, out1 = work / "out_tp4.npz", work / "out_tp1.npz"
    t0 = time.perf_counter()
    spy4 = cli_solve(pro, out4, size, extra=("--tp", "4"))
    say(f"four: padne-tpu solve --tp 4 {time.perf_counter() - t0:.3f} s")
    report_solve(spy4, "four tp4")
    # The scipy reference runs on a host thread beside the one-card
    # solve.
    box: dict = {}

    def reference():
        try:
            box["z"] = gate(spy4, "four tp4")
        except BaseException as e:  # noqa: BLE001  re-raised below
            box["err"] = e

    th = threading.Thread(target=reference)
    th.start()
    t0 = time.perf_counter()
    spy1 = cli_solve(pro, out1, size)
    say(f"four: padne-tpu solve (one card) "
        f"{time.perf_counter() - t0:.3f} s")
    report_solve(spy1, "four tp1")
    th.join()
    if "err" in box:
        raise box["err"]
    dv = float(np.abs(spy4.result.v - spy1.result.v).max())
    dvf = float(np.abs(potentials(out4) - potentials(out1)).max())
    say(f"four: max|dV| tp4 vs one card = {dv:.3e} V (saved fields "
        f"{dvf:.3e} V, gate {DV_GATE:.0e})")
    if not max(dv, dvf) <= DV_GATE:
        raise AssertionError(f"four: max|dV| {max(dv, dvf):.3e}")


def main(argv=None) -> int:
    args = parse_args(argv)
    phases = select_phases(args)
    sys.path.insert(0, str(REPO))
    with phase("device"):
        device = check_device()
    with tempfile.TemporaryDirectory(prefix="padne_smoke_") as tmp:
        work = pathlib.Path(tmp)
        ref_out = None
        if "kernels" in phases:
            with phase("kernels"):
                phase_kernels(work)
        if "main" in phases:
            with phase("main"):
                ref_out = phase_main(work)
        if "served" in phases:
            with phase("served"):
                phase_served(work, ref_out)
        if "four" in phases:
            with phase("four"):
                phase_four(work)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

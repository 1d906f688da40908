"""Command-line interface.

Subcommand parity with the reference CLI (cli.py:102-173): gui / solve /
show / paraview with shared mesher flags, plus `html` (self-contained
WebGL viewer export, no display required) and `info` (solution artifact
summary).
"""

from __future__ import annotations

import argparse
import functools
import logging
import sys
import traceback
import unittest.mock
import warnings
from contextlib import contextmanager
from pathlib import Path


def setup_logging(debug_mode: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if debug_mode else logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=[logging.StreamHandler()],
    )


@contextmanager
def collect_warnings():
    """Record warnings while still printing them as they occur."""
    warns = []
    orig = warnings.showwarning

    def wrapper(message, category, filename, lineno, file=None, line=None):
        warns.append(
            warnings.WarningMessage(message, category, filename, lineno, file, line)
        )
        orig(message, category, filename, lineno, file=file, line=line)

    with unittest.mock.patch("warnings.showwarning", new=wrapper):
        yield warns


def add_mesher_args(parser: argparse.ArgumentParser) -> None:
    from . import mesh

    d = mesh.Mesher.Config()
    parser.add_argument("--mesh-angle", type=float, default=d.minimum_angle,
                        help="Minimum angle constraint for mesh triangles (degrees)")
    parser.add_argument("--mesh-size", type=float, default=d.maximum_size,
                        help="Maximum size constraint for mesh triangles")
    parser.add_argument("--variable-density-min-distance", type=float,
                        default=d.variable_density_min_distance,
                        help="Minimum distance for variable density transition")
    parser.add_argument("--variable-density-max-distance", type=float,
                        default=d.variable_density_max_distance,
                        help="Maximum distance for variable density transition")
    parser.add_argument("--variable-size-maximum-factor", type=float,
                        default=d.variable_size_maximum_factor,
                        help="Maximum size scaling factor (1.0 disables variable density)")
    parser.add_argument("--distance-map-quantization", type=float,
                        default=d.distance_map_quantization,
                        help="Quantization step for distance map")
    parser.add_argument("--tp", type=int, default=1, metavar="N",
                        help="Tensor-parallel width: shard the solve over "
                             "the first N accelerator devices (1 = single "
                             "device)")


def device_mesh_from_args(args):
    """Build a (1, tp) device mesh for --tp > 1; None otherwise."""
    if getattr(args, "tp", 1) <= 1:
        return None
    import jax

    from .parallel import sharding

    avail = len(jax.devices())
    if args.tp > avail:
        raise ValueError(
            f"--tp {args.tp} exceeds the {avail} available device(s)"
        )
    return sharding.make_mesh(args.tp)


def serve_daemon_for(args):
    """The live `padne-tpu serve` daemon that should take this command's
    solve, or None.  With one, this process pins itself to the CPU
    before any JAX backend starts, so that only the daemon opens the
    card.  --tp N > 1 always solves in this process.
    PADNE_TPU_SERVER=0 disables the dispatch; PADNE_TPU_SOCKET overrides
    the socket path."""
    if getattr(args, "tp", 1) > 1:
        return None
    from . import runtime, serve

    server = serve.find_server()
    if server is not None:
        runtime.pin_to_cpu()
    return server


def mesher_config_from_args(args):
    from . import mesh

    return mesh.Mesher.Config(
        minimum_angle=args.mesh_angle,
        maximum_size=args.mesh_size,
        variable_density_min_distance=args.variable_density_min_distance,
        variable_density_max_distance=args.variable_density_max_distance,
        variable_size_maximum_factor=args.variable_size_maximum_factor,
        distance_map_quantization=args.distance_map_quantization,
    )


def parse_args(argv=None) -> argparse.Namespace:
    from . import __version__

    parser = argparse.ArgumentParser(
        prog="padne-tpu",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-d", "--debug", action="store_true",
                        help="Enable debug logging output.")
    parser.add_argument("--version", action="version",
                        version=f"padne-tpu {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    p_gui = sub.add_parser("gui", help="Solve and open the interactive viewer",
                           formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p_gui.add_argument("kicad_pro_file", type=Path)
    add_mesher_args(p_gui)

    p_show = sub.add_parser("show", help="Display a pre-computed solution",
                            formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p_show.add_argument("solution_file", type=Path)

    p_solve = sub.add_parser("solve", help="Solve and save the solution",
                             formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p_solve.add_argument("kicad_pro_file", type=Path)
    p_solve.add_argument("output_file", type=Path)
    add_mesher_args(p_solve)

    p_pv = sub.add_parser("paraview", help="Export solution to ParaView VTK",
                          formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p_pv.add_argument("solution_file", type=Path)
    p_pv.add_argument("output_dir", type=Path)

    p_html = sub.add_parser("html",
                            help="Export solution to a self-contained HTML viewer",
                            formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p_html.add_argument("solution_file", type=Path)
    p_html.add_argument("output_file", type=Path)

    p_info = sub.add_parser("info", help="Print solution artifact summary",
                            formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p_info.add_argument("solution_file", type=Path)

    p_val = sub.add_parser(
        "validate",
        help="Compare a solve against bench measurements (JSON measurement set)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p_val.add_argument("measurement_set", type=Path)
    p_val.add_argument("--no-calibrate", action="store_true")
    p_val.add_argument("--fit-overetch", action="store_true")
    p_val.add_argument("--json", action="store_true",
                       help="machine-readable JSON report")

    p_srv = sub.add_parser(
        "serve",
        help="Run a resident solve server (owns the accelerator and "
             "keeps compiled programs hot; later `solve`/`gui` runs "
             "dispatch to it and stay on the CPU)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p_srv.add_argument("--socket", type=Path, default=None,
                       help="unix socket path (default: "
                            "~/.cache/padne_tpu/serve.sock)")
    p_srv.add_argument("--max-requests", type=int, default=None,
                       help="exit after N requests (default: run forever)")

    return parser.parse_args(argv)


def handle_errors(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception as e:
            traceback.print_exc()
            print(f"\033[1;33m{e}\033[0m")
            sys.exit(1)

    return wrapper


@handle_errors
def do_gui(args) -> int:
    from . import kicad, solver, ui

    log = logging.getLogger(__name__)
    server = serve_daemon_for(args)
    log.info("Loading KiCad project for GUI: %s", args.kicad_pro_file)
    prob = kicad.load_kicad_project(args.kicad_pro_file)
    with collect_warnings() as warns:
        solution = solver.solve(
            prob,
            mesher_config=mesher_config_from_args(args),
            device_mesh=device_mesh_from_args(args),
            server=server,
        )
    captured = [w for w in warns if issubclass(w.category, solver.SolverWarning)]
    return ui.main(solution, captured)


@handle_errors
def do_solve(args) -> None:
    from . import kicad, solver
    from .io import solution as solution_io

    log = logging.getLogger(__name__)
    server = serve_daemon_for(args)
    log.info("Loading KiCad project: %s", args.kicad_pro_file)
    prob = kicad.load_kicad_project(args.kicad_pro_file)
    log.info("Solving problem...")
    sol = solver.solve(
        prob,
        mesher_config=mesher_config_from_args(args),
        device_mesh=device_mesh_from_args(args),
        server=server,
    )
    solution_io.save_solution(sol, args.output_file)
    log.info("Solution saved to %s", args.output_file)


@handle_errors
def do_serve(args) -> None:
    from . import serve as serve_mod

    log = logging.getLogger(__name__)
    sock = str(args.socket) if args.socket else None
    log.info("Starting resident solve server (socket: %s)",
             sock or serve_mod.default_socket_path())
    serve_mod.serve(socket_path=sock, max_requests=args.max_requests)


@handle_errors
def do_show(args) -> int:
    from . import ui
    from .io import solution as solution_io

    sol = solution_io.load_solution(args.solution_file)
    return ui.main(sol)


@handle_errors
def do_paraview(args) -> None:
    from .io import paraview, solution as solution_io

    sol = solution_io.load_solution(args.solution_file)
    paraview.export_solution(sol, args.output_dir)
    logging.getLogger(__name__).info(
        "ParaView export completed: %s", args.output_dir
    )


@handle_errors
def do_html(args) -> None:
    from .io import htmlview, solution as solution_io

    sol = solution_io.load_solution(args.solution_file)
    htmlview.export_html(sol, args.output_file)
    logging.getLogger(__name__).info("HTML viewer written to %s", args.output_file)


@handle_errors
def do_validate(args) -> int:
    from . import validate

    argv = [str(args.measurement_set)]
    if args.no_calibrate:
        argv.append("--no-calibrate")
    if args.fit_overetch:
        argv.append("--fit-overetch")
    if args.json:
        argv.append("--json")
    return validate.main(argv)


@handle_errors
def do_info(args) -> None:
    from .io import solution as solution_io

    sol = solution_io.load_solution(args.solution_file)
    si = sol.solver_info
    print(f"project: {sol.problem.project_name}")
    print(f"system size: {si.system_size}, residual: {si.residual_norm:.3e}")
    print(f"ground current: {si.ground_node_current:.3e} A")
    for layer, ls in zip(sol.problem.layers, sol.layer_solutions):
        nv = sum(m.num_vertices for m in ls.meshes)
        nf = sum(m.num_faces for m in ls.meshes)
        vr = [
            (p.values.min(), p.values.max()) for p in ls.potentials
        ]
        vmin = min((v[0] for v in vr), default=0.0)
        vmax = max((v[1] for v in vr), default=0.0)
        print(
            f"  {layer.name}: {len(ls.meshes)} meshes, {nv} verts, {nf} tris, "
            f"V in [{vmin:.6f}, {vmax:.6f}], "
            f"{len(ls.disconnected_meshes)} disconnected"
        )


def configure_jax() -> None:
    """Process-wide JAX settings, applied before any backend starts:
    the persistent compile cache (padne_tpu.runtime) and x64, which the
    solver's f64 refinement residuals need (hot-path arrays stay
    explicit f32).  PADNE_TPU_X64=0 opts out of x64."""
    import os

    import jax

    from . import runtime

    runtime.enable_compile_cache()
    if os.environ.get("PADNE_TPU_X64", "1") != "0":
        jax.config.update("jax_enable_x64", True)


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging(args.debug)
    configure_jax()
    logging.getLogger(__name__).debug("Parsed arguments: %s", args)
    result = {
        "gui": do_gui,
        "solve": do_solve,
        "show": do_show,
        "paraview": do_paraview,
        "html": do_html,
        "info": do_info,
        "validate": do_validate,
        "serve": do_serve,
    }[args.command](args)
    if isinstance(result, int):
        sys.exit(result)


if __name__ == "__main__":
    main()

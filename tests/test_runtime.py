"""Process-level behaviour of the entry points: compile cache, one
process per card, no CPU stand-in for the GPU, and the solve path's
imports."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax

from padne_tpu import runtime, solver

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(code_or_args, env_extra=None, timeout=300):
    env = dict(os.environ)
    env.update(env_extra or {})
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable, *code_or_args])
    return subprocess.run(args, cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=timeout)


class TestCompileCache:
    def test_unset_uses_repo_cache_dir(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        old = jax.config.jax_compilation_cache_dir
        try:
            got = runtime.enable_compile_cache()
            assert got == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        finally:
            jax.config.update("jax_compilation_cache_dir", old)

    def test_set_variable_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        old = jax.config.jax_compilation_cache_dir
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        try:
            assert runtime.enable_compile_cache() == str(tmp_path)
            # JAX's own setting is left alone.
            assert jax.config.jax_compilation_cache_dir == "sentinel"
        finally:
            jax.config.update("jax_compilation_cache_dir", old)

    def test_outside_a_checkout_uses_the_user_cache(self, tmp_path):
        # An installed package or a bundled binary has no pyproject.toml
        # beside it: never cache inside site-packages or a temporary
        # unpacked tree.
        assert runtime.default_cache_dir(tmp_path) == (
            pathlib.Path.home() / ".cache" / "padne_tpu" / "jax_cache")
        assert runtime.default_cache_dir(REPO) == REPO / ".jax_cache"

    def test_cache_dir_is_ignored_by_git(self):
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _tiny_problem():
    from padne_tpu import geom, problem

    layer = problem.Layer(shape=geom.MultiPolygon(
        [geom.box(0, 0, 4, 1)]), name="F.Cu", conductance=1.0)
    a, b = problem.NodeID(), problem.NodeID()
    return problem.Problem(
        project_name="tiny", layers=[layer],
        networks=[problem.Network(
            connections=[
                problem.Connection(layer, geom.Point(0.1, 0.5), a),
                problem.Connection(layer, geom.Point(3.9, 0.5), b)],
            elements=[problem.VoltageSource(p=a, n=b, voltage=1.0)])])


class TestServedClient:
    def test_dispatches_every_size_and_stays_on_cpu(self, monkeypatch,
                                                     tmp_path):
        """`padne-tpu solve` of a small board (well under any size
        gate) still goes to the daemon, and the client pins itself to
        the CPU first."""
        import boardgen

        from padne_tpu import cli, kicad, serve

        calls, order = {}, []

        def fake_client(system, **kw):
            from padne_tpu.ops import schur

            calls["n"] = system.n
            calls["socket"] = kw["socket_path"]
            return schur.solve_bordered(system)

        monkeypatch.setattr(serve, "find_server", lambda: {
            "pid": 1, "backend": "gpu", "socket": "s"})
        monkeypatch.setattr(serve, "client_solve", fake_client)
        monkeypatch.setattr(runtime, "pin_to_cpu",
                            lambda: order.append("pin"))
        real_load = kicad.load_kicad_project

        def load(path):
            order.append("load")
            return real_load(path)

        monkeypatch.setattr(kicad, "load_kicad_project", load)
        boardgen.gen_strip(tmp_path)
        pro = tmp_path / "gen_strip" / "gen_strip.kicad_pro"
        cli.do_solve(cli.parse_args(["solve", str(pro),
                                     str(tmp_path / "o.npz")]))
        assert calls["socket"] == "s" and 0 < calls["n"] < 1000
        assert order == ["pin", "load"]
        assert jax.config.jax_platforms == "cpu"

    def test_library_solve_leaves_the_platform_alone(self, monkeypatch):
        """solver.solve never looks for a daemon or pins the process:
        that is the entry point's decision.  Given a server, it
        dispatches every size."""
        from padne_tpu import serve

        def no_lookup():
            raise AssertionError("solver.solve looked for a daemon")

        def no_pin():
            raise AssertionError("solver.solve pinned the process")

        sent = []

        def fake_client(system, **kw):
            from padne_tpu.ops import schur

            sent.append(kw["socket_path"])
            return schur.solve_bordered(system)

        monkeypatch.setattr(serve, "find_server", no_lookup)
        monkeypatch.setattr(runtime, "pin_to_cpu", no_pin)
        monkeypatch.setattr(serve, "client_solve", fake_client)
        local = solver.solve(_tiny_problem())
        assert sent == []
        served = solver.solve(_tiny_problem(), server={
            "pid": 1, "backend": "gpu", "socket": "s"})
        assert sent == ["s"]
        assert (served.solver_info.system_size
                == local.solver_info.system_size)

    def test_pin_refuses_a_process_on_another_backend(self, monkeypatch):
        """A process that already runs on the GPU cannot become a CPU
        client: pin_to_cpu raises instead of letting it dispatch."""
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        with pytest.raises(RuntimeError, match="already runs on 'gpu'"):
            runtime.pin_to_cpu()

    def test_pin_on_a_fresh_process_selects_the_cpu(self):
        runtime.pin_to_cpu()
        assert jax.config.jax_platforms == "cpu"
        assert jax.default_backend() == "cpu"

    def test_client_pins_before_any_backend(self, tmp_path):
        """In a fresh process, the client's CPU pin lands before any JAX
        backend has started (so it never opens the daemon's card)."""
        code = f"""
import sys, json
sys.path.insert(0, {str(REPO)!r})
import tests.boardgen as bg
from padne_tpu import cli, runtime, serve, solver
from jax._src import xla_bridge
seen = {{}}
real_pin = runtime.pin_to_cpu
def pin():
    seen["backend_up_at_pin"] = xla_bridge.backends_are_initialized()
    return real_pin()
runtime.pin_to_cpu = pin
serve.find_server = lambda: {{"pid": 1, "backend": "gpu", "socket": "s"}}
def client(system, **kw):
    from padne_tpu.ops import schur
    seen["dispatched"] = True
    return schur.solve_bordered(system)
serve.client_solve = client
import pathlib
bg.gen_strip(pathlib.Path({str(tmp_path)!r}))
pro = pathlib.Path({str(tmp_path)!r}) / "gen_strip" / "gen_strip.kicad_pro"
cli.main(["solve", str(pro), {str(tmp_path / "o.npz")!r}])
import jax
seen["platforms"] = jax.config.jax_platforms
print(json.dumps(seen))
"""
        env = {"JAX_PLATFORMS": ""}
        r = _run(code, env_extra=env)
        assert r.returncode == 0, r.stderr[-2000:]
        seen = json.loads(r.stdout.strip().splitlines()[-1])
        assert seen == {"backend_up_at_pin": False, "dispatched": True,
                        "platforms": "cpu"}


class TestNoCpuStandIn:
    @pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
    def test_refuses_a_cpu_device(self, script):
        r = _run([script], env_extra={"JAX_PLATFORMS": "cpu"})
        assert r.returncode != 0
        assert not r.stdout.strip() or '"ok"' not in r.stdout
        assert "metric" not in r.stdout
        assert "GPU" in r.stderr


class TestChipSmokePhases:
    def test_four_selects_only_its_phase(self):
        import chip_smoke

        args = chip_smoke.parse_args(["--four"])
        assert chip_smoke.select_phases(args) == ("device", "four")

    def test_default_runs_the_one_card_phases(self):
        import chip_smoke

        args = chip_smoke.parse_args([])
        assert chip_smoke.select_phases(args) == (
            "device", "kernels", "main", "served")
        # The board size is fixed at full width: no option cuts it.
        assert chip_smoke.DOF == 1_000_000
        with pytest.raises(SystemExit):
            chip_smoke.parse_args(["--dof", "200000"])


def test_solve_imports_only_numpy_scipy_jax(tmp_path):
    """`padne-tpu solve` loads no third-party module beyond what numpy,
    scipy and JAX bring in themselves."""
    code = f"""
import sys, json, pathlib
import numpy, scipy.sparse.linalg, scipy.spatial, scipy.linalg
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
float(jnp.ones(3).sum())
base = {{m.split(".")[0] for m in sys.modules}}
sys.path.insert(0, {str(REPO)!r})
from padne_tpu import cli
boards = pathlib.Path({str(tmp_path)!r})
exec(open({str(REPO / "tests" / "boardgen.py")!r}).read(), g := {{}})
g["gen_strip"](boards)
pro = boards / "gen_strip" / "gen_strip.kicad_pro"
cli.main(["solve", str(pro), str(boards / "o.npz")])
after = {{m.split(".")[0] for m in sys.modules}}
print(json.dumps(sorted(after - base)))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr[-2000:]
    new = set(json.loads(r.stdout.strip().splitlines()[-1]))
    third = {m for m in new
             if m not in sys.stdlib_module_names and not m.startswith("_")}
    assert third == {"padne_tpu"}, sorted(third)


def test_dispatch_cap_default_is_one_dispatch(monkeypatch):
    """By default each CG solve is one dispatch on every platform; the
    chunked (stateful) continuation is used only for an int cap."""
    import padne_tpu.ops.cg as cg_mod
    from padne_tpu.ops import schur
    from test_schur_dia import make_system

    chunks = []
    real = cg_mod.make_pcg

    def spy(*a, **kw):
        solve = real(*a, **kw)

        def wrapped(*a2, **kw2):
            return solve(*a2, **kw2)

        def stateful(*a2, **kw2):
            chunks.append(a2)
            return solve.stateful(*a2, **kw2)

        wrapped.stateful = stateful
        return wrapped

    monkeypatch.setattr(cg_mod, "make_pcg", spy)
    system = make_system(g=12)
    res = schur.solve_bordered(system, operator="ell")
    assert not chunks
    assert res.residual_norm < 1e-9
    capped = schur.solve_bordered(system, operator="ell", dispatch_cap=5)
    assert chunks
    np.testing.assert_allclose(capped.v, res.v, atol=1e-8)

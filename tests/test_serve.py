"""Resident solve server (padne_tpu.serve): protocol + end-to-end.

The server is the one process that owns the accelerator; CLI
invocations ship their assembled system to it and stay on the CPU.
Reference parity: none — the reference is a single-process scipy app
(ref solver.py:767-780).
"""

import os
import pathlib
import tempfile
import threading

import numpy as np
import pytest

from padne_tpu import kicad, mesh, serve, solver


def _system():
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from boardgen import gen_strip

    bdir = pathlib.Path(tempfile.mkdtemp())
    gen_strip(bdir)
    prob = kicad.load_kicad_project(bdir / "gen_strip" / "gen_strip.kicad_pro")
    cfg = mesh.Mesher.Config(maximum_size=0.15)
    system, *_ = solver.build_system(prob, mesher_config=cfg)
    return system


class TestProtocol:
    def test_npz_system_round_trip(self):
        system = _system()
        z = serve._unpack(serve._pack(**serve._system_to_npz(system)))
        back = serve._system_from_npz(z)
        assert back.n == system.n
        np.testing.assert_array_equal(back.ell.cols, system.ell.cols)
        np.testing.assert_array_equal(back.border.rhs, system.border.rhs)
        assert back.num_components == system.num_components

    def test_structural_key_ignores_rhs(self):
        system = _system()
        z1 = serve._system_to_npz(system)
        z2 = dict(z1)
        z2["r_core"] = z1["r_core"] * 2.0
        z2["rhs"] = z1["rhs"] * 2.0
        assert serve._structural_key(z1) == serve._structural_key(z2)
        z3 = dict(z1)
        z3["vals"] = np.asarray(z1["vals"]) * 1.5
        assert serve._structural_key(z1) != serve._structural_key(z3)

    def test_ping_absent_server(self, tmp_path):
        assert serve.ping(str(tmp_path / "nothing.sock")) is None


class TestEndToEnd:
    @pytest.fixture()
    def server(self, tmp_path, monkeypatch):
        # Lower the AMG bottom so the strip board takes the DIA path.
        monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", "200")
        sock = str(tmp_path / "serve.sock")
        ready = threading.Event()
        th = threading.Thread(
            target=serve.serve,
            kwargs=dict(socket_path=sock, max_requests=16,
                        ready_event=ready),
            daemon=True,
        )
        th.start()
        assert ready.wait(30), "server did not come up"
        yield sock
        serve.shutdown(sock)
        th.join(timeout=30)

    def test_ping(self, server):
        info = serve.ping(server)
        assert info is not None
        assert info["pid"] == os.getpid()
        assert info["backend"]

    def test_solve_matches_scipy_and_caches(self, server):
        import scipy.sparse.linalg

        system = _system()
        L, r = solver.system_to_scipy(system)
        z = scipy.sparse.linalg.spsolve(L.tocsc(), r)
        bnorm = float(np.sqrt((system.r_core**2).sum()
                              + (system.border.rhs**2).sum()))
        res = serve.client_solve(system, target_residual=1e-9 * bnorm,
                                 socket_path=server)
        assert res is not None
        assert np.max(np.abs(z[: system.n] - res.v)) < 1e-6

        # Re-solve with a scaled excitation: the cached solver must
        # refresh the RHS (and drop its residual caches) — linearity
        # makes the expected answer exactly 2x.
        system.r_core *= 2.0
        system.border.rhs *= 2.0
        res2 = serve.client_solve(system, target_residual=2e-9 * bnorm,
                                  socket_path=server)
        assert res2 is not None
        assert np.max(np.abs(2.0 * z[: system.n] - res2.v)) < 2e-6

    def test_small_system_declined(self, server, monkeypatch):
        # A tiny system (below the AMG floor) has no DIA hierarchy; the
        # server solves it on the generic path instead of declining, so
        # every size a client dispatches is solved by the daemon.
        import scipy.sparse.linalg

        monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", "3000")
        import sys

        sys.path.insert(0, str(pathlib.Path(__file__).parent))
        from boardgen import gen_strip

        bdir = pathlib.Path(tempfile.mkdtemp())
        gen_strip(bdir)
        prob = kicad.load_kicad_project(
            bdir / "gen_strip" / "gen_strip.kicad_pro")
        small, *_ = solver.build_system(prob)
        res = serve.client_solve(small, target_residual=1e-9,
                                 socket_path=server)
        assert res is not None
        assert res.refinement_ladder in ("ell", "direct")
        L, r = solver.system_to_scipy(small)
        z = scipy.sparse.linalg.spsolve(L.tocsc(), r)
        assert np.max(np.abs(z[: small.n] - res.v)) < 1e-6

"""Tensor-parallel production solve path (ops.schur + ops.cg with mesh).

The standalone sharded kernels live in padne_tpu.parallel (covered by
test_sweep / graft dryrun); these tests exercise the *integrated* path:
solve_bordered / solver.solve with a jax.sharding.Mesh, run on the 8
virtual CPU devices from conftest, and compared bit-for-purpose against
the serial solve.
"""

import warnings

import numpy as np
import pytest

from padne_tpu import kicad, solver
from padne_tpu.parallel import sharding


def assemble(prob):
    from padne_tpu import mesh as mesh_mod

    indices, _, pairs = solver.compute_connectivity(prob)
    meshes, m2l = solver.generate_meshes_for_problem(
        prob, mesh_mod.Mesher(), pairs, indices
    )
    vindex = solver.VertexIndexer.create(meshes)
    filtered = solver.filter_dead_networks(prob, indices, pairs)
    ni = solver.NodeIndexer.create(prob, meshes, m2l, vindex, filtered)
    system, _ = solver.assemble_core_system(
        prob, meshes, m2l, vindex, filtered, ni
    )
    return system


@pytest.fixture(scope="module")
def strip_system(boards_dir):
    prob = kicad.load_kicad_project(
        boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    )
    return assemble(prob)


class TestShardedSolveBordered:
    def test_tp8_jacobi_matches_serial(self, strip_system):
        from padne_tpu.ops import schur

        serial = schur.solve_bordered(strip_system, precond="jacobi")
        mesh = sharding.make_mesh(8)  # (dp=1, tp=8)
        tp = schur.solve_bordered(strip_system, precond="jacobi", mesh=mesh)
        assert tp.residual_norm < 1e-9
        assert np.abs(tp.v - serial.v).max() < 1e-8
        assert np.abs(tp.j - serial.j).max() < 1e-8

    def test_tp8_amg_with_padding(self, strip_system):
        """Forces the AMG preconditioner through the sharded V-cycle;
        the board's vertex count is not a multiple of 8, so the
        row-padding path is exercised on every level."""
        from padne_tpu.ops import schur

        assert strip_system.n % 8 != 0  # padding actually happens
        serial = schur.solve_bordered(strip_system, precond="amg")
        mesh = sharding.make_mesh(8)
        tp = schur.solve_bordered(strip_system, precond="amg", mesh=mesh)
        assert tp.residual_norm < 1e-9
        assert np.abs(tp.v - serial.v).max() < 1e-8

    def test_tp1_mesh_is_serial(self, strip_system):
        """A single-device mesh degrades to the serial path."""
        from padne_tpu.ops import schur

        mesh = sharding.make_mesh(1)
        result = schur.solve_bordered(strip_system, mesh=mesh)
        assert result.residual_norm < 1e-9

    def test_tp4_mixed_precision(self, strip_system):
        """Sharded + mixed precision (f32 inner, f64 refinement), the
        production accelerator configuration."""
        import jax.numpy as jnp

        from padne_tpu.ops import schur

        serial = schur.solve_bordered(strip_system)
        mesh = sharding.make_mesh(4)
        tp = schur.solve_bordered(
            strip_system, device_dtype=jnp.float32, mesh=mesh
        )
        assert tp.residual_norm < 1e-9
        assert np.abs(tp.v - serial.v).max() < 1e-7


class TestDispatchCap:
    """Chunked device dispatches (an int dispatch_cap) must be
    mathematically identical to one long CG run — the Krylov state is
    threaded through the chunks, not restarted."""

    def test_capped_matches_uncapped(self, strip_system):
        from padne_tpu.ops import schur

        full = schur.solve_bordered(strip_system)
        capped = schur.solve_bordered(strip_system, dispatch_cap=25)
        assert capped.residual_norm < 1e-9
        # Same iteration sequence; values agree to rounding (the
        # state-threaded body compiles with different fusion order).
        assert capped.cg_iterations == full.cg_iterations
        assert np.abs(capped.v - full.v).max() < 1e-12

    def test_capped_sharded(self, strip_system):
        """Dispatch cap composes with TP sharding."""
        from padne_tpu.ops import schur

        full = schur.solve_bordered(strip_system)
        mesh = sharding.make_mesh(8)
        capped = schur.solve_bordered(
            strip_system, mesh=mesh, dispatch_cap=25
        )
        assert capped.residual_norm < 1e-9
        assert np.abs(capped.v - full.v).max() < 1e-8

    def test_stateful_cg_continuation(self):
        """solve.stateful chunks reproduce the one-shot solve exactly."""
        import jax.numpy as jnp

        from padne_tpu.ops import assembly, cg

        rng = np.random.default_rng(0)
        n = 500
        edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
        w = rng.uniform(0.5, 2.0, n - 1)
        ell = assembly.build_ell(n, edges.astype(np.int64), w)
        b = rng.standard_normal((n, 3))
        b -= b.mean(axis=0, keepdims=True)
        cid = jnp.zeros(n, dtype=jnp.int32)
        solver_fn = cg.make_pcg(*ell.to_device(), cid, 1)
        one = solver_fn(jnp.asarray(b), 1e-10, 5000)

        state = None
        total = 0
        while True:
            res, state = solver_fn.stateful(jnp.asarray(b), 1e-10, 40, state)
            total += int(res.iterations)
            if int(res.iterations) < 40:
                break
        assert total == int(one.iterations)
        # Rounding-level agreement (1-D chain: condition ~ n^2 amplifies
        # the 1e-10 residual into the solution values).
        assert np.allclose(np.asarray(res.x), np.asarray(one.x),
                           rtol=1e-6, atol=1e-7)


class TestSolveEndToEndWithMesh:
    def test_solver_solve_device_mesh(self, boards_dir):
        prob = kicad.load_kicad_project(
            boards_dir / "gen_two_layer_via" / "gen_two_layer_via.kicad_pro"
        )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            serial = solver.solve(prob)
            tp = solver.solve(prob, device_mesh=sharding.make_mesh(8))
        assert tp.solver_info.residual_norm < 1e-9
        for ls_s, ls_t in zip(serial.layer_solutions, tp.layer_solutions):
            for pot_s, pot_t in zip(ls_s.potentials, ls_t.potentials):
                assert np.abs(pot_s.values - pot_t.values).max() < 1e-8

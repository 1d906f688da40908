"""DIA fast-path bordered solve vs the generic ELL path.

The DIA branch re-engineers the data flow (Hilbert/aligned positions,
device-side border products, host-side refinement residuals); these
tests pin it to the generic solver's results on the same systems.
Reference counterpart: solver.py:767-780 + MNA stamps :469-560.
"""

import numpy as np
import pytest

from padne_tpu.ops import assembly, schur

from test_amg_dia import grid_laplacian


def make_system(g=40, with_regulator=False, seed=0):
    """Grid Laplacian + voltage source + load resistor + ground."""
    ell, coords = grid_laplacian(g, seed=seed)
    n = g * g
    src_p, src_n = 0, n - 1
    m = 2 if not with_regulator else 3
    row = [(0, src_p, 1.0), (0, src_n, -1.0)]
    col = [(0, src_p, 1.0), (0, src_n, -1.0)]
    rhs = [2.5]
    k = 1
    if with_regulator:
        vp, vn, sf, st = 7, n - 8, 3, n - 3
        row += [(k, vp, 1.0), (k, vn, -1.0)]
        col += [(k, vp, 1.0), (k, vn, -1.0), (k, sf, 0.8), (k, st, -0.8)]
        rhs.append(1.2)
        k += 1
    # ground pin
    row.append((k, src_n, 1.0))
    col.append((k, src_n, 1.0))
    rhs.append(0.0)

    border = schur.BorderSpec(
        m=k + 1,
        row_idx=np.array([x[0] for x in row], dtype=np.int64),
        row_node=np.array([x[1] for x in row], dtype=np.int64),
        row_val=np.array([x[2] for x in row]),
        col_idx=np.array([x[0] for x in col], dtype=np.int64),
        col_node=np.array([x[1] for x in col], dtype=np.int64),
        col_val=np.array([x[2] for x in col]),
        rhs=np.array(rhs),
    )
    r_core = np.zeros(n)
    r_core[5] += 0.1
    r_core[n - 6] -= 0.1
    return schur.CoreSystem(
        n=n, ell=ell, comp_id=np.zeros(n, dtype=np.int64),
        num_components=1, border=border, r_core=r_core,
        ground_var=k, coords=coords,
    )


class TestDiaBorderedSolve:
    @pytest.mark.parametrize("with_regulator", [False, True])
    def test_parity_with_generic_path(self, with_regulator):
        system = make_system(with_regulator=with_regulator)
        ref = schur.solve_bordered(system, operator="ell")
        import jax.numpy as jnp

        got = schur.solve_bordered(system, operator="dia",
                                   device_dtype=jnp.float32)
        assert got.residual_norm < 1e-9
        scale = max(np.abs(ref.v).max(), 1e-12)
        assert np.abs(got.v - ref.v).max() < 1e-6 * scale
        assert np.abs(got.j - ref.j).max() < 1e-6 * max(
            np.abs(ref.j).max(), 1e-12)
        assert np.isclose(got.ground_current, ref.ground_current,
                          atol=1e-8)

    def test_auto_threshold_keeps_small_on_ell(self):
        # operator="auto" with a small system must not use DIA
        system = make_system()
        import jax.numpy as jnp

        res = schur.solve_bordered(system, operator="auto",
                                   device_dtype=jnp.float32,
                                   dia_threshold=10**7)
        assert res.residual_norm < 1e-9


class TestDeepOffsetWidening:
    def test_widened_deep_levels_match(self, monkeypatch):
        """PADNE_TPU_DEEP_OFFSETS/_COVERAGE widen levels >= 1 of the DIA
        hierarchy (more slab offsets, less remainder) without changing
        the solution: the V-cycle is preconditioner-only and the CG
        operator sits on level 0, whose budget is untouched."""
        import jax.numpy as jnp

        system = make_system()
        base = schur.solve_bordered(system, operator="dia",
                                    device_dtype=jnp.float32)
        monkeypatch.setenv("PADNE_TPU_DEEP_OFFSETS", "24")
        monkeypatch.setenv("PADNE_TPU_DEEP_COVERAGE", "0.995")
        wide = schur.solve_bordered(system, operator="dia",
                                    device_dtype=jnp.float32)
        assert wide.residual_norm < 1e-9
        scale = max(np.abs(base.v).max(), 1e-12)
        assert np.abs(wide.v - base.v).max() < 1e-6 * scale

    def test_hierarchy_remainder_shrinks(self):
        """Widening must actually absorb deep-level remainder entries
        (guards the per-level budget plumbing in build_hierarchy_dia)."""
        rng = np.random.default_rng(5)
        from padne_tpu.ops import amg, assembly

        g = 72
        n = g * g
        xs, ys = np.meshgrid(np.arange(g, dtype=float),
                             np.arange(g, dtype=float))
        coords = np.stack([xs.ravel(), ys.ravel()], axis=1)
        coords += rng.normal(scale=0.28, size=coords.shape)
        edges, w = [], []
        for i in range(g):
            for j in range(g):
                v = i * g + j
                if j + 1 < g:
                    edges.append((v, v + 1)); w.append(1.0 + rng.random())
                if i + 1 < g:
                    edges.append((v, v + g)); w.append(1.0 + rng.random())
                if i + 1 < g and j + 1 < g and rng.random() < 0.3:
                    edges.append((v, v + g + 1)); w.append(rng.random())
        ell = assembly.build_ell(n, np.array(edges), np.array(w))
        # deep_max_offsets=None inherits level 0's narrow budget; the
        # DEFAULT is the widened one (24/0.995), so the narrow base is
        # requested explicitly.
        base = amg.build_hierarchy_dia(ell, coords, coarse_size=64,
                                       deep_max_offsets=None,
                                       deep_coverage=None)
        wide = amg.build_hierarchy_dia(ell, coords, coarse_size=64,
                                       deep_max_offsets=24,
                                       deep_coverage=0.995)
        assert len(base.levels) == len(wide.levels) >= 2
        for lb, lw in zip(base.levels[1:], wide.levels[1:]):
            assert len(lw.pack.rem_rows) <= len(lb.pack.rem_rows)
        assert (sum(len(lv.pack.rem_rows) for lv in wide.levels[1:])
                < sum(len(lv.pack.rem_rows) for lv in base.levels[1:]))


class TestDeviceResidentRefinement:
    """Passes 2+ run on device with a double-f32 incremental residual;
    the host-anchored loop is the PADNE_TPU_HOST_REFINE=1 fallback."""

    def test_matches_host_anchored_loop(self, monkeypatch):
        system = make_system(g=64, with_regulator=True, seed=3)
        dev = schur.DiaBorderedSolver(system)
        sol_dev = dev.solve(target_residual=1e-10)
        monkeypatch.setenv("PADNE_TPU_HOST_REFINE", "1")
        host = schur.DiaBorderedSolver(system)
        sol_host = host.solve(target_residual=1e-10)
        # Both converge; the device loop must have actually refined.
        assert sol_dev.residual_norm < 1e-10
        assert sol_host.residual_norm < 1e-10
        assert sol_dev.refinement_steps >= 1
        scale = max(np.abs(sol_host.v).max(), 1e-12)
        assert np.abs(sol_dev.v - sol_host.v).max() < 1e-8 * scale
        assert np.abs(sol_dev.j - sol_host.j).max() < 1e-8

    def test_true_residual_matches_reported(self):
        """The reported norm is the exact host f64 residual of the
        returned (v, j) — the device-incremental bookkeeping cannot
        drift the report."""
        import scipy.sparse

        system = make_system(g=64, seed=7)
        sol = schur.DiaBorderedSolver(system).solve(target_residual=1e-10)
        b = system.border
        A = system.ell.to_scipy()
        C = scipy.sparse.coo_matrix(
            (b.col_val, (b.col_node, b.col_idx)),
            shape=(system.n, b.m)).tocsr()
        B = scipy.sparse.coo_matrix(
            (b.row_val, (b.row_idx, b.row_node)),
            shape=(b.m, system.n)).tocsr()
        rc = system.r_core + A @ sol.v - C @ sol.j
        rb = b.rhs - B @ sol.v
        true_norm = float(np.sqrt((rc**2).sum() + (rb**2).sum()))
        assert np.isclose(true_norm, sol.residual_norm,
                          rtol=1e-6, atol=1e-13)


class TestF64DeviceAnchor:
    """Pass 1's residual is computed on device in f64 (the anchor).
    The anchor is opt-in (PADNE_TPU_DEVICE_ANCHOR=1 — it only pays on
    severely bandwidth-limited host links); these tests force it on.
    PADNE_TPU_HOST_ANCHOR=1 restores the host anchor."""

    @pytest.fixture(autouse=True)
    def _enable_anchor(self, monkeypatch):
        monkeypatch.setenv("PADNE_TPU_DEVICE_ANCHOR", "1")

    def test_anchor_is_exact(self):
        import jax
        import jax.numpy as jnp
        import scipy.sparse

        system = make_system(g=64, with_regulator=True, seed=5)
        s = schur.DiaBorderedSolver(system)
        if s._anchor is None:
            pytest.skip("anchor unavailable (x64 off?)")
        b = system.border
        n, m = system.n, b.m
        A = system.ell.to_scipy()
        C = scipy.sparse.coo_matrix(
            (b.col_val, (b.col_node, b.col_idx)), shape=(n, m))
        rng = np.random.default_rng(0)
        v = rng.normal(size=s.np0).astype(np.float32)
        jv = rng.normal(size=m)
        hi, lo, bv, n2 = s._anchor(jnp.asarray(v), jnp.asarray(jv))
        rc_dev = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        v_real = v.astype(np.float64)[s.posmap]
        rc_ref = system.r_core + A @ v_real - C @ jv
        # The int16 ratio residue quantizes each operator/rhs value to
        # ~2^-40 relative (half of RATIO16_SCALE); the row-wise error
        # bound is that step against the NON-cancelling magnitude sums.
        mag = (np.abs(A) @ np.abs(v_real) + np.abs(system.r_core)
               + np.abs(C) @ np.abs(jv))
        bound = 4e-12 * mag + 1e-300
        assert (np.abs(rc_dev[s.posmap] - rc_ref) < bound).all()
        B = scipy.sparse.coo_matrix(
            (b.row_val, (b.row_idx, b.row_node)), shape=(m, n))
        assert np.abs(np.asarray(bv) - B @ v_real).max() < 1e-10
        # Padding rows carry no residual.
        mask = np.ones(s.np0, bool)
        mask[s.posmap] = False
        assert np.abs(rc_dev[mask]).max() == 0.0

    def test_anchor_solve_matches_host_anchor(self, monkeypatch):
        system = make_system(g=64, seed=9)
        a = schur.DiaBorderedSolver(system)
        if a._anchor is None:
            pytest.skip("anchor unavailable (x64 off?)")
        sol_a = a.solve(target_residual=1e-10)
        monkeypatch.setenv("PADNE_TPU_HOST_ANCHOR", "1")
        h = schur.DiaBorderedSolver(system)
        assert h._anchor is None
        sol_h = h.solve(target_residual=1e-10)
        assert sol_a.residual_norm < 1e-10
        assert sol_h.residual_norm < 1e-10
        scale = max(np.abs(sol_h.v).max(), 1e-12)
        assert np.abs(sol_a.v - sol_h.v).max() < 1e-8 * scale

    def test_second_solve_reuses_anchor(self):
        system = make_system(g=64, seed=4)
        s = schur.DiaBorderedSolver(system)
        if s._anchor is None:
            pytest.skip("anchor unavailable (x64 off?)")
        s1 = s.solve(target_residual=1e-10)
        s2 = s.solve(target_residual=1e-10)
        assert s2.residual_norm < 1e-10
        assert np.abs(s1.v - s2.v).max() < 1e-9


class TestCycleLumpedKnob:
    def test_lumped_cycle_converges_and_matches(self, monkeypatch):
        """PADNE_TPU_CYCLE_LUMPED=1 (V-cycle built entirely on the
        strength-lumped operator) must stay a valid SPD preconditioner:
        same solution, target residual reached."""
        system = make_system(g=64, with_regulator=True, seed=11)
        ref = schur.DiaBorderedSolver(system).solve(target_residual=1e-10)
        monkeypatch.setenv("PADNE_TPU_CYCLE_LUMPED", "1")
        lum = schur.DiaBorderedSolver(system).solve(target_residual=1e-10)
        assert lum.residual_norm < 1e-10
        scale = max(np.abs(ref.v).max(), 1e-12)
        assert np.abs(lum.v - ref.v).max() < 1e-8 * scale


class TestDirectWideBorderRoute:
    """Small core + wide MNA border routes to the host direct solve
    (ops.schur._solve_bordered_direct) — the case the reference
    excludes outright (ref test_solver.py:1117-1121) used to pay
    minutes of multi-RHS Schur CG for a system SuperLU factors in
    milliseconds."""

    def _wide_system(self, n=600, m=24):
        rng = np.random.default_rng(3)
        # 1-D chain Laplacian core.
        edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
        ell = assembly.build_ell(n, edges.astype(np.int64),
                                 np.ones(n - 1))
        # m voltage-source-like border pairs at random nodes.
        nodes = rng.choice(n, size=2 * m, replace=False)
        row_idx = np.repeat(np.arange(m), 2)
        row_val = np.tile([1.0, -1.0], m)
        border = schur.BorderSpec(
            m=m, row_idx=row_idx, row_node=nodes, row_val=row_val,
            col_idx=row_idx.copy(), col_node=nodes.copy(),
            col_val=row_val.copy(),
            rhs=rng.standard_normal(m) * 0.1,
        )
        return schur.CoreSystem(
            n=n, ell=ell, comp_id=np.zeros(n, dtype=np.int32),
            num_components=1, border=border, r_core=np.zeros(n),
            ground_var=0,
        )

    def test_route_taken_and_correct(self):
        import scipy.sparse.linalg

        system = self._wide_system()
        res = schur.solve_bordered(system)
        # The direct route reports zero CG iterations — proof it was
        # taken (the iterative path would report hundreds here).
        assert res.cg_iterations == 0
        assert res.residual_norm < 1e-9
        from padne_tpu import solver as solver_mod

        L, r = solver_mod.system_to_scipy(system)
        z = scipy.sparse.linalg.spsolve(L.tocsc(), r)
        np.testing.assert_allclose(res.v, z[: system.n], atol=1e-9)
        np.testing.assert_allclose(res.j, z[system.n:], atol=1e-9)

    def test_route_skipped_for_narrow_border(self, monkeypatch):
        """A narrow border keeps the iterative path (the direct route
        is scoped to the wide-border tax)."""
        system = self._wide_system(m=2)
        res = schur.solve_bordered(system)
        assert res.cg_iterations > 0
        assert res.residual_norm < 1e-8

    def test_env_disable(self, monkeypatch):
        monkeypatch.setenv("PADNE_TPU_DIRECT_SMALL", "0")
        system = self._wide_system()
        res = schur.solve_bordered(system)
        assert res.cg_iterations > 0
        assert res.residual_norm < 1e-8


class TestNoSilentHostFallback:
    """A failing device refinement path raises; it no longer hands the
    solve to the host ladder behind the caller's back."""

    def test_default_ladder_is_the_device_comp_ladder(self):
        sol = schur.DiaBorderedSolver(make_system(g=64)).solve(
            target_residual=1e-9)
        assert sol.refinement_ladder.startswith("comp")
        assert sol.residual_norm < 1e-9

    @pytest.mark.parametrize("where", ["comp_setup", "comp_refine",
                                       "anchor_setup"])
    def test_failure_raises(self, monkeypatch, where):
        def boom(*a, **kw):
            raise ValueError("injected device failure")

        system = make_system(g=64)
        if where == "anchor_setup":
            monkeypatch.setenv("PADNE_TPU_DEVICE_ANCHOR", "1")
            monkeypatch.setattr(schur.DiaBorderedSolver, "_setup_anchor",
                                boom)
            with pytest.raises(ValueError, match="injected"):
                schur.DiaBorderedSolver(system)
            return
        attr = "_setup_comp" if where == "comp_setup" else "_comp_refine"
        monkeypatch.setattr(schur.DiaBorderedSolver, attr, boom)
        s = schur.DiaBorderedSolver(system)
        with pytest.raises((RuntimeError, ValueError)) as info:
            s.solve(target_residual=1e-9)
        chain = [info.value, info.value.__cause__]
        assert any("injected" in str(e) for e in chain if e)

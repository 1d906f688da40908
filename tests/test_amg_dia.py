"""Aligned (reshape-transfer) DIA AMG hierarchy: build invariants and
end-to-end PCG convergence on the XLA backend.

Reference counterpart: the direct SuperLU solve (reference
solver.py:767-780) — here replaced by deflated PCG preconditioned with
the gather-free V-cycle.
"""

import numpy as np
import pytest
import scipy.sparse

import jax.numpy as jnp

from padne_tpu.ops import amg, assembly, cg, dia


def grid_laplacian(g=48, seed=0):
    """Triangulated g x g grid graph Laplacian (singular, Neumann) with
    vertex coordinates."""
    idx = np.arange(g * g).reshape(g, g)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    e.append(np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1))
    e = np.concatenate(e, 0)
    rng = np.random.default_rng(seed)
    w = 0.5 + rng.random(len(e))
    ell = assembly.build_ell(g * g, e.astype(np.int64), w)
    xs, ys = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel()], 1).astype(float)
    return ell, coords


class TestBuildHierarchyDia:
    def test_invariants(self):
        ell, coords = grid_laplacian()
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=100)
        n = len(ell.diag)
        assert len(h.levels) >= 1
        # posmap0 is injective into [0, np0)
        assert len(np.unique(h.posmap0)) == n
        assert h.posmap0.min() >= 0 and h.posmap0.max() < h.np0
        # level invariants: cap-divisible padding, valid child mapping
        for lv in h.levels:
            assert lv.pack.np_ % lv.cap == 0
            assert np.all(lv.dinv[lv.pack.diag == 0] == 0)
            assert len(np.unique(lv.child_perm)) == len(lv.child_perm)
            assert lv.child_perm.max(initial=0) < lv.child_len
            # padding bounded: no 8^level pyramid
            assert lv.pack.np_ <= 4 * max(np.count_nonzero(lv.dinv), 256)
        # coarse_inv padded square
        assert h.coarse_inv.shape[0] == h.coarse_inv.shape[1]

    def test_tiny_system_no_levels(self):
        ell, coords = grid_laplacian(g=8)
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=100)
        assert len(h.levels) == 0
        assert h.np0 == h.coarse_inv.shape[0]


class TestVcycleDiaPCG:
    def solve(self, g=48, tol=3e-6):
        ell, coords = grid_laplacian(g)
        n = g * g
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=100)
        apply_v, vparams = amg.make_vcycle_dia(h)

        rng = np.random.default_rng(3)
        b = rng.standard_normal((n, 2))
        b -= b.mean(axis=0, keepdims=True)   # range of the Neumann operator

        # scatter RHS into level-0 positions
        b_pad = np.zeros((h.np0, 2))
        b_pad[h.posmap0] = b
        comp_pad = np.ones(h.np0, dtype=np.int32)
        comp_pad[h.posmap0] = 0

        meta0 = h.levels[0].pack.meta
        params0 = amg.make_dia_cg_operator(h, vparams)

        def a_apply(p, x):
            return dia.dia_matvec(meta0, p, x)

        solver = cg.make_pcg(
            None, None, jnp.asarray(h.levels[0].pack.diag),
            jnp.asarray(comp_pad), 2,
            precond=(apply_v, vparams),
            operator=(a_apply, params0),
        )
        res = solver(jnp.asarray(b_pad.astype(np.float32)), tol, 200)
        x = np.asarray(res.x, dtype=np.float64)[h.posmap0]
        return ell, b, x, int(res.iterations)

    def test_converges_and_matches_scipy(self):
        ell, b, x, iters = self.solve()
        A = ell.to_scipy()
        # residual gate
        r = b - A @ x
        assert np.linalg.norm(r) / np.linalg.norm(b) < 5e-5  # f32 CG floor
        # parity with scipy pseudo-solve (up to constant shift)
        x_ref = scipy.sparse.linalg.lsqr(A, b[:, 0], atol=1e-12,
                                         btol=1e-12, iter_lim=20000)[0]
        d = x[:, 0] - x_ref
        d -= d.mean()
        assert np.abs(d).max() < 1e-3 * max(np.abs(x_ref).max(), 1.0)

    def test_mesh_independent_iterations(self):
        # 3e-6: comfortably above the f32 CG residual floor (~1e-7)
        _, _, _, it_small = self.solve(g=32, tol=3e-6)
        _, _, _, it_large = self.solve(g=64, tol=3e-6)
        # AMG: iteration count roughly flat with mesh size
        assert it_large <= it_small * 2
        assert it_large < 80


class TestTransposedPath:
    def test_pcg_t_matches_normal(self):
        """Transposed-layout CG + V-cycle == normal layout on the same
        hierarchy (same preconditioner math, different data layout)."""
        import jax

        ell, coords = grid_laplacian(48)
        n = 48 * 48
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=100)
        meta0 = h.levels[0].pack.meta

        va, vp = amg.make_vcycle_dia(h)
        op = amg.make_dia_cg_operator(h, vp)
        va_t, vp_t = amg.make_vcycle_dia_t(h,
                                           lump_smoothing=False)

        rng = np.random.default_rng(3)
        b = rng.standard_normal((n, 2))
        b -= b.mean(axis=0, keepdims=True)
        b_pad = np.zeros((h.np0, 2), np.float32)
        b_pad[h.posmap0] = b
        comp = np.ones(h.np0, np.int32)
        comp[h.posmap0] = 0

        s_n = cg.make_pcg(
            None, None, None, jnp.asarray(comp), 2,
            precond=(va, vp),
            operator=(lambda p, x: dia.dia_matvec(
                meta0, p, x), op),
        )
        s_t = cg.make_pcg_t(
            operator=(lambda p, xt: dia.dia_matvec_t(
                meta0, p, xt), op),
            precond=(va_t, vp_t),
            comp_id=jnp.asarray(comp), num_components=2,
        )
        rn = s_n(jnp.asarray(b_pad), 3e-6, 60)
        rt = s_t(jnp.asarray(b_pad), 3e-6, 60)
        xn = np.asarray(rn.x, np.float64)[h.posmap0]
        xt = np.asarray(rt.x, np.float64)[h.posmap0]
        # same math modulo f32 rounding: solutions agree closely
        scale = max(np.abs(xn).max(), 1e-12)
        assert np.abs(xn - xt).max() < 5e-4 * scale
        A = ell.to_scipy()
        rel = np.linalg.norm(b - A @ xt) / np.linalg.norm(b)
        assert rel < 5e-5

    def test_lumped_smoothing_still_converges(self):
        import jax

        ell, coords = grid_laplacian(64)
        n = 64 * 64
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=100)
        meta0 = h.levels[0].pack.meta
        va_t, vp_t = amg.make_vcycle_dia_t(h,
                                           lump_smoothing=True)
        op = amg.make_dia_cg_operator(h, vp_t)
        rng = np.random.default_rng(5)
        b = rng.standard_normal((n, 2))
        b -= b.mean(axis=0, keepdims=True)
        b_pad = np.zeros((h.np0, 2), np.float32)
        b_pad[h.posmap0] = b
        comp = np.ones(h.np0, np.int32)
        comp[h.posmap0] = 0
        s_t = cg.make_pcg_t(
            operator=(lambda p, xt: dia.dia_matvec_t(
                meta0, p, xt), op),
            precond=(va_t, vp_t),
            comp_id=jnp.asarray(comp), num_components=2,
        )
        rt = s_t(jnp.asarray(b_pad), 3e-6, 120)
        xt = np.asarray(rt.x, np.float64)[h.posmap0]
        A = ell.to_scipy()
        rel = np.linalg.norm(b - A @ xt) / np.linalg.norm(b)
        assert rel < 5e-5
        assert int(rt.iterations) < 120


class TestCoarseInvDense:
    """The Cholesky fast path must act like the syevd pseudo-inverse on
    deflated vectors, and must DETECT non-structural near-null junk and
    fall back (amg._coarse_inv_dense)."""

    @staticmethod
    def _path_laplacian(n, w=1.0):
        import scipy.sparse

        i = np.arange(n - 1)
        rows = np.concatenate([i, i + 1, np.arange(n)])
        cols = np.concatenate([i + 1, i, np.arange(n)])
        deg = np.zeros(n)
        np.add.at(deg, i, w)
        np.add.at(deg, i + 1, w)
        vals = np.concatenate([-w * np.ones(n - 1),
                               -w * np.ones(n - 1), deg])
        return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))

    def test_clean_matches_pinv_on_deflated_vectors(self):
        from padne_tpu.ops import amg

        A = self._path_laplacian(180)
        Ad = np.asarray(A.todense())
        ci = amg._coarse_inv_dense(A, Ad)
        pi = amg._eigh_pinv(Ad)
        rng = np.random.default_rng(0)
        r = rng.normal(size=180)
        r -= r.mean()                      # deflated: perpendicular to 1
        a, b = ci @ r, pi @ r
        assert np.abs(a - b).max() < 1e-3 * np.abs(b).max()

    def test_two_components_structural_nullspace(self):
        import scipy.sparse

        from padne_tpu.ops import amg

        A = scipy.sparse.block_diag(
            [self._path_laplacian(90), self._path_laplacian(70, w=2.0)]
        ).tocsr()
        Ad = np.asarray(A.todense())
        ci = amg._coarse_inv_dense(A, Ad)
        pi = amg._eigh_pinv(Ad)
        rng = np.random.default_rng(1)
        r = rng.normal(size=160)
        r[:90] -= r[:90].mean()
        r[90:] -= r[90:].mean()            # deflated per component
        a, b = ci @ r, pi @ r
        assert np.abs(a - b).max() < 1e-3 * np.abs(b).max()

    def test_values_level_junk_falls_back(self, caplog):
        """A 1e-9 bridge keeps the graph connected (one structural
        component) but leaves a near-null junk mode: the guard must
        fall back to the syevd pseudo-inverse, which zeroes it."""
        import logging

        import scipy.sparse

        from padne_tpu.ops import amg

        A = scipy.sparse.block_diag(
            [self._path_laplacian(80), self._path_laplacian(80)]).tolil()
        A[79, 80] = A[80, 79] = -1e-9
        A[79, 79] += 1e-9
        A[80, 80] += 1e-9
        A = A.tocsr()
        Ad = np.asarray(A.todense())
        with caplog.at_level(logging.INFO, logger="padne_tpu.ops.amg"):
            ci = amg._coarse_inv_dense(A, Ad)
        assert any("falling back" in m for m in caplog.messages)
        pi = amg._eigh_pinv(Ad)
        assert np.allclose(ci, pi, atol=0)   # identical code path


class TestDeviceCoarseInv:
    """On-device coarse inverse (f32 Newton-Schulz + structural shift)
    must act like the host dense inverse; PADNE_TPU_DEVICE_COARSE=1
    opts into the device path."""

    def test_matches_host_inverse(self, monkeypatch):
        import jax.numpy as jnp

        ell, coords = grid_laplacian(g=40, seed=3)
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=120)
        assert h.coarse_sp is not None and h.coarse_nL > 0
        inv_dev = amg._device_coarse_inv(h)
        assert inv_dev is not None
        host = h.coarse_inv  # (npL, npL) f32 pseudo-inverse
        nL = h.coarse_nL
        # Compare as operators on deflated residuals (the only inputs
        # the V-cycle feeds the bottom): r with zero component means.
        rng = np.random.default_rng(0)
        r = np.zeros(h.coarse_npL, np.float32)
        r[:nL] = rng.normal(size=nL).astype(np.float32)
        import scipy.sparse.csgraph as csgraph

        ncomp, labels = csgraph.connected_components(h.coarse_sp,
                                                     directed=False)
        for c in range(ncomp):
            m = labels == c
            r[:nL][m] -= r[:nL][m].mean()
        y_dev = np.asarray(inv_dev @ jnp.asarray(r))
        y_host = host @ r
        scale = max(np.abs(y_host).max(), 1e-30)
        assert np.abs(y_dev - y_host).max() < 5e-3 * scale
        # Padding rows stay exactly inert.
        assert np.abs(y_dev[nL:]).max() == 0.0

    def test_upload_prefers_device_path(self, monkeypatch):
        import jax.numpy as jnp

        monkeypatch.setenv("PADNE_TPU_DEVICE_COARSE", "1")
        ell, coords = grid_laplacian(g=32, seed=1)
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=80)
        ci = amg._upload_coarse_inv(h, None)
        assert ci.dtype == jnp.float32
        # The deferred host compute must NOT have been joined.
        assert callable(h._coarse)

    @pytest.mark.parametrize("prebuilt", [False, True])
    def test_device_failure_raises(self, monkeypatch, prebuilt):
        """A failing device build raises instead of handing over to
        the host inverse (sync call and async worker alike)."""
        def boom(h):
            raise ValueError("injected device failure")

        monkeypatch.setenv("PADNE_TPU_DEVICE_COARSE", "1")
        monkeypatch.setattr(amg, "_device_coarse_inv", boom)
        ell, coords = grid_laplacian(g=32, seed=1)
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=80)
        box = amg._start_coarse_inv_async(h, None) if prebuilt else None
        with pytest.raises((RuntimeError, ValueError)) as info:
            amg._upload_coarse_inv(h, None, prebuilt=box)
        chain = [info.value, info.value.__cause__]
        assert any("injected" in str(e) for e in chain if e)


class TestSlotsLevelPolicy:
    def test_slots_level0_only(self, monkeypatch):
        """Slot packing (PADNE_TPU_SLOTS) must apply to level 0 only:
        make_vcycle_dia never requests slot tables below level 0."""
        monkeypatch.setenv("PADNE_TPU_SLOTS", "4")
        ell, coords = grid_laplacian(64)
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=100)
        assert len(h.levels) >= 2
        _, params = amg.make_vcycle_dia(h)
        lv0 = params[0]
        deep = params[1:-1]   # last entry is the coarse inverse
        if len(h.levels[0].pack.rem_rows):
            assert "xs_tgt" in lv0
        for e in deep:
            assert "xs_tgt" not in e


class TestTransposedDeepCycle:
    """PADNE_TPU_DEEP_T: the deep levels of the transposed V-cycle run
    in the packed (R, n) layout (amg._finish_vcycle_dia.cycle_t); the
    normal-layout tail is the reference."""

    def test_matches_normal_layout_tail(self, monkeypatch):
        ell, coords = grid_laplacian(g=100, seed=1)
        h = amg.build_hierarchy_dia(ell, coords, coarse_size=100)
        assert len(h.levels) >= 2   # a real deep stack
        rng = np.random.default_rng(0)
        bt = jnp.asarray(rng.standard_normal(
            (4, h.levels[0].pack.np_)).astype(np.float32))
        monkeypatch.setenv("PADNE_TPU_DEEP_T", "0")
        a0, p0 = amg.make_vcycle_dia_t(h)
        z0 = np.asarray(a0(p0, bt))
        monkeypatch.setenv("PADNE_TPU_DEEP_T", "1")
        a1, p1 = amg.make_vcycle_dia_t(h)
        z1 = np.asarray(a1(p1, bt))
        assert np.abs(z0 - z1).max() / np.abs(z0).max() < 1e-5

"""Compensated exact operator (ops.comp): f64-accurate matvec from
resident f32 device data.  Validates both modes against a scipy f64
reference, including that the compensation actually beats plain f32
(i.e. the Dekker arithmetic is not optimized away by XLA)."""

import numpy as np
import pytest

import jax.numpy as jnp

from padne_tpu.ops import comp, dia

from tests.test_dia import random_system


def _build(seed=0, **kw):
    rows, cols, vals, diag, a = random_system(seed=seed, **kw)
    n = a.shape[0]
    pk = dia.pack_dia(n, rows, cols, vals, diag=diag,
                      coverage=0.9, max_offsets=4)
    params = pk.to_device(keep_widx=True)
    return pk, params, a


class TestCompMatvec:
    @pytest.mark.parametrize("mode", ["dekker", "f64"])
    def test_matches_f64_reference(self, mode):
        pk, params, a = _build()
        n = a.shape[0]
        op = comp.build(pk.meta, params, pk, mode=mode)
        rng = np.random.default_rng(1)
        x32 = rng.standard_normal(n).astype(np.float32)
        x_pad = np.zeros(pk.np_, np.float32)
        x_pad[:n] = x32
        y = np.asarray(comp.matvec(op, op.params, jnp.asarray(x_pad)))
        ref = a @ x32.astype(np.float64)
        rel = np.abs(y[:n] - ref).max() / np.abs(ref).max()
        assert rel < 1e-10, rel

    def test_beats_plain_f32(self):
        # The point of the module: the compensated result must be
        # orders of magnitude closer to f64 than a plain f32 matvec of
        # the same (f32-rounded) operator.
        pk, params, a = _build(seed=3)
        n = a.shape[0]
        op = comp.build(pk.meta, params, pk, mode="dekker")
        rng = np.random.default_rng(2)
        x32 = rng.standard_normal(n).astype(np.float32)
        x_pad = np.zeros(pk.np_, np.float32)
        x_pad[:n] = x32
        y = np.asarray(comp.matvec(op, op.params, jnp.asarray(x_pad)))
        ref = a @ x32.astype(np.float64)
        a32 = a.copy()
        a32.data = a32.data.astype(np.float32).astype(np.float64)
        y32 = (a32.astype(np.float32) @ x32).astype(np.float64)
        err_comp = np.abs(y[:n] - ref).max()
        err_f32 = np.abs(y32 - ref).max()
        assert err_comp < err_f32 / 100.0, (err_comp, err_f32)

    def test_tail_rows_covered(self):
        # Force small k so high-degree rows spill to the f64 tail.
        pk, params, a = _build(seed=5)
        n = a.shape[0]
        op = comp.build(pk.meta, params, pk, mode="dekker", k_cap=4)
        if op.tail_n == 0:
            pytest.skip("no spill at this density")
        rng = np.random.default_rng(4)
        x32 = rng.standard_normal(n).astype(np.float32)
        x_pad = np.zeros(pk.np_, np.float32)
        x_pad[:n] = x32
        y = np.asarray(comp.matvec(op, op.params, jnp.asarray(x_pad)))
        ref = a @ x32.astype(np.float64)
        rel = np.abs(y[:n] - ref).max() / np.abs(ref).max()
        assert rel < 1e-10, rel

    def test_cancellation_floor_below_refinement_target(self):
        """Laplacian-scale operator (|a| ~ 2e3 S, the production
        conductance scale) applied to a smooth volt-scale field: the
        row sums cancel, so the result is dominated by the OPERATOR
        representation error.  The f32 lo-half residue must hold the
        error near 2^-48 relative to the row magnitude — the int16
        ratio residue (2^-39) fails this gate by ~2 orders, which is
        exactly how it floored the 1M-DoF residual at 1.2e-7 relative
        (above the 1e-8 refinement target)."""
        from tests.test_dia_sharded import grid_system

        ell, coords = grid_system(64, 64)
        a = ell.to_scipy() * (2081.0 * np.pi / 3.0)
        pk = dia.pack_csr_as_dia(a)
        params = pk.to_device(keep_widx=True)
        op = comp.build(pk.meta, params, pk, mode="dekker")
        n = a.shape[0]
        x32 = np.linspace(0.0, 3.3, n).astype(np.float32)
        x_pad = np.zeros(pk.np_, np.float32)
        x_pad[:n] = x32
        y = np.asarray(comp.matvec(op, op.params, jnp.asarray(x_pad)))
        ref = a @ x32.astype(np.float64)
        scale = (abs(a) @ np.abs(x32.astype(np.float64))).max()
        assert np.abs(y[:n] - ref).max() < 2e-13 * scale

    def test_choose_k_budget(self):
        pk, _, _ = _build(seed=7)
        k, tail = comp.choose_k(pk, k_cap=10)
        deg = comp._host_degrees(pk)
        assert tail == int(np.maximum(deg - k, 0).sum())
        assert 4 <= k <= 10


class TestF64Mode:
    """The solver's default mode (native f64 ELL products) at the scales
    and spill shapes the removed slab mode was tested on."""

    @pytest.mark.parametrize("scale", [1.0, 2081.0 * np.pi / 3.0])
    def test_matches_f64_reference(self, scale):
        """f64-mode matvec == f64 reference, including at
        cancellation-prone conductance scales."""
        from tests.test_dia_sharded import grid_system

        ell, coords = grid_system(64, 64, n_far=30)
        a = ell.to_scipy() * scale
        pk = dia.pack_csr_as_dia(a, coverage=0.9, max_offsets=4)
        assert len(pk.rem_rows) > 0
        params = pk.to_device(keep_widx=True)
        op = comp.build(pk.meta, params, pk, mode="f64")
        n = a.shape[0]
        rng = np.random.default_rng(2)
        x32 = (rng.standard_normal(n).astype(np.float32)
               + np.linspace(0, 3.3, n).astype(np.float32))
        x_pad = np.zeros(pk.np_, np.float32)
        x_pad[:n] = x32
        y = np.asarray(comp.matvec(op, op.params, jnp.asarray(x_pad)))
        ref = a @ x32.astype(np.float64)
        scale_row = (abs(a) @ np.abs(x32.astype(np.float64))).max()
        assert np.abs(y[:n] - ref).max() < 2e-13 * scale_row

    def test_spill_tail_covered(self):
        from tests.test_dia_sharded import grid_system

        ell, coords = grid_system(48, 48, n_far=200, seed=9)
        a = ell.to_scipy()
        pk = dia.pack_csr_as_dia(a, coverage=0.8, max_offsets=2)
        params = pk.to_device(keep_widx=True)
        op = comp.build(pk.meta, params, pk, mode="f64", k_cap=4)
        assert op.tail_n > 0
        n = a.shape[0]
        rng = np.random.default_rng(3)
        x32 = rng.standard_normal(n).astype(np.float32)
        x_pad = np.zeros(pk.np_, np.float32)
        x_pad[:n] = x32
        y = np.asarray(comp.matvec(op, op.params, jnp.asarray(x_pad)))
        ref = a @ x32.astype(np.float64)
        rel = np.abs(y[:n] - ref).max() / np.abs(ref).max()
        assert rel < 1e-10, rel

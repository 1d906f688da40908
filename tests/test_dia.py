"""Block-offset-DIA operator format (ops.dia): packing, matvec parity.

Correctness is validated on the CPU against scipy; the same XLA einsum
contraction runs on the GPU (chip_smoke.py checks it there at full
width).  Reference counterpart: the sparse operator inside scipy.spsolve
(reference solver.py:767-780).
"""

import numpy as np
import pytest
import scipy.sparse

import jax.numpy as jnp

from padne_tpu.ops import assembly, bell, dia


def random_system(n=3001, m=9000, seed=0, spread=200):
    """Random near-banded COO system + scipy reference."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, m)
    cols = np.clip(rows + rng.integers(-spread, spread + 1, m), 0, n - 1)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    key = rows * n + cols
    _, ui = np.unique(key, return_index=True)
    rows, cols = rows[ui], cols[ui]
    vals = rng.standard_normal(len(rows))
    diag = rng.random(n) + 1.0
    a = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a = a + scipy.sparse.diags(diag)
    return rows, cols, vals, diag, a


class TestChooseOffsets:
    def test_always_includes_zero(self):
        rows = np.array([0, 1]),
        offs = dia.choose_offsets(np.array([0]), np.array([500]), b=128)
        assert 0 in offs

    def test_coverage_greedy(self):
        # heavy diagonal + light far band: zero offset picked first
        rows = np.arange(1000)
        cols = np.concatenate([np.arange(1000), np.arange(1000)])
        rows = np.concatenate([rows, np.clip(rows + 600, 0, 999)])
        offs = dia.choose_offsets(rows, cols, b=128, coverage=0.5)
        assert offs[0] == 0 or 0 in offs

    def test_empty(self):
        assert dia.choose_offsets(np.zeros(0, int), np.zeros(0, int)) == (0,)


class TestPackDia:
    def test_matvec_matches_scipy(self):
        rows, cols, vals, diag, a = random_system()
        pk = dia.pack_dia(a.shape[0], rows, cols, vals, diag=diag,
                          coverage=0.9, max_offsets=4)
        assert len(pk.rem_rows) > 0  # spread guarantees a remainder
        params = pk.to_device()
        n = a.shape[0]
        rng = np.random.default_rng(1)
        x = rng.standard_normal((n, 3)).astype(np.float32)
        xp = dia.pad_to(jnp.asarray(x), pk.np_)
        y = np.asarray(dia.dia_matvec(pk.meta, params, xp))
        yref = a @ x
        assert np.abs(y[:n] - yref).max() / np.abs(yref).max() < 1e-5
        assert np.all(y[n:] == 0)

    def test_full_coverage_no_remainder(self):
        rows, cols, vals, diag, a = random_system(spread=50)
        pk = dia.pack_dia(a.shape[0], rows, cols, vals, diag=diag,
                          coverage=1.0, max_offsets=64)
        assert len(pk.rem_rows) == 0

    def test_1d_rhs(self):
        rows, cols, vals, diag, a = random_system(n=500, m=2000, spread=30)
        pk = dia.pack_dia(500, rows, cols, vals, diag=diag)
        params = pk.to_device()
        x = np.random.default_rng(2).standard_normal(500).astype(np.float32)
        xp = dia.pad_to(jnp.asarray(x), pk.np_)
        y = np.asarray(dia.dia_matvec(pk.meta, params, xp))
        yref = a @ x
        assert y.ndim == 1
        assert np.abs(y[:500] - yref).max() / np.abs(yref).max() < 1e-5

    def test_empty_matrix(self):
        pk = dia.pack_dia(64, np.zeros(0, int), np.zeros(0, int),
                          np.zeros(0))
        params = pk.to_device()
        x = jnp.ones((pk.np_, 2), jnp.float32)
        y = np.asarray(dia.dia_matvec(pk.meta, params, x))
        assert np.all(y == 0)

    def test_jit_with_static_meta(self):
        import jax

        rows, cols, vals, diag, a = random_system(n=700, m=3000, spread=40)
        pk = dia.pack_dia(700, rows, cols, vals, diag=diag)
        params = pk.to_device()
        f = jax.jit(dia.dia_matvec, static_argnames=("meta",))
        x = np.random.default_rng(3).standard_normal((700, 2)).astype(np.float32)
        xp = dia.pad_to(jnp.asarray(x), pk.np_)
        y = np.asarray(f(pk.meta, params, xp))
        yref = a @ x
        assert np.abs(y[:700] - yref).max() / np.abs(yref).max() < 1e-5


class TestAdapters:
    def test_ell_with_hilbert_perm(self):
        rng = np.random.default_rng(4)
        n = 2000
        e = rng.integers(0, n, (6000, 2))
        e = e[e[:, 0] != e[:, 1]]
        w = rng.random(len(e))
        ell = assembly.build_ell(n, e, w)
        coords = rng.random((n, 2))
        perm = bell.hilbert_order(coords)
        pk = dia.pack_ell_as_dia(ell, perm=perm)
        params = pk.to_device()
        x = rng.standard_normal((n, 2)).astype(np.float32)
        # matvec in permuted coordinates == permuted reference matvec
        xp = dia.pad_to(jnp.asarray(x[perm]), pk.np_)
        y = np.asarray(dia.dia_matvec(pk.meta, params, xp))
        yref = (ell.to_scipy() @ x)[perm]
        assert np.abs(y[:n] - yref).max() / np.abs(yref).max() < 1e-5

    def test_csr_adapter(self):
        rows, cols, vals, diag, a = random_system(n=900, m=4000, spread=60)
        pk = dia.pack_csr_as_dia(a)
        params = pk.to_device()
        x = np.random.default_rng(5).standard_normal((900, 2)).astype(np.float32)
        xp = dia.pad_to(jnp.asarray(x), pk.np_)
        y = np.asarray(dia.dia_matvec(pk.meta, params, xp))
        yref = a @ x
        assert np.abs(y[:900] - yref).max() / np.abs(yref).max() < 1e-5


class TestHiDeltaEncoding:
    """widx_hi travels as an int16 delta stream; large block jumps ride
    the exception list (DiaPack._hi_delta)."""

    def test_roundtrip_random(self):
        rows, cols, vals, diag, a = random_system()
        pk = dia.pack_dia(a.shape[0], rows, cols, vals, diag=diag,
                          coverage=0.9, max_offsets=4)
        d16, exc_i, exc_v = pk._hi_delta()
        d = d16.astype(np.int64)
        d[exc_i] = exc_v
        assert np.array_equal(np.cumsum(d), pk.widx_hi.astype(np.int64))

    def test_exception_path_and_matvec(self):
        """A sparse system with a ~100-block dead gap forces deltas
        beyond int16; the matvec must still match scipy."""
        n = 40_000
        rng = np.random.default_rng(3)
        # entries clustered at both ends, nothing in the middle
        lo_rows = rng.integers(0, 2000, 3000)
        hi_rows = rng.integers(n - 2000, n, 3000)
        rows = np.concatenate([lo_rows, hi_rows])
        cols = np.clip(rows + rng.integers(-60, 61, len(rows)), 0, n - 1)
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
        key = rows * n + cols
        _, ui = np.unique(key, return_index=True)
        rows, cols = rows[ui], cols[ui]
        vals = rng.standard_normal(len(rows))
        diag = rng.random(n) + 1.0
        a = scipy.sparse.coo_matrix(
            (vals, (rows, cols)), shape=(n, n)).tocsr() \
            + scipy.sparse.diags(diag)
        pk = dia.pack_dia(n, rows, cols, vals, diag=diag)
        d16, exc_i, exc_v = pk._hi_delta()
        assert len(exc_i) >= 1, "gap must force an int16 exception"
        pk.start_upload()
        params = pk.to_device()
        x = rng.standard_normal((n, 2)).astype(np.float32)
        xp = dia.pad_to(jnp.asarray(x), pk.np_)
        y = np.asarray(dia.dia_matvec(pk.meta, params, xp))
        yref = a @ x
        assert np.abs(y[:n] - yref).max() / np.abs(yref).max() < 1e-5


class TestRatio16:
    """int16 fixed-point ratio residue (a64 vs its f32 rounding)."""

    def _decode(self, a64, q):
        with np.errstate(over="ignore"):
            a32 = np.asarray(a64, np.float64).astype(np.float32)
        return a32.astype(np.float64) * (
            1.0 + q.astype(np.float64) * dia.RATIO16_SCALE)

    def test_reconstruction_error_bound(self):
        rng = np.random.default_rng(0)
        mag = 10.0 ** rng.uniform(-30, 30, 20_000)
        a = mag * rng.choice([-1.0, 1.0], len(mag))
        a *= 1.0 + rng.uniform(-1e-7, 1e-7, len(a))  # off-grid mantissas
        q = dia.ratio16_encode(a)
        rec = self._decode(a, q)
        # Half-step quantization: ~2^-40 relative (9.2e-13).
        assert (np.abs(rec - a) <= 1e-12 * np.abs(a)).all()

    def test_exact_f32_values_round_trip(self):
        a = np.array([0.0, 1.0, -2.5, 2.0**-126, 65504.0], np.float64)
        q = dia.ratio16_encode(a)
        assert (q == 0).all()
        assert (self._decode(a, q) == a).all()

    def test_subnormal_and_underflow_guards(self):
        # a64 that underflows f32 entirely -> encodes 0, error is |a64|.
        tiny = np.array([3e-46, -3e-46, 1e-50], np.float64)
        q = dia.ratio16_encode(tiny)
        rec = self._decode(tiny, q)
        assert np.isfinite(rec).all()
        assert (np.abs(rec - tiny) <= 7e-46).all()
        # subnormal f32 base: ratio clips but error stays <= half-ulp.
        sub = np.array([1.5e-45, 2.9e-45, -6.0e-44], np.float64)
        q = dia.ratio16_encode(sub)
        rec = self._decode(sub, q)
        assert np.isfinite(rec).all()
        assert (np.abs(rec - sub) <= 1.5e-45).all()

    def test_device_widen_matches_host_decode(self):
        rng = np.random.default_rng(1)
        a = rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 7, 4096)
        q = dia.ratio16_encode(a)
        a32 = jnp.asarray(a.astype(np.float32))
        dev = np.asarray(dia.ratio16_widen(a32, jnp.asarray(q)))
        assert (dev == self._decode(a, q)).all()

    def test_nonfinite_values_encode_safely(self):
        a = np.array([1e39, -1e39, np.inf, 1.0], np.float64)
        q = dia.ratio16_encode(a)
        assert q.dtype == np.int16
        assert q[3] == 0 and (q[:3] == 0).all()
        rec = self._decode(a, q)
        # Overflowed inputs stay visibly non-finite; finite ones exact.
        assert np.isinf(rec[:3]).all()
        assert rec[3] == 1.0


class TestToDeviceGuards:
    def test_keep_widx_with_reused_slab_raises(self):
        rng = np.random.default_rng(0)
        n = 512
        rows = np.arange(n - 1)
        cols = rows + 1
        vals = rng.random(n - 1)
        pk = dia.pack_dia(n, rows, cols, vals, diag=np.ones(n))
        params = pk.to_device(keep_widx=True)
        assert params["_hi"] is not None
        pk2 = dia.pack_dia(n, rows, cols, vals, diag=np.ones(n))
        with pytest.raises(ValueError, match="keep_widx"):
            pk2.to_device(w=params["w"], keep_widx=True)

    def test_rem_gather_mode_matches_scatter(self, monkeypatch):
        """PADNE_TPU_REM_GATHER merges bucket contributions through one
        inverse-map gather; results must be bitwise identical to the
        scatter path (each row lives in exactly one bucket)."""
        # Skewed degrees: some rows get >3 remainder entries (spill).
        rng = np.random.default_rng(7)
        n = 3001
        rows = np.concatenate([
            rng.integers(0, n, 4000),
            np.repeat(rng.integers(0, n, 40), 6),   # degree-6 spill rows
        ])
        cols = np.clip(rows + rng.integers(-900, 901, len(rows)), 0, n - 1)
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
        key = rows * n + cols
        _, ui = np.unique(key, return_index=True)
        rows, cols = rows[ui], cols[ui]
        vals = rng.standard_normal(len(rows))
        diag = rng.random(n) + 1.0
        pk = dia.pack_dia(n, rows, cols, vals, diag=diag,
                          coverage=0.8, max_offsets=4)
        assert len(pk.rem_rows) > 0
        deg = np.unique(pk.rem_rows, return_counts=True)[1]
        assert deg.max() > max(dia.DiaPack.REM_BUCKETS)  # spill present

        monkeypatch.delenv("PADNE_TPU_REM_GATHER", raising=False)
        p_scatter = pk.to_device()
        assert "rg_map" not in p_scatter
        monkeypatch.setenv("PADNE_TPU_REM_GATHER", "1")
        p_gather = pk.to_device()
        assert "rg_map" in p_gather

        x = rng.standard_normal((pk.np_, 3)).astype(np.float32)
        xj = jnp.asarray(x)
        ys = np.asarray(dia.dia_matvec(pk.meta, p_scatter, xj))
        yg = np.asarray(dia.dia_matvec(pk.meta, p_gather, xj))
        np.testing.assert_array_equal(ys, yg)
        xt = jnp.asarray(x.T)
        yst = np.asarray(dia.dia_matvec_t(pk.meta, p_scatter, xt))
        ygt = np.asarray(dia.dia_matvec_t(pk.meta, p_gather, xt))
        np.testing.assert_array_equal(yst, ygt)

    def test_rem_ell_memoized_and_replace_safe(self):
        import dataclasses

        rng = np.random.default_rng(1)
        n = 2048
        rows = rng.integers(0, n, 300)
        cols = (rows + rng.integers(600, 1200, 300)) % n
        keep = rows != cols
        pk = dia.pack_dia(n, rows[keep], cols[keep],
                          rng.random(keep.sum()), diag=np.ones(n))
        r1 = pk.rem_ell()
        assert pk.rem_ell() is r1          # cached
        half = len(pk.rem_rows) // 2
        pk2 = dataclasses.replace(pk, rem_rows=pk.rem_rows[:half],
                                  rem_cols=pk.rem_cols[:half],
                                  rem_vals=pk.rem_vals[:half])
        r2 = pk2.rem_ell()                 # stale copy must NOT be hit
        assert r2 is not r1
        total2 = sum(len(r2[0][d][0]) * d for d in dia.DiaPack.REM_BUCKETS
                     ) + len(r2[1])
        assert total2 == half


class TestExtraSlots:
    """Per-row-block extra-offset slot packing of the remainder
    (dia.pack_extra_slots / to_device(slots=E)): the top-E column
    blocks of each row block become dense slot tables consumed inside
    the slab kernel; only the unplaced tail keeps the COO scatter."""

    def _pack(self, spread=600, **kw):
        rows, cols, vals, diag, a = random_system(spread=spread)
        pk = dia.pack_dia(a.shape[0], rows, cols, vals, diag=diag,
                          coverage=0.8, max_offsets=4, **kw)
        assert len(pk.rem_rows) > 100
        return pk, a

    def test_partition_is_exact(self):
        # Placed + tail partition the remainder; reconstructing the
        # placed entries from the slot coordinates reproduces exactly
        # the remainder triplets that are not in the tail.
        pk, a = self._pack()
        ex = dia.pack_extra_slots(pk, 4)
        assert len(ex.idx) + len(ex.tail_rows) == len(pk.rem_rows)
        b, e = pk.b, ex.e
        slot = (ex.idx // b) % e
        rb = ex.idx // (b * e)
        rl = ex.idx % b
        rows_p = rb * b + rl
        cols_p = ex.tgt.reshape(-1)[rb * e + slot] * b + ex.cls
        def key(r, c):
            return set(zip(map(int, r), map(int, c)))
        placed = key(rows_p, cols_p)
        tail = key(ex.tail_rows, ex.tail_cols)
        full = key(pk.rem_rows, pk.rem_cols)
        assert placed | tail == full and not placed & tail
        # values match the original remainder entries
        ref = {(int(r), int(c)): v for r, c, v in
               zip(pk.rem_rows, pk.rem_cols, pk.rem_vals)}
        for r, c, v in zip(rows_p, cols_p, ex.vals):
            assert ref[(int(r), int(c))] == v

    def test_unique_slot_cells(self):
        pk, _ = self._pack()
        ex = dia.pack_extra_slots(pk, 3)
        assert len(np.unique(ex.idx)) == len(ex.idx)

    def test_high_coverage(self):
        # FEM-like locality: top-4 slots should absorb the bulk.
        pk, _ = self._pack()
        ex = dia.pack_extra_slots(pk, 4)
        assert len(ex.idx) > 0.5 * len(pk.rem_rows)

    @pytest.mark.parametrize("slots", [1, 4, 8])
    def test_matvec_parity(self, slots):
        pk, a = self._pack()
        params = pk.to_device(slots=slots)
        assert "xs_tgt" in params
        n = a.shape[0]
        x = np.random.default_rng(7).standard_normal((n, 3)).astype(
            np.float32)
        xp = dia.pad_to(jnp.asarray(x), pk.np_)
        y = np.asarray(dia.dia_matvec(pk.meta, params, xp))
        yref = a @ x
        assert np.abs(y[:n] - yref).max() / np.abs(yref).max() < 1e-5
        assert np.all(y[n:] == 0)
        # transposed layout
        yt = np.asarray(dia.dia_matvec_t(pk.meta, params,
                                         jnp.asarray(xp.T)))
        assert np.abs(yt.T[:n] - yref).max() / np.abs(yref).max() < 1e-5

    def test_keep_widx_composes_with_slots(self):
        """slots + keep_widx is a supported combination since the
        compensated operator landed (ops.comp takes the raw remainder
        from the host pack); the r{d}_ buckets then hold only the
        post-slot tail, and the widx split is still returned."""
        pk, _ = self._pack()
        params = pk.to_device(slots=2, keep_widx=True)
        assert "_hi" in params and "_lo" in params
        assert "xs_tgt" in params
        tail = sum(params[f"r{d}_rows"].shape[0] * d
                   for d in dia.DiaPack.REM_BUCKETS)
        tail += params["sp_rows"].shape[0]
        assert tail < len(pk.rem_rows)

    def test_empty_remainder_skips_slots(self):
        rows, cols, vals, diag, a = random_system(spread=50)
        pk = dia.pack_dia(a.shape[0], rows, cols, vals, diag=diag,
                          coverage=1.0, max_offsets=64)
        assert len(pk.rem_rows) == 0
        params = pk.to_device(slots=4)
        assert "xs_tgt" not in params

    def test_env_knob(self, monkeypatch):
        monkeypatch.setenv("PADNE_TPU_SLOTS", "4")
        assert dia.slots_env() == 4
        monkeypatch.setenv("PADNE_TPU_SLOTS", "junk")
        assert dia.slots_env(2) == 2
        monkeypatch.delenv("PADNE_TPU_SLOTS")
        assert dia.slots_env() == 8     # measured-on default (level 0)
        monkeypatch.setenv("PADNE_TPU_SLOTS", "0")
        assert dia.slots_env() == 0     # explicit opt-out

    def test_bordered_solve_with_slots(self, monkeypatch):
        # The production DIA solver path end-to-end under
        # PADNE_TPU_SLOTS: same solution as the slot-free solve.
        import jax.numpy as jnp

        from padne_tpu.ops import schur
        from test_schur_dia import make_system

        system = make_system(with_regulator=True)
        monkeypatch.setenv("PADNE_TPU_SLOTS", "0")
        base = schur.solve_bordered(system, operator="dia",
                                    device_dtype=jnp.float32)
        monkeypatch.setenv("PADNE_TPU_SLOTS", "4")
        got = schur.solve_bordered(system, operator="dia",
                                   device_dtype=jnp.float32)
        assert got.residual_norm < 1e-9
        scale = max(np.abs(base.v).max(), 1e-12)
        assert np.abs(got.v - base.v).max() < 1e-6 * scale

    def test_bf16_slab_parity(self):
        # V-cycle configuration: bf16 slab + slot tables (loose gate —
        # preconditioner-only precision).
        pk, a = self._pack()
        params = pk.to_device(slab_dtype=jnp.bfloat16, slots=4)
        assert params["w"].dtype == jnp.bfloat16
        n = a.shape[0]
        x = np.random.default_rng(9).standard_normal((n, 2)).astype(
            np.float32)
        xp = dia.pad_to(jnp.asarray(x), pk.np_)
        y = np.asarray(dia.dia_matvec(pk.meta, params, xp))
        yref = a @ x
        assert np.abs(y[:n] - yref).max() / np.abs(yref).max() < 2e-2

    def test_mixed_bf16_slab_f32_slots(self):
        # A bf16 slab REUSED under an f32 request leaves the slot
        # weights f32 while the slab is bf16 (the lumped-smoothing
        # construction); operand dtypes must still agree in-kernel.
        pk, a = self._pack()
        p_bf = pk.to_device(slab_dtype=jnp.bfloat16)
        params = pk.to_device(w=p_bf["w"], slots=4)
        assert params["w"].dtype == jnp.bfloat16
        assert params["xs_w"].dtype == jnp.float32
        n = a.shape[0]
        x = np.random.default_rng(11).standard_normal((n, 2)).astype(
            np.float32)
        xp = dia.pad_to(jnp.asarray(x), pk.np_)
        y = np.asarray(dia.dia_matvec(pk.meta, params, xp))
        yref = a @ x
        assert np.abs(y[:n] - yref).max() / np.abs(yref).max() < 2e-2


class TestTransposedRemainder:
    """The transposed-layout remainder path (dia._apply_remainder_t):
    small tails skip the (R, n) <-> (n, R) transpose sandwich around
    the gather/scatter — two full-array relayouts whose cost does not
    shrink with the tail."""

    def _params(self, slots=0):
        rows, cols, vals, diag, a = random_system(spread=600)
        pk = dia.pack_dia(a.shape[0], rows, cols, vals, diag=diag,
                          coverage=0.8, max_offsets=4)
        assert len(pk.rem_rows) > 100
        return pk, pk.to_device(slots=slots), a

    @pytest.mark.parametrize("slots", [0, 4])
    def test_matches_sandwich_path(self, monkeypatch, slots):
        pk, params, a = self._params(slots)
        rng = np.random.default_rng(3)
        xt = jnp.asarray(rng.standard_normal(
            (5, pk.np_)).astype(np.float32))
        monkeypatch.setenv("PADNE_TPU_REM_T", "0")
        y_sand = np.asarray(dia.dia_matvec_t(pk.meta, params, xt))
        monkeypatch.setenv("PADNE_TPU_REM_T", str(10**9))
        y_t = np.asarray(dia.dia_matvec_t(pk.meta, params, xt))
        scale = np.abs(y_sand).max()
        assert np.abs(y_sand - y_t).max() / scale < 1e-6

    def test_matches_scipy(self, monkeypatch):
        pk, params, a = self._params(slots=4)
        n = a.shape[0]
        rng = np.random.default_rng(4)
        x = rng.standard_normal((n, 3)).astype(np.float32)
        monkeypatch.setenv("PADNE_TPU_REM_T", str(10**9))
        xp = np.zeros((pk.np_, 3), np.float32)
        xp[:n] = x
        yt = np.asarray(dia.dia_matvec_t(pk.meta, params,
                                         jnp.asarray(xp.T)))
        yref = a @ x
        assert (np.abs(yt.T[:n] - yref).max()
                / np.abs(yref).max()) < 1e-5

    def test_threshold_selects_path(self):
        # _rem_count counts every entry (bucket degree-weighted + spill)
        pk, params, _ = self._params(slots=0)
        total = int(len(pk.rem_rows))
        assert dia._rem_count(params) == total


def banded_system(n=1600, seed=0, spread=96):
    """Random banded COO (off-diagonal, duplicate-free) + diagonal and
    the scipy CSR of the whole operator."""
    rng = np.random.default_rng(seed)
    m = 6 * n
    rows = rng.integers(0, n, m)
    cols = np.clip(rows + rng.integers(-spread, spread + 1, m), 0, n - 1)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    _, ui = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[ui], cols[ui]
    vals = rng.standard_normal(len(rows))
    diag = rng.random(n) + 1.0
    a = scipy.sparse.coo_matrix(
        (np.concatenate([vals, diag]),
         (np.concatenate([rows, np.arange(n)]),
          np.concatenate([cols, np.arange(n)]))),
        shape=(n, n)).tocsr()
    return a, rows, cols, vals, diag


class TestXlaSlab:
    """The slab contraction (_xla_main, the only slab path) against
    scipy: banded random operators in both layouts, bf16 slabs, a real
    FEM operator and wide (d > 8) offset sets."""

    @staticmethod
    def _pack(n, rows, cols, vals, diag, **kw):
        return dia.pack_dia(n, rows.astype(np.int64),
                            cols.astype(np.int64), vals, diag, **kw)

    def test_transposed_layout_matches_scipy(self):
        n = 1600
        a, rows, cols, vals, diag = banded_system(n)
        pack = self._pack(n, rows, cols, vals, diag)
        params = pack.to_device(dtype=jnp.float32)
        rng = np.random.default_rng(1)
        xt = rng.standard_normal((8, pack.np_)).astype(np.float32)
        xt[:, n:] = 0.0
        y = np.asarray(dia.dia_matvec_t(pack.meta, params,
                                        jnp.asarray(xt)))
        ref = (a @ xt[:, :n].T.astype(np.float64)).T
        np.testing.assert_allclose(y[:, :n], ref, rtol=2e-5,
                                   atol=2e-5 * np.abs(ref).max())
        assert np.all(y[:, n:] == 0)

    def test_row_layout_matches_scipy(self):
        n = 1600
        a, rows, cols, vals, diag = banded_system(n, seed=3)
        pack = self._pack(n, rows, cols, vals, diag)
        params = pack.to_device(dtype=jnp.float32)
        x = np.random.default_rng(2).standard_normal((n, 4))
        xp = np.zeros((pack.np_, 4))
        xp[:n] = x
        y = np.asarray(dia.dia_matvec(pack.meta, params,
                                      jnp.asarray(xp, dtype=jnp.float32)))
        np.testing.assert_allclose(y[:n], a @ x, rtol=5e-4, atol=5e-4)

    def test_bf16_slabs_within_bf16_accuracy(self):
        n = 1024
        a, rows, cols, vals, diag = banded_system(n, seed=5, spread=64)
        pack = self._pack(n, rows, cols, vals, diag)
        p32 = pack.to_device(dtype=jnp.float32)
        pbf = dict(p32)
        pbf["w"] = p32["w"].astype(jnp.bfloat16)
        xt = jnp.asarray(np.random.default_rng(4).standard_normal(
            (8, pack.np_)), dtype=jnp.float32)
        y32 = np.asarray(dia.dia_matvec_t(pack.meta, p32, xt))
        ybf = np.asarray(dia.dia_matvec_t(pack.meta, pbf, xt),
                         dtype=np.float32)
        scale = np.abs(y32).max()
        assert np.abs(ybf - y32).max() < 0.05 * scale

    def test_fem_operator_matches_scipy(self):
        from padne_tpu import geom, mesh
        from padne_tpu.ops import assembly, bell

        m = mesh.Mesher(mesh.Mesher.Config(maximum_size=0.5)).poly_to_mesh(
            geom.box(0, 0, 8, 8))
        ell = assembly.build_ell(
            m.num_vertices, m.edges.astype(np.int64), m.cotan_edge_weights)
        perm = bell.hilbert_order(m.vertices)  # perm[new] = old
        pack = dia.pack_ell_as_dia(ell, perm=perm)
        params = pack.to_device(dtype=jnp.float32)
        n = m.num_vertices
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        x = np.random.default_rng(7).standard_normal((n, 2))
        xp = np.zeros((pack.np_, 2))
        xp[inv] = x
        y = np.asarray(dia.dia_matvec(pack.meta, params,
                                      jnp.asarray(xp, dtype=jnp.float32)))
        ref = ell.to_scipy() @ x
        np.testing.assert_allclose(y[inv], ref,
                                   atol=3e-4 * np.abs(ref).max())

    def test_wide_offsets_match_scipy(self):
        """Deep-level widening produces d = 24 slabs; the offset loop
        and halo arithmetic must stay exact at wide offset counts."""
        n = 1600
        a, rows, cols, vals, diag = banded_system(n, spread=90)
        pack = self._pack(n, rows, cols, vals, diag, b=8, max_offsets=24,
                          coverage=0.995)
        assert len(pack.offs) > 8
        params = pack.to_device(dtype=jnp.float32)
        xt = np.random.default_rng(3).standard_normal(
            (8, pack.np_)).astype(np.float32)
        y = np.asarray(dia.dia_matvec_t(pack.meta, params,
                                        jnp.asarray(xt)))
        ref = np.zeros((8, pack.np_))
        ref[:, :n] = (a @ xt[:, :n].T.astype(np.float64)).T
        np.testing.assert_allclose(y, ref, rtol=3e-5, atol=3e-5)

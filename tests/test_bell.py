"""Block-ELL operator format (ops.bell): packing, orderings, matvec.

The format amortizes each gather index over a tile (see the ops/bell.py
header); these tests validate correctness on the CPU.  Production uses
only its Hilbert ordering.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from padne_tpu.ops import assembly, bell


@pytest.fixture
def random_ell():
    rng = np.random.default_rng(0)
    n = 3001
    e = rng.integers(0, n, (9000, 2))
    e = e[e[:, 0] != e[:, 1]]
    w = rng.random(len(e))
    return n, assembly.build_ell(n, e, w), rng


class TestHilbertOrder:
    def test_permutation_valid(self):
        rng = np.random.default_rng(1)
        pts = rng.random((500, 2)) * 10
        perm = bell.hilbert_order(pts)
        assert sorted(perm) == list(range(500))

    def test_locality_beats_random(self):
        # Points adjacent on a grid should be closer in Hilbert order
        # than in random order (sum of |order distance| over grid edges).
        g = 32
        xs, ys = np.meshgrid(np.arange(g), np.arange(g))
        pts = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(float)
        perm = bell.hilbert_order(pts)
        inv = np.empty(g * g, dtype=np.int64)
        inv[perm] = np.arange(g * g)
        # horizontal grid edges
        a = np.arange(g * g).reshape(g, g)[:, :-1].ravel()
        b = a + 1
        hilbert_cost = np.abs(inv[a] - inv[b]).mean()
        rng = np.random.default_rng(2)
        rperm = rng.permutation(g * g)
        rinv = np.empty_like(rperm)
        rinv[rperm] = np.arange(g * g)
        random_cost = np.abs(rinv[a] - rinv[b]).mean()
        assert hilbert_cost < random_cost / 10

    def test_empty_and_single(self):
        assert len(bell.hilbert_order(np.zeros((0, 2)))) == 0
        assert list(bell.hilbert_order(np.array([[1.0, 2.0]]))) == [0]

    def test_degenerate_collinear(self):
        pts = np.stack([np.arange(100.0), np.zeros(100)], axis=1)
        perm = bell.hilbert_order(pts)
        assert sorted(perm) == list(range(100))


class TestPermuteEll:
    def test_matvec_invariant(self, random_ell):
        n, ell, rng = random_ell
        coords = rng.random((n, 2))
        perm = bell.hilbert_order(coords)
        ellp, inv = bell.permute_ell(ell, perm)
        x = rng.standard_normal(n)
        y_orig = ell.to_scipy() @ x
        y_perm = ellp.to_scipy() @ x[perm]
        np.testing.assert_allclose(y_perm, y_orig[perm], rtol=1e-12)
        # inv round-trips
        assert np.array_equal(inv[perm], np.arange(n))


class TestBlockEllPack:
    def test_square_matvec(self, random_ell):
        n, ell, rng = random_ell
        be = bell.pack_ell_as_bell(ell, br=32, bc=32)
        bcols, w = be.to_device()
        R = 3
        x = rng.standard_normal((n, R))
        xp = np.zeros((be.cols_padded, R))
        xp[:n] = x
        dims = (be.nb, be.nbc, be.br, be.bc, be.kb)
        y = np.asarray(
            bell.bell_matvec(dims, bcols, w, jnp.asarray(xp, jnp.float32))
        )[:n]
        y = y + ell.diag[:, None] * x
        yref = ell.to_scipy() @ x
        assert np.abs(y - yref).max() / np.abs(yref).max() < 1e-5

    def test_rectangular_matvec(self):
        import scipy.sparse

        rng = np.random.default_rng(3)
        P = scipy.sparse.random(801, 217, density=0.01, random_state=1,
                                format="csr")
        bp = bell.csr_as_bell(P, br=32, bc=16)
        bcols, w = bp.to_device()
        x = rng.standard_normal((217, 2))
        xp = np.zeros((bp.cols_padded, 2))
        xp[:217] = x
        dims = (bp.nb, bp.nbc, bp.br, bp.bc, bp.kb)
        y = np.asarray(
            bell.bell_matvec(dims, bcols, w, jnp.asarray(xp, jnp.float32))
        )[:801]
        yref = P @ x
        assert np.abs(y - yref).max() / max(np.abs(yref).max(), 1e-30) < 1e-5

    def test_empty_matrix(self):
        be = bell.pack_block_ell(
            64, 64, np.zeros(0, int), np.zeros(0, int), np.zeros(0),
            br=32, bc=32,
        )
        bcols, w = be.to_device()
        x = jnp.ones((be.cols_padded, 2), jnp.float32)
        dims = (be.nb, be.nbc, be.br, be.bc, be.kb)
        y = np.asarray(bell.bell_matvec(dims, bcols, w, x))
        assert np.all(y == 0)

    def test_nonmultiple_sizes_pad(self):
        rng = np.random.default_rng(4)
        n = 101  # not a multiple of block size
        e = rng.integers(0, n, (300, 2))
        e = e[e[:, 0] != e[:, 1]]
        w = rng.random(len(e))
        ell = assembly.build_ell(n, e, w)
        be = bell.pack_ell_as_bell(ell, br=32, bc=32)
        assert be.rows_padded % 32 == 0
        bcols, wd = be.to_device()
        x = rng.standard_normal((n, 1))
        xp = np.zeros((be.cols_padded, 1))
        xp[:n] = x
        dims = (be.nb, be.nbc, be.br, be.bc, be.kb)
        y = np.asarray(
            bell.bell_matvec(dims, bcols, wd, jnp.asarray(xp, jnp.float32))
        )
        yref = ell.to_scipy() @ x - ell.diag[:, None] * x
        assert np.abs(y[:n] - yref).max() < 1e-5 * max(np.abs(yref).max(), 1)
        # padded rows produce zeros
        assert np.all(y[n:] == 0)

    def test_bf16_weights(self, random_ell):
        n, ell, rng = random_ell
        be = bell.pack_ell_as_bell(ell, br=16, bc=16)
        bcols, w = be.to_device(dtype=jnp.bfloat16)
        assert w.dtype == jnp.bfloat16
        x = rng.standard_normal((n, 2))
        xp = np.zeros((be.cols_padded, 2))
        xp[:n] = x
        dims = (be.nb, be.nbc, be.br, be.bc, be.kb)
        y = np.asarray(
            bell.bell_matvec(dims, bcols, w, jnp.asarray(xp, jnp.float32))
        )[:n]
        yref = ell.to_scipy() @ x - ell.diag[:, None] * x
        # bf16 has ~3 decimal digits
        assert np.abs(y - yref).max() / np.abs(yref).max() < 3e-2

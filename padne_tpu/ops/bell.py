"""Block-ELL sparse operators, and the Hilbert ordering the solver uses.

Production uses only `hilbert_order` (the locality ordering of the DIA
slab format, ops.dia).  The block-ELL operator below is an experimental
format whose per-index gather cost it was built to amortize has not been
measured on the GPU:

* rows are grouped into blocks of Br, columns into blocks of Bc;
* the (row-block, col-block) adjacency becomes a padded block-ELL
  `bcols: (nb, Kb)`;
* each nonzero lands in a dense (Br, Bc) weight block; the weights live
  as `W: (nb, Br, Kb * Bc)` so the per-block product is one
  (Br, Kb*Bc) @ (Kb*Bc, R) matmul;
* the SpMV gathers `x.reshape(nbc, Bc * R)[bcols]` — nb * Kb indices
  instead of n * K, a ~20x reduction.

Orderings: block count Kb depends on how well the ordering clusters the
mesh adjacency.  A Hilbert space-filling curve over vertex coordinates
measures ~35% fewer blocks than RCM on FEM meshes (Kb_max 11 vs 17 at
32x32 blocks on a 1M-vertex plane) and is O(n log n) host-side.

Host RAM discipline: W can reach gigabytes, so W is never materialized
on the host NOR uploaded.  The host ships only the nnz-sized scatter indices
and values; W is built on-device by one scatter (`build_w`).

Reference counterpart: the SuperLU factorization this replaces is
reference solver.py:773; the SpMV itself has no reference equivalent
(scipy csr_matvec in C).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# Orderings


def hilbert_order(coords: np.ndarray, bits: int = 16,
                  group: Optional[np.ndarray] = None) -> np.ndarray:
    """Hilbert-curve ordering of 2-D points.

    Returns perm (new index -> old index): sorting points by their
    Hilbert distance.  Vectorized O(bits) passes over all points.

    group: optional (n,) int labels sorted as the PRIMARY key (Hilbert
    distance breaks ties within a group).  Stacked PCB layers cover the
    same (x, y) footprint, so a layer-blind sweep interleaves all
    layers' vertices and shatters the block-offset banded structure
    (measured: 50% of nonzeros off-offset on a 4-layer board vs ~5%
    with per-mesh grouping).  Grouping by mesh keeps each mesh a
    contiguous Hilbert-ordered block; the sparse inter-layer via
    couplings land in the remainder where they belong.
    """
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n >= 100_000 and bits <= 16 and (
        group is None or (np.asarray(group) >= 0).all()
    ):
        # Native twin: one pass + one pair sort (the 16 vectorized
        # numpy passes + lexsort cost ~0.7 s at 1M points).  Packing
        # (group << 32) | distance needs non-negative group ids and
        # distance < 2^32 (bits <= 16).
        import ctypes

        from padne_tpu import native

        xy = np.ascontiguousarray(coords)
        perm = np.empty(n, dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        gp = (np.ascontiguousarray(group, dtype=np.int64)
              if group is not None else None)
        err = ctypes.create_string_buffer(256)
        rc = native.lib.pg_hilbert_order(
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            int(bits), gp.ctypes.data_as(i64p) if gp is not None else None,
            perm.ctypes.data_as(i64p), err, 256)
        if rc != 0:
            raise RuntimeError(err.value.decode())
        return perm
    lo = coords.min(axis=0)
    span = max(float((coords.max(axis=0) - lo).max()), 1e-30)
    scale = (2**bits - 1) / span
    x = ((coords[:, 0] - lo[0]) * scale).astype(np.int64)
    y = ((coords[:, 1] - lo[1]) * scale).astype(np.int64)

    d = np.zeros(n, dtype=np.int64)
    s = 1 << (bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * np.int64(s) * ((3 * rx) ^ ry)
        # Rotate quadrant so the curve connects.
        swap = ry == 0
        flip = swap & (rx == 1)
        x2 = np.where(flip, s - 1 - x, x)
        y2 = np.where(flip, s - 1 - y, y)
        x, y = np.where(swap, y2, x2), np.where(swap, x2, y2)
        s >>= 1
    if group is not None:
        return np.lexsort((d, np.asarray(group))).astype(np.int64)
    return np.argsort(d, kind="stable").astype(np.int64)


def rcm_order(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (coordinate-free fallback).
    Returns perm (new -> old)."""
    import scipy.sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    if len(rows) == 0:
        return np.arange(n, dtype=np.int64)
    a = scipy.sparse.coo_matrix(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(n, n)
    ).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(a, symmetric_mode=False), dtype=np.int64
    )


# ---------------------------------------------------------------------------
# Structure packing (host) + weight build (device)


@dataclass
class BlockEll:
    """Host-side structure of a block-ELL operator (rectangular OK).

    The value array W is NOT stored here — it is built on-device from
    (w_index, values) by `build_w` (one scatter), because W can be
    gigabytes while nnz-sized arrays are megabytes.
    """

    n_rows: int
    n_cols: int
    br: int
    bc: int
    kb: int
    nb: int          # number of row blocks
    nbc: int         # number of column blocks
    bcols: np.ndarray    # (nb, Kb) int32 column-block ids (pad -> 0)
    w_index: np.ndarray  # (nnz,) int64 flat index into W[nb, Br, Kb*Bc]
    values: np.ndarray   # (nnz,) float64 nonzero values

    @property
    def rows_padded(self) -> int:
        return self.nb * self.br

    @property
    def cols_padded(self) -> int:
        return self.nbc * self.bc

    @property
    def w_bytes_f32(self) -> int:
        return self.nb * self.br * self.kb * self.bc * 4

    def to_device(self, dtype=None):
        """(bcols, W) device pair; W built by one on-device scatter."""
        import jax
        import jax.numpy as jnp

        dtype = dtype or jnp.float32
        bcols = jnp.asarray(self.bcols)
        idx = jnp.asarray(self.w_index)
        vals = jnp.asarray(self.values, dtype=jnp.float32)
        shape = (self.nb, self.br, self.kb * self.bc)

        @jax.jit
        def _build(idx, vals):
            w = jnp.zeros(shape[0] * shape[1] * shape[2], dtype=jnp.float32)
            w = w.at[idx].set(vals, mode="promise_in_bounds",
                              unique_indices=True)
            return w.reshape(shape).astype(dtype)

        return bcols, _build(idx, vals)


def pack_block_ell(
    n_rows: int,
    n_cols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    values: np.ndarray,
    br: int = 32,
    bc: int = 32,
) -> BlockEll:
    """Pack COO triplets into block-ELL structure (duplicates must already
    be merged; rows/cols may arrive in any order)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)

    nb = max((n_rows + br - 1) // br, 1)
    nbc = max((n_cols + bc - 1) // bc, 1)
    if len(rows) == 0:
        return BlockEll(
            n_rows=n_rows, n_cols=n_cols, br=br, bc=bc, kb=1, nb=nb, nbc=nbc,
            bcols=np.zeros((nb, 1), dtype=np.int32),
            w_index=np.zeros(0, dtype=np.int64),
            values=np.zeros(0, dtype=np.float64),
        )

    rb = rows // br
    cb = cols // bc
    key = rb * np.int64(nbc + 1) + cb
    uk, inv = np.unique(key, return_inverse=True)
    urb = (uk // (nbc + 1)).astype(np.int64)
    ucb = (uk % (nbc + 1)).astype(np.int64)
    counts = np.bincount(urb, minlength=nb)
    kb = max(int(counts.max(initial=1)), 1)
    offs = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    slot_of_pair = np.arange(len(uk), dtype=np.int64) - offs[urb]
    bcols = np.zeros((nb, kb), dtype=np.int32)
    bcols[urb, slot_of_pair] = ucb.astype(np.int32)

    ps = slot_of_pair[inv]
    rl = rows - rb * br
    cl = cols - cb * bc
    # Flat index into W[nb, Br, Kb, Bc] == W[nb, Br, Kb*Bc].
    w_index = ((rb * br + rl) * kb + ps) * bc + cl
    return BlockEll(
        n_rows=n_rows, n_cols=n_cols, br=br, bc=bc, kb=kb, nb=nb, nbc=nbc,
        bcols=bcols, w_index=w_index, values=values,
    )


def pack_ell_as_bell(ell, coords: Optional[np.ndarray] = None,
                     br: int = 32, bc: int = 32):
    """Square operator from an assembly.EllMatrix (off-diagonals only;
    the diagonal stays a separate vector).  Returns the BlockEll of the
    CURRENT ordering — permute the system first (see permute_system)."""
    n, k = ell.cols.shape
    nz = ell.vals != 0
    rows = np.repeat(np.arange(n, dtype=np.int64), k)[nz.ravel()]
    cols = ell.cols.astype(np.int64).ravel()[nz.ravel()]
    vals = ell.vals.ravel()[nz.ravel()]
    return pack_block_ell(n, n, rows, cols, vals, br=br, bc=bc)


def csr_as_bell(A, br: int = 32, bc: int = 32) -> BlockEll:
    """Rectangular scipy CSR matrix -> BlockEll (keeps every stored nnz)."""
    coo = A.tocoo()
    return pack_block_ell(
        A.shape[0], A.shape[1],
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
        br=br, bc=bc,
    )


# ---------------------------------------------------------------------------
# Device matvec


def bell_matvec(bell_dims: tuple, bcols, w, x):
    """y = OffDiag @ x for a block-ELL operator (jit-traceable).

    bell_dims: static (nb, nbc, br, bc, kb) tuple.
    bcols: (nb, Kb) int32; w: (nb, Br, Kb*Bc); x: (cols_padded, R).
    Returns (rows_padded, R).
    """
    import jax.numpy as jnp

    nb, nbc, br, bc, kb = bell_dims
    r = x.shape[1]
    xb = x.reshape(nbc, bc * r)
    g = xb[bcols].reshape(nb, kb * bc, r)
    if w.dtype != x.dtype:
        y = jnp.einsum("bik,bkr->bir", w, g.astype(w.dtype),
                       preferred_element_type=jnp.float32)
    else:
        y = jnp.einsum("bik,bkr->bir", w, g)
    return y.reshape(nb * br, r).astype(x.dtype)


def pad_vector(x, n_padded: int):
    """Zero-pad axis 0 of (n, R) or (n,) to n_padded (device or numpy)."""
    import jax.numpy as jnp

    pad = n_padded - x.shape[0]
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths)


# ---------------------------------------------------------------------------
# System permutation helpers


def permute_ell(ell, perm: np.ndarray):
    """Symmetric row/column permutation of an assembly.EllMatrix.
    perm maps new index -> old index.  Returns (permuted, inv)."""
    from . import assembly

    n = len(ell.diag)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    cols = inv[ell.cols.astype(np.int64)][perm]
    vals = ell.vals[perm]
    diag = ell.diag[perm]
    return assembly.EllMatrix(
        cols=cols.astype(np.int32), vals=vals, diag=diag
    ), inv

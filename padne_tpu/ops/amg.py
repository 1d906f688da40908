"""Smoothed-aggregation algebraic multigrid preconditioner.

The reference relies on a sparse direct factorization (SuperLU,
solver.py:773), which does not map to an accelerator.  Plain
Jacobi-PCG needs
O(1/h) iterations on the FEM Laplacian (measured: thousands at 10^5
DoF).  This module builds a classical smoothed-aggregation AMG hierarchy
on the host (greedy aggregation over a strength-filtered graph, Jacobi-
smoothed prolongation, Galerkin coarse operators) and exposes a fully
jittable V-cycle whose every operation is an SpMV or elementwise work —
a multilevel preconditioner that runs entirely on the device.  Used
as the preconditioner inside the deflated CG (ops.cg), it brings the
iteration count down to a few dozen independent of mesh size.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np

from . import assembly
from ..utils.validation import checked


@dataclass
class Level:
    """One AMG level (device arrays created lazily)."""

    # Fine operator in ELL form.
    a_cols: np.ndarray
    a_vals: np.ndarray
    a_diag: np.ndarray
    # Prolongation P (n_fine x n_coarse) in ELL rows; restriction is P^T
    # stored as ELL over coarse rows (padded member lists).
    p_cols: Optional[np.ndarray]  # (n, KP)
    p_vals: Optional[np.ndarray]
    r_cols: Optional[np.ndarray]  # (nc, KR) fine indices per coarse row
    r_vals: Optional[np.ndarray]
    omega: float  # damped-Jacobi smoothing weight


@dataclass
class AMGHierarchy:
    levels: list[Level]
    coarse_inv: np.ndarray  # dense inverse of the coarsest operator

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _to_csr(ell: assembly.EllMatrix):
    return ell.to_scipy().tocsr()


def _aggregate(A, theta: float = 0.08) -> tuple[np.ndarray, int]:
    """Greedy aggregation over the strength graph.

    Returns (agg_id per node, num_aggregates).  Strong connection:
    |a_ij| >= theta * sqrt(a_ii * a_jj).  The strength filter is applied
    once up front; the greedy sweep itself touches each node's (short)
    neighbor list with plain array slices.
    """
    import scipy.sparse

    n = A.shape[0]
    d = np.asarray(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    coo = A.tocoo()
    strong = (coo.row != coo.col) & (
        np.abs(coo.data) >= theta * np.sqrt(d[coo.row] * d[coo.col])
    )
    S = scipy.sparse.csr_matrix(
        (np.ones(strong.sum(), dtype=np.int8),
         (coo.row[strong], coo.col[strong])),
        shape=(n, n),
    )
    # Greedy sweep in the native runtime (C++): Python-loop equivalent
    # takes minutes at 1M nodes.
    import ctypes

    from .. import native

    indptr = np.ascontiguousarray(S.indptr.astype(np.int32))
    indices = np.ascontiguousarray(S.indices.astype(np.int32))
    agg32 = np.zeros(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    num_agg = native.lib.pg_greedy_aggregate(
        indptr.ctypes.data_as(i32p),
        indices.ctypes.data_as(i32p),
        n,
        agg32.ctypes.data_as(i32p),
    )
    return agg32.astype(np.int64), int(num_agg)


def _pack_ell(rows, cols_in, vals_in, n, pad_self_col: bool):
    """Vectorized COO (sorted by rows) -> padded ELL."""
    counts = np.bincount(rows, minlength=n)
    K = max(int(counts.max(initial=1)), 1)
    order = np.argsort(rows, kind="stable")
    rows, cols_in, vals_in = rows[order], cols_in[order], vals_in[order]
    slot = np.arange(len(rows)) - np.concatenate([[0], np.cumsum(counts)])[rows]
    if pad_self_col:
        cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
    else:
        cols = np.zeros((n, K), dtype=np.int64)
    vals = np.zeros((n, K), dtype=np.float64)
    cols[rows, slot] = cols_in
    vals[rows, slot] = vals_in
    return cols.astype(np.int32), vals


def _ell_from_csr(A):
    """CSR -> (cols, vals, diag) padded ELL (off-diagonal entries)."""
    coo = A.tocoo()
    diag = np.asarray(A.diagonal(), dtype=np.float64)
    mask = coo.row != coo.col
    cols, vals = _pack_ell(
        coo.row[mask].astype(np.int64), coo.col[mask].astype(np.int64),
        coo.data[mask], A.shape[0], pad_self_col=True,
    )
    return cols, vals, diag


def _ell_matrix(P):
    """CSR rectangular matrix -> padded ELL (padding entries point at
    column 0 with zero value)."""
    coo = P.tocoo()
    return _pack_ell(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
        P.shape[0], pad_self_col=False,
    )


def _lambda_max_dinv_a(A, iters: int = 12, seed: int = 3) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) for a level
    operator (host-side, a dozen CSR SpMVs; the diagonal scaling is
    applied per iteration — no Dinv @ A sparse matmul).  Falls back to
    the Gershgorin-style bound 2.0 on degenerate input."""
    n = A.shape[0]
    if n == 0:
        return 2.0
    d = np.asarray(A.diagonal())
    dinv = 1.0 / np.where(d > 0, d, 1.0)
    x = np.random.default_rng(seed).standard_normal(n)
    for _ in range(iters):
        y = dinv * (A @ x)
        ny = np.linalg.norm(y)
        if not np.isfinite(ny) or ny == 0:
            return 2.0
        x = y / ny
    lam = float(x @ (dinv * (A @ x)))
    if not np.isfinite(lam) or lam <= 0:
        return 2.0
    return lam


@checked
def build_hierarchy(
    ell: assembly.EllMatrix,
    theta: float = 0.08,
    coarse_size: int = 400,
    max_levels: int = 12,
    omega: Optional[float] = None,
    alpha: float = 1.66,
) -> AMGHierarchy:
    """Host-side setup: aggregation + smoothed prolongation + Galerkin
    coarse operators, down to a dense-invertible coarsest level.

    omega: fixed damped-Jacobi weight for both the prolongation smoother
    and the cycle smoother; None (default) estimates lambda_max(D^-1 A)
    per level by power iteration and uses the classical 4/(3*lambda) for
    prolongation smoothing and alpha/lambda (capped at 1.8/lambda, i.e.
    inside the 2/lambda stability bound) for the cycle smoother —
    measured 28 -> 18 PCG iterations at 131k DoF vs a fixed 0.6.
    """
    import scipy.sparse

    levels: list[Level] = []
    A = _to_csr(ell)
    # Fine-level ELL comes straight from the input.
    a_cols, a_vals, a_diag = ell.cols, ell.vals, ell.diag

    def level_omegas(A):
        if omega is not None:
            return omega, omega
        lam = _lambda_max_dinv_a(A)
        return 4.0 / (3.0 * lam), min(alpha, 1.8) / lam

    for _ in range(max_levels):
        n = A.shape[0]
        if n <= coarse_size:
            break
        agg, nc = _aggregate(A, theta)
        if nc >= n or nc == 0:
            break
        p_omega, sm_omega = level_omegas(A)
        P0 = scipy.sparse.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, nc)
        )
        # Smoothed prolongation: P = (I - p_omega D^-1 A) P0.
        d = np.asarray(A.diagonal())
        dinv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
        Dinv = scipy.sparse.diags(dinv)
        P = (P0 - p_omega * (Dinv @ (A @ P0))).tocsr()
        Ac = (P.T @ A @ P).tocsr()
        Ac.eliminate_zeros()

        p_cols, p_vals = _ell_matrix(P)
        r_cols, r_vals = _ell_matrix(P.T.tocsr())
        levels.append(
            Level(
                a_cols=a_cols,
                a_vals=a_vals,
                a_diag=a_diag,
                p_cols=p_cols,
                p_vals=p_vals,
                r_cols=r_cols,
                r_vals=r_vals,
                omega=sm_omega,
            )
        )
        A = Ac
        a_cols, a_vals, a_diag = _ell_from_csr(A)

    # Coarsest level: dense pseudo-inverse (handles the Neumann nullspace).
    Ad = np.asarray(A.todense())
    coarse_inv = np.linalg.pinv(Ad, rcond=1e-12)
    levels.append(
        Level(
            a_cols=a_cols,
            a_vals=a_vals,
            a_diag=a_diag,
            p_cols=None,
            p_vals=None,
            r_cols=None,
            r_vals=None,
            omega=level_omegas(A)[1],
        )
    )
    return AMGHierarchy(levels=levels, coarse_inv=coarse_inv)


# ---------------------------------------------------------------------------
# Aligned (reshape-transfer) hierarchy on the block-offset-DIA operator
# format: every level operator is an ops.dia slab SpMV and every
# transfer is a reshape.
# ---------------------------------------------------------------------------


def _strength_pattern(A, theta: float):
    """(indptr, indices) int32 CSR pattern of the strong-connection
    graph |a_ij| >= theta * sqrt(d_i d_j), diagonal excluded.

    Built by one native CSR pass (pg_strength_csr) — A is row-sorted
    already, so the tocoo + mask + csr_matrix round trip the numpy
    version needed is pure overhead.  Cached by callers across the
    aggregation-cap retry loop (same A, same theta -> same graph)."""
    import ctypes

    from .. import native

    A = A.tocsr()
    n = A.shape[0]
    d = np.asarray(A.diagonal())
    d = np.ascontiguousarray(np.where(d > 0, d, 1.0))
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    out_indptr = np.empty(n + 1, dtype=np.int32)
    out_indices = np.empty(len(indices), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    nnz = native.lib.pg_strength_csr(
        n, indptr.ctypes.data_as(i32p), indices.ctypes.data_as(i32p),
        data.ctypes.data_as(f64p), d.ctypes.data_as(f64p), float(theta),
        out_indptr.ctypes.data_as(i32p), out_indices.ctypes.data_as(i32p),
    )
    return out_indptr, out_indices[:nnz]


def _aggregate_capped(A, cap: int, theta: float = 0.08, strength=None):
    """Greedy aggregation with a hard size cap (native sweep).

    Bounded aggregate sizes let prolongation/restriction become reshape
    + broadcast/sum on device: fine rows are laid out as (aggregate,
    slot) with each aggregate padded to `cap` slots.

    strength: optional prebuilt (indptr, indices) from
    _strength_pattern — reused across the cap retry loop."""
    import ctypes

    from .. import native

    n = A.shape[0]
    indptr, indices = (strength if strength is not None
                       else _strength_pattern(A, theta))
    agg32 = np.zeros(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    nc = native.lib.pg_greedy_aggregate_capped(
        np.ascontiguousarray(indptr).ctypes.data_as(i32p),
        np.ascontiguousarray(indices).ctypes.data_as(i32p),
        n, cap, agg32.ctypes.data_as(i32p),
    )
    return agg32.astype(np.int64), int(nc)


@dataclass
class AlignedLevel:
    """One DIA level: operator pack + damping weights + child geometry."""

    pack: object            # ops.dia.DiaPack
    dinv: np.ndarray        # (np_,) f64, 0 on dummy rows
    omega_p: float          # prolongation-smoothing weight
    omega_s: float          # cycle-smoothing weight
    cap: int                # slots per aggregate at this level
    child_len: int          # padded length of the child level's vectors
    child_perm: np.ndarray  # (nc,) child row -> child padded position
    shard: bool = False     # row-shardable over the tp axis (ops.dia_sharded)
    # Upper bound on spec(D^-1 A) at this level (the 1.1-margin power-
    # iteration estimate) — consumed by the Chebyshev smoother.  0.0
    # means "derive from omega_s" (pre-knob hierarchies).
    lam: float = 0.0


@dataclass
class AlignedHierarchy:
    levels: list[AlignedLevel]
    posmap0: np.ndarray         # (n,) original index -> level-0 position
    np0: int                    # level-0 padded length
    # (npL, npL) dense pseudo-inverse of the padded coarsest operator.
    # May be constructed deferred: a zero-arg callable computing it in a
    # worker thread (LAPACK releases the GIL), joined on first access —
    # the ~seconds-scale bottom eigh then overlaps the level uploads.
    _coarse: object = None
    # Raw bottom operator (scipy sparse) + sizes, for the on-device
    # coarse-inverse build (_device_coarse_inv) — it uploads ~1 MB of
    # COO instead of computing/serializing a dense inverse on the host.
    coarse_sp: object = None
    coarse_nL: int = 0
    coarse_npL: int = 0

    @property
    def coarse_inv(self) -> np.ndarray:
        if callable(self._coarse):
            self._coarse = self._coarse()
        return self._coarse

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1


def _eigh_pinv(Ad: np.ndarray) -> np.ndarray:
    """True pseudo-inverse via syevd (annihilates the Neumann nullspace
    instead of amplifying the f32 noise in it).

    Cut at 1e-6 * lambda_max: the exact nullspace (per-component
    constants) is handled by the CG deflation projector; aggregation/
    dropping can leave NEAR-null junk modes below 1e-6*lambda_max, and
    inverting those turns the preconditioner into a 1e6x amplifier.
    f32 end to end: ssyevd + sgemm run ~2x dsyevd + dgemm, and the kept
    spectrum sits well above f32 eps — preconditioner-grade accuracy.
    Scale to unit |A|_max first so the f32 dynamic range is spent on
    the spectrum shape.  (syevd measured ~8x faster than
    scipy.linalg.pinvh's internal solver at a ~3k bottom.)
    """
    import scipy.linalg

    d_scale = max(float(np.abs(Ad).max()), 1e-300)
    w_eig, V = scipy.linalg.eigh(
        (Ad / d_scale).astype(np.float32), driver="evd",
        check_finite=False)
    lam_max = max(float(w_eig[-1]), 1e-300)
    keep = w_eig > 1e-6 * lam_max
    w_inv = np.where(keep, 1.0 / np.where(keep, w_eig, 1.0),
                     np.float32(0.0)).astype(np.float32)
    w_inv /= np.float32(d_scale)
    return (V * w_inv[None, :]) @ V.T


def _coarse_inv_dense(A_sp, Ad: np.ndarray) -> np.ndarray:
    """Coarse-bottom dense inverse with pseudo-inverse semantics.

    Fast path (~4x fewer flops than the syevd pinv): shift the exact
    structural nullspace out of the way and Cholesky-invert,

        M = A/s + lam_g * Z Z^T,   inv = (M^-1) / s,

    where Z is the orthonormal indicator basis of the connected
    components of the (dropped/lumped) bottom operator — its EXACT
    nullspace, including components split by the drop filter, since
    lumping preserves row sums — and lam_g is the Gershgorin bound on
    the scaled spectrum.  Because range(A) ⊥ null(A) for symmetric A,
    M^-1 acts exactly like the pseudo-inverse on the deflated residuals
    the V-cycle feeds it (the shifted modes get 1/lam_g instead of 0 —
    invisible to component-deflated CG, harmless otherwise).

    Near-null JUNK that is not structural (values-level near-splits the
    graph walk cannot see) would be amplified by the plain inverse, so
    the factorization is validated: a failed/indefinite Cholesky or a
    power-iteration top mode of M^-1 beyond the pinv cut (1e-6 *
    lambda_max) falls back to the syevd pseudo-inverse, which zeroes
    junk exactly like before.
    """
    import logging
    import os

    import scipy.linalg
    import scipy.sparse.csgraph as csgraph
    from scipy.linalg.lapack import dpotrf, dpotri

    if os.environ.get("PADNE_TPU_COARSE_EIGH"):
        return _eigh_pinv(Ad)   # A/B + belt-and-braces escape hatch
    log = logging.getLogger(__name__)
    nL = Ad.shape[0]
    d_scale = max(float(np.abs(Ad).max()), 1e-300)
    As = (Ad / d_scale).astype(np.float64)
    ncomp, labels = csgraph.connected_components(A_sp, directed=False)
    lam_g = max(float(np.abs(As).sum(axis=1).max()), 1e-300)
    M = As.copy()
    for c in range(ncomp):
        idx = np.nonzero(labels == c)[0]
        M[np.ix_(idx, idx)] += lam_g / len(idx)
    cfac, info = dpotrf(M, lower=1, overwrite_a=1, clean=0)
    if info == 0:
        inv, info = dpotri(cfac, lower=1, overwrite_c=1)
    if info != 0:
        log.info("coarse inverse: Cholesky reported junk (info=%d), "
                 "falling back to the syevd pseudo-inverse", info)
        return _eigh_pinv(Ad)
    inv = np.tril(inv)
    inv = inv + inv.T - np.diag(np.diag(inv))
    # Junk check: the dominant mode of M^-1 is 1/eps_min(M); eps_min
    # below the pinv cut means a non-structural near-null mode survived
    # the shift.  lambda_max estimated by a short power iteration on As
    # (Gershgorin can overestimate 2x, which would loosen the cut).
    rng = np.random.default_rng(7)
    v = rng.normal(size=nL)
    for _ in range(20):
        v = inv @ v
        v /= max(float(np.linalg.norm(v)), 1e-300)
    mu_max = float(v @ (inv @ v))
    w = rng.normal(size=nL)
    for _ in range(10):
        w = As @ w
        w /= max(float(np.linalg.norm(w)), 1e-300)
    lam_max = max(float(w @ (As @ w)), 1e-300)
    if mu_max > 1.0 / (1e-6 * lam_max):
        log.info("coarse inverse: near-null junk beyond the structural "
                 "nullspace (1/mu=%.2e < 1e-6*lam=%.2e), falling back "
                 "to the syevd pseudo-inverse", 1.0 / mu_max,
                 1e-6 * lam_max)
        return _eigh_pinv(Ad)
    return (inv / d_scale).astype(np.float32)


@checked
def build_hierarchy_dia(
    ell: assembly.EllMatrix,
    coords: np.ndarray,
    cap: int = 8,
    theta: float = 0.08,
    coarse_size: int = 400,
    max_levels: int = 12,
    alpha: float = 1.66,
    coverage: float = 0.95,
    max_offsets: int = 8,
    smooth_levels: int = 2,
    drop_tol: float = 1e-4,
    tp: int = 1,
    shard_min: int = 32768,
    group: "np.ndarray | None" = None,
    a_csr=None,
    deep_max_offsets: "int | None" = 24,
    deep_coverage: "float | None" = 0.995,
) -> AlignedHierarchy:
    """Gather-free AMG setup.

    Pipeline: Hilbert-order the fine operator (ops.bell.hilbert_order —
    concentrates nonzeros on a few block offsets), then per level:
    capped aggregation -> smoothed prolongation + Galerkin coarse
    operator (host scipy, in aggregate-id order).  Final row orders are
    fixed bottom-up so that each level's rows sit at
    (child position) * cap + slot, padded with inert dummy rows; every
    transfer on device is then a pure reshape.  Dummy rows have zero
    matrix rows/columns and zero dinv, which keeps them exactly inert
    through the cycle (their residual is always zero).
    """
    import os

    import scipy.sparse

    from . import bell, dia

    # a_csr: caller-provided CSR of the same operator (diagonal included)
    # — skips a second multi-second ELL->CSR conversion when the caller
    # already built one (DiaBorderedSolver keeps a host CSR for the f64
    # refinement residuals).
    A = ell.to_scipy() if a_csr is None else a_csr
    n0 = A.shape[0]
    # Group-aware sweep (mesh/layer id as the primary key): stacked
    # layers share the same (x, y) footprint, and a layer-blind sweep
    # interleaves them — measured 475 vs ~75 CG iterations and ~50% vs
    # ~5% off-offset nonzeros on the 4-layer bench board.
    import time as _time0

    _tp0 = _time0.time()
    perm0 = bell.hilbert_order(coords, group=group)
    inv0 = np.empty(n0, dtype=np.int64)
    inv0[perm0] = np.arange(n0)
    _tp1 = _time0.time()
    if A.nnz >= 200_000:
        from padne_tpu import native

        A = native.csr_permute(A, perm0)
    else:
        A = A[perm0][:, perm0].tocsr()
    if os.environ.get("PADNE_TPU_SOLVE_TRACE"):
        import sys as _sys0

        print(f"[solve-trace] hier: hilbert {_tp1 - _tp0:.3f}s, "
              f"permute {_time0.time() - _tp1:.3f}s",
              file=_sys0.stderr, flush=True)
    lvl_group = (np.asarray(group)[perm0] if group is not None else None)

    # One downward pass.  Per level: capped aggregation (adaptive cap so
    # slot padding stays bounded — aggregating with cap 8 at a mean size
    # of 3 would waste 2.6x), row layout (aggregate * cap + slot) padded
    # up to a 1024 multiple, DIA pack at those positions, Galerkin
    # coarse operator in aggregate-id order (which inherits the Hilbert
    # locality: ids are assigned in sweep order).  Levels are padded
    # independently — a zero-pad/slice between levels reconciles
    # Np_l / cap with the child's own padded length, so padding does NOT
    # compound up the chain.
    lvl_coords = coords[perm0]

    import time as _time

    _trace_on = os.environ.get("PADNE_TPU_SOLVE_TRACE")

    def _htr(label, t0):
        if _trace_on:
            import sys as _sys

            print(f"[solve-trace] hier: {label}: "
                  f"{_time.time() - t0:.3f}s", file=_sys.stderr,
                  flush=True)

    levels = []
    all_pos = []        # per level: row index -> padded position
    for level_i in range(max_levels):
        if A.shape[0] <= coarse_size:
            break
        nl = A.shape[0]
        cap_l = cap
        # Deep levels: relax the strength filter.  Galerkin operators a
        # few levels down are denser and more heterogeneous; theta tuned
        # for the fine mesh leaves their strength graph too sparse and
        # stalls coarsening into crude pairwise fallbacks (weak coarse
        # solves cost 2-3x in CG iterations).
        theta_l = theta if level_i < 3 else theta / 4.0
        _t0 = _time.time()
        strength = _strength_pattern(A, theta_l)
        _htr(f"L{level_i} strength (nnz={A.nnz})", _t0)
        _t0 = _time.time()
        agg, nc = _aggregate_capped(A, cap_l, theta_l, strength=strength)
        while cap_l > 2 and nl / nc < 0.7 * cap_l:
            cap_l //= 2
            agg, nc = _aggregate_capped(A, cap_l, theta_l,
                                        strength=strength)
        if nc >= nl or nc == 0:
            break
        if nc > 0.6 * nl:
            # Coarsening stalled (strength filter too sparse on a deep,
            # heterogeneous operator).  Force progress with unfiltered
            # pairwise aggregation — a dense eigensolve at thousands of
            # rows costs tens of seconds of setup, so keep shrinking
            # until coarse_size instead.
            agg, nc = _aggregate_capped(A, 2, theta=0.0)
            cap_l = 2
            if nc >= nl or nc == 0 or nc > 0.8 * nl:
                break

        # Re-Hilbert-order the coarse level by aggregate centroids:
        # aggregate-id order alone degrades into raster-like order a
        # couple of levels down, scattering nonzeros across many block
        # offsets.  Relabel aggregates by their own Hilbert sweep so
        # EVERY level keeps the locality the offsets rely on.
        csum = np.zeros((nc, 2))
        np.add.at(csum, agg, lvl_coords)
        ccnt = np.bincount(agg, minlength=nc).astype(float)
        coords_c = csum / np.maximum(ccnt, 1.0)[:, None]
        # Propagate the group label (any member's — aggregates are
        # group-pure except the rare via-bridged ones, where either
        # label keeps the node near that via's neighborhood).
        group_c = None
        if lvl_group is not None:
            group_c = np.zeros(nc, dtype=lvl_group.dtype)
            group_c[agg] = lvl_group
        hperm = bell.hilbert_order(coords_c, group=group_c)
        hinv = np.empty(nc, dtype=np.int64)
        hinv[hperm] = np.arange(nc)
        agg = hinv[agg]
        coords_c = coords_c[hperm]
        if group_c is not None:
            group_c = group_c[hperm]
        # 10% safety margin on the power-iteration estimate: an
        # underestimated lambda_max would push omega_s past the 2/lambda
        # Jacobi stability bound and turn the V-cycle into an AMPLIFIER
        # (observed as CG divergence on small coarse levels).
        _htr(f"L{level_i} aggregate+reorder", _t0)
        _t0 = _time.time()
        lam = 1.1 * _lambda_max_dinv_a(A, iters=16)
        _htr(f"L{level_i} lambda_max", _t0)
        _t0 = _time.time()
        omega_s = min(alpha, 1.6) / lam
        # Smoothed prolongation densifies the Galerkin operators (each
        # level's stencil grows), which destroys the block-offset
        # structure and stalls capped aggregation a few levels down.
        # Smooth only the top levels — below them plain aggregation
        # keeps every operator as sparse as its parent.
        omega_p = 4.0 / (3.0 * lam) if level_i < smooth_levels else 0.0
        d = np.asarray(A.diagonal())
        dinv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)

        # Padded positions for this level's rows.
        order = np.argsort(agg, kind="stable")
        slot = np.empty(nl, dtype=np.int64)
        counts = np.bincount(agg, minlength=nc)
        starts = np.concatenate([[0], np.cumsum(counts)])
        slot[order] = np.arange(nl) - starts[agg[order]]
        pos = agg * cap_l + slot
        np_l = max(((cap_l * nc + 1023) // 1024) * 1024, 1024)
        # Multi-chip: sharded levels pad to whole grid steps per shard
        # (tp * g * b rows).  Only a prefix of levels shards — once a
        # level is too small (or structurally unshardable), it and every
        # deeper level run replicated (ops.dia_sharded design).
        shard_l = (tp > 1 and cap_l * nc >= max(shard_min, tp * 1024)
                   and (not levels or levels[-1].shard))
        if shard_l:
            np_l = -(-np_l // (tp * 1024)) * (tp * 1024)

        diag_pad = np.zeros(np_l)
        diag_pad[pos] = np.asarray(A.diagonal(), dtype=np.float64)
        # Deeper levels may widen the offset budget: their slabs are
        # small (tens of MB) while their remainder density is the
        # V-cycle's structural weak point (level-1 remainder ~ 0.8
        # entries/row at 1M DoF).  Widening absorbs 35-60% of each deep
        # level's remainder into the linear slab stream for a few extra
        # slab products; level 0's slab dominates device-memory
        # traffic, so its budget stays separate.
        # Sharded hierarchies keep the NARROW deep budget: widening
        # grows dmax and the halo window past the one-neighbor bound
        # that dia_sharded.shardable requires, silently demoting deep
        # levels to replicated execution — worse than the remainder
        # entries the widening would absorb.  (The wide default was a
        # single-device win at the 1M bench; not re-measured on the
        # GPU.)
        widen_deep = level_i > 0 and not shard_l
        mo_l = max_offsets if not widen_deep else (
            deep_max_offsets if deep_max_offsets is not None
            else max_offsets)
        cov_l = coverage if not widen_deep else (
            deep_coverage if deep_coverage is not None else coverage)
        _htr(f"L{level_i} layout", _t0)
        _t0 = _time.time()
        pack = dia.pack_csr_pos_as_dia(
            A, pos, diag=diag_pad, coverage=cov_l,
            max_offsets=mo_l, np_override=np_l,
        )
        _htr(f"L{level_i} pack (nnz={A.nnz})", _t0)
        _t0 = _time.time()
        if shard_l:
            from . import dia_sharded

            shard_l = dia_sharded.shardable(pack, tp)
        if tp == 1 and level_i == 0:
            # Kick the level-0 nnz transfer off NOW — it is the bulk of
            # the device upload and runs async while the deeper levels'
            # host build proceeds.
            pack.start_upload()
        dinv_pad = np.zeros(np_l)
        dinv_pad[pos] = dinv
        all_pos.append(pos)

        # Galerkin coarse operator (aggregate-id order), with the
        # smoothed prolongation built internally and the drop filter
        # fused.  Sparsify semantics: relatively-tiny couplings
        # (|v| < drop_tol * sqrt(dc_i dc_j)) are dropped — preconditioner
        # quality is insensitive, offset structure is not — and the
        # dropped mass is LUMPED into the diagonal so row sums (the
        # Neumann constant-vector kernel) are preserved; plain dropping
        # turns the kernel into near-null modes that the coarse
        # pseudo-inverse then amplifies by 1/drop_tol^2.
        if A.nnz >= 200_000:
            from padne_tpu import native

            Ac = native.galerkin(A, agg, nc, dinv, omega_p, drop_tol)
        else:
            P0 = scipy.sparse.csr_matrix(
                (np.ones(nl), (np.arange(nl), agg)), shape=(nl, nc)
            )
            if omega_p:
                P = (P0
                     - omega_p * (scipy.sparse.diags(dinv) @ (A @ P0))
                     ).tocsr()
            else:
                P = P0
            Ac = (P.T @ A @ P).tocsr()
            Ac.eliminate_zeros()
            if drop_tol:
                dc = np.asarray(Ac.diagonal())
                dc = np.where(dc > 0, dc, 1.0)
                coo_c = Ac.tocoo()
                keep = (coo_c.row == coo_c.col) | (
                    np.abs(coo_c.data)
                    >= drop_tol * np.sqrt(dc[coo_c.row] * dc[coo_c.col])
                )
                lump = np.zeros(Ac.shape[0])
                np.add.at(lump, coo_c.row[~keep], coo_c.data[~keep])
                Ac = scipy.sparse.csr_matrix(
                    (coo_c.data[keep], (coo_c.row[keep], coo_c.col[keep])),
                    shape=Ac.shape,
                )
                Ac = (Ac + scipy.sparse.diags(lump)).tocsr()
        _htr(f"L{level_i} galerkin", _t0)
        levels.append(AlignedLevel(
            pack=pack, dinv=dinv_pad, omega_p=omega_p, omega_s=omega_s,
            cap=cap_l, child_len=0, child_perm=None,   # patched below
            shard=shard_l, lam=lam,
        ))
        A = Ac
        lvl_coords = coords_c
        lvl_group = group_c

    # Coarsest: dense pseudo-inverse-equivalent over the padded size
    # (_coarse_inv_dense: Cholesky fast path + eigh-pinv fallback).
    # Deferred: it runs on a worker thread (LAPACK releases the GIL),
    # joined lazily at AlignedHierarchy.coarse_inv — it overlaps the
    # callers' level-parameter uploads, which touch coarse_inv last.
    nL = A.shape[0]
    npL = max(((nL + 127) // 128) * 128, 128)
    Ad = np.asarray(A.todense())
    A_sp_bottom = A

    def _compute_coarse_inv():
        if nL:
            inv_real = _coarse_inv_dense(A_sp_bottom, Ad)
        else:
            inv_real = np.zeros((0, 0), np.float32)
        # f32 result: preconditioner-grade accuracy; widening would
        # only add a 75 MB page-fault bill at 3k rows.
        ci = np.zeros((npL, npL), np.float32)  # padding rows stay zero
        ci[:nL, :nL] = inv_real
        return ci

    import threading

    _box: list = []

    def _coarse_worker():
        # Capture failures for re-raise at join — a bare thread would
        # swallow them and the consumer would die later with an opaque
        # IndexError on the empty box.
        try:
            _box.append(("ok", _compute_coarse_inv()))
        except BaseException as e:  # noqa: BLE001
            _box.append(("err", e))

    _th = threading.Thread(target=_coarse_worker, daemon=True)
    _th.start()

    def _join_coarse():
        _th.join()
        kind, payload = _box[0]
        if kind == "err":
            raise RuntimeError("coarse-inverse worker failed") \
                from payload
        return payload

    for i, lv in enumerate(levels):
        if i + 1 < len(levels):
            lv.child_len = levels[i + 1].pack.np_
            lv.child_perm = all_pos[i + 1].astype(np.int32)
        else:
            lv.child_len = npL
            lv.child_perm = np.arange(nL, dtype=np.int32)

    if levels:
        posmap0 = all_pos[0][inv0]
        np0 = levels[0].pack.np_
    else:
        posmap0 = inv0
        np0 = npL
    return AlignedHierarchy(
        levels=levels, _coarse=_join_coarse,
        posmap0=posmap0, np0=np0,
        coarse_sp=A_sp_bottom, coarse_nL=nL, coarse_npL=npL,
    )


def make_vcycle_dia(h: AlignedHierarchy, dtype=None,
                    lump_remainder: bool = False,
                    lump_strength: float = 0.05,
                    params: Optional[list] = None,
                    slab_dtype=None, w0=None):
    """(apply, params) for the aligned hierarchy: z = apply(params, r)
    with r, z of shape (np0, R) in level-0 positions.

    Every operator application is an ops.dia matvec and every transfer
    a reshape + sum/broadcast; the cycle does 4 operator
    SpMVs per level and no gathers.  Symmetric V(1,1) with matched
    pre/post damped-Jacobi smoothing, so it is a valid SPD
    preconditioner for CG.

    lump_remainder: fold each level's WEAK off-offset remainder entries
    (|a_ij| < lump_strength * sqrt(a_ii a_jj)) into the diagonal — row
    sums, and with them the Neumann kernel, are preserved.  The
    remainder gather+scatter is costly next to the slab SpMV and a
    preconditioner does not need weak long-range couplings exactly.
    STRONG remainder entries always stay: a via stitching two layers or
    a cut copper edge that gets lumped decouples whole regions inside
    the preconditioner (measured 475-vs-75 CG iterations on the 4-layer
    via-grid board).  Use `make_dia_cg_operator` for the exact level-0
    operator (shares the weight slab with these params).

    params: prebuilt device parameter list (e.g. the sharded builder's)
    — entries for levels this cycle actually visits must have the
    to_device dict structure; skipping the build avoids double-uploading
    multi-GB slabs.

    slab_dtype: store the weight slabs in this dtype (e.g. bf16 —
    preconditioner-only precision, halves the dominant device-memory
    stream; the contraction then runs in that dtype).  w0: reuse an
    already-built level-0 device slab (cast to slab_dtype by the
    caller) instead of scattering a fresh one."""
    import jax.numpy as jnp

    from . import dia

    if params is not None:
        return _finish_vcycle_dia(h, params), params
    import os as _os
    import time as _time

    _trace_on = _os.environ.get("PADNE_TPU_SOLVE_TRACE")

    def _tr(label, t0):
        if _trace_on:
            import sys as _sys

            print(f"[solve-trace] {label}: {_time.time() - t0:.3f}s",
                  file=_sys.stderr, flush=True)

    # Kick the on-device coarse-inverse build (opt-in) NOW on a worker
    # thread: its compile overlaps the per-level parameter uploads
    # below instead of serializing after them.  _upload_coarse_inv
    # joins the box.
    coarse_box = _start_coarse_inv_async(h, dtype)

    # All deep-level slabs in ONE jitted program (one compile and one
    # dispatch instead of one per level).
    deep_ws = None
    if len(h.levels) > 2 and (dtype is None or dtype == jnp.float32):
        _t0 = _time.time()
        deep_ws = dia.build_slabs(
            [(lv.pack, slab_dtype or dtype or None)
             for lv in h.levels[1:]])
        _tr(f"vcycle deep slabs (batched x{len(deep_ws)})", _t0)

    # Batched upload of the per-level aux vectors (child_perm + dinv).
    import jax

    aux = None
    aux_host = None
    if dtype is None or dtype == jnp.float32:
        aux_host = {}
        for i, lv in enumerate(h.levels):
            aux_host[f"cp{i}"] = np.asarray(lv.child_perm)
            aux_host[f"dinv{i}"] = np.asarray(lv.dinv).astype(
                np.float32)

    # Deep-level params + aux in ONE device_put instead of up to
    # nlevels+1 puts.  The lump_remainder variant takes the per-level
    # path (it rewrites the packs per level).
    deep_params = None
    if deep_ws is not None and not lump_remainder and len(h.levels) > 1:
        _t0 = _time.time()
        items = [(lv.pack, deep_ws[i - 1],
                  dict(dtype=dtype, slab_dtype=slab_dtype, slots=0))
                 for i, lv in enumerate(h.levels) if i > 0]
        deep_params, aux_put = dia.to_device_many(items,
                                                  extra_host=aux_host)
        aux = aux_put if aux_host is not None else None
        _tr(f"vcycle deep params (batched x{len(items)})", _t0)
    elif aux_host is not None:
        aux = jax.device_put(aux_host)

    params = []
    for i, lv in enumerate(h.levels):
        _t0 = _time.time()
        # Deep levels ship their slab values in slab_dtype directly
        # (bf16 wire = half the bytes); level 0 reuses/keeps the f32
        # slab the exact CG operator shares.  Slot packing is LEVEL 0
        # ONLY: deep remainders are small, and slot tables on every
        # level would multiply the cycle's gathers.
        w_pre = (w0 if i == 0
                 else deep_ws[i - 1] if deep_ws is not None else None)
        if i > 0 and deep_params is not None:
            entry = deep_params[i - 1]
        else:
            entry = lv.pack.to_device(
                dtype=dtype, w=w_pre,
                slab_dtype=(slab_dtype if i > 0 else None),
                slots=dia.slots_env() if i == 0 else 0)
        if slab_dtype is not None and entry["w"].dtype != slab_dtype:
            entry["w"] = entry["w"].astype(slab_dtype)
        entry["child_perm"] = (aux[f"cp{i}"] if aux is not None
                               else jnp.asarray(lv.child_perm))
        if lump_remainder and len(lv.pack.rem_rows):
            # Strength-SELECTIVE lumping.  A remainder entry may be a
            # weak long-range coupling (drop into the diagonal, row sums
            # preserved) or a strong physical one — a via stitching two
            # layers, a cut copper edge.  Lumping strong entries
            # decouples regions inside the preconditioner: measured 475
            # vs ~75 CG iterations on the 4-layer via-grid board, where
            # blanket lumping severed every inter-layer connection.
            d = lv.pack.diag
            rr, rc = lv.pack.rem_rows, lv.pack.rem_cols
            rv = lv.pack.rem_vals
            strength = np.abs(rv) / np.sqrt(
                np.maximum(d[rr] * d[rc], 1e-300))
            weak = strength < lump_strength
            if weak.any():
                import dataclasses

                diag_l = d.copy()
                np.add.at(diag_l, rr[weak], rv[weak])
                pack_l = dataclasses.replace(
                    lv.pack, rem_rows=rr[~weak], rem_cols=rc[~weak],
                    rem_vals=rv[~weak], diag=diag_l)
                # Rebuild only the remainder buckets + diag; the weight
                # slab is shared with the already-built entry.
                entry_l = pack_l.to_device(
                    dtype=dtype, w=entry["w"],
                    slots=dia.slots_env() if i == 0 else 0)
                entry_l["child_perm"] = entry["child_perm"]
                entry = entry_l
                dinv_l = np.where(
                    diag_l > 0,
                    1.0 / np.where(diag_l > 0, diag_l, 1.0), 0.0)
                entry["dinv"] = jnp.asarray(dinv_l).astype(
                    dtype or jnp.float32)
            else:
                entry["dinv"] = jnp.asarray(lv.dinv).astype(
                    dtype or jnp.float32)
        else:
            entry["dinv"] = (aux[f"dinv{i}"] if aux is not None
                             else jnp.asarray(lv.dinv).astype(
                                 dtype or jnp.float32))
        params.append(entry)
        _tr(f"vcycle level {i} params (np={lv.pack.np_}, "
            f"d={len(lv.pack.offs)})", _t0)
    _t0 = _time.time()
    params.append({"coarse_inv": _upload_coarse_inv(
        h, dtype, prebuilt=coarse_box)})
    _tr("vcycle coarse inverse", _t0)
    return _finish_vcycle_dia(h, params), params


def _device_coarse_inv(h: AlignedHierarchy):
    """Coarse-bottom inverse built ON DEVICE (f32 Newton-Schulz).

    Same construction as _coarse_inv_dense — structural-nullspace shift
    M = A/s + lam_g Z Z^T, Cholesky inverse, power-iteration junk
    validation — but the host only ships the ~1 MB sparse COO (plus
    component labels) instead of computing a multi-GFLOP dense inverse
    single-threaded and uploading tens of MB.  Measured host cost of
    the dense path: seconds of single-threaded LAPACK inside the setup.

    Returns the (npL, npL) f32 device inverse, or None when the
    validation demands the host syevd pseudo-inverse (non-structural
    near-null junk, or a failed f32 factorization)."""
    import logging

    import jax
    import jax.numpy as jnp
    import scipy.sparse.csgraph as csgraph

    log = logging.getLogger(__name__)
    A_sp, nL, npL = h.coarse_sp, h.coarse_nL, h.coarse_npL
    if A_sp is None or nL == 0:
        return None
    coo = A_sp.tocoo()
    if coo.nnz == 0:
        return None
    d_scale = max(float(np.abs(coo.data).max()), 1e-300)
    ncomp, labels = csgraph.connected_components(A_sp, directed=False)
    rowsum = np.asarray(np.abs(A_sp).sum(axis=1)).ravel()
    lam_g = max(float(rowsum.max()) / d_scale, 1e-300)
    sizes = np.bincount(labels, minlength=ncomp).astype(np.float64)
    zcol = np.sqrt(lam_g / sizes[labels]).astype(np.float32)

    rows = jnp.asarray(coo.row.astype(np.int32))
    cols = jnp.asarray(coo.col.astype(np.int32))
    vals = jnp.asarray((coo.data / d_scale).astype(np.float32))
    labels_d = jnp.asarray(labels.astype(np.int32))
    zcol_d = jnp.asarray(zcol)

    @partial(jax.jit, static_argnames=("npl", "nl", "nc"))
    def _build(rows, cols, vals, labels_d, zcol_d, npl: int, nl: int,
               nc: int):
        A0 = jnp.zeros((npl, npl), jnp.float32).at[rows, cols].add(vals)
        idx = jnp.arange(npl)
        # Unit diagonal on padding rows keeps M PD; their inverse
        # block (identity) is masked away below.
        pad_diag = jnp.where(idx >= nl, 1.0, 0.0).astype(jnp.float32)
        Z = jnp.zeros((npl, nc), jnp.float32).at[
            jnp.arange(nl), labels_d].set(zcol_d)
        M = A0 + Z @ Z.T
        M = M.at[idx, idx].add(pad_diag)
        # Newton-Schulz inverse: X <- X + X(I - M X), quadratic once
        # ||I - X0 M|| < 1, which X0 = I/lam_row guarantees for SPD M
        # (Gershgorin).  Pure matmuls instead of a sequential
        # triangular solve.  The smallest shifted eigenvalue sits at the
        # 1e-6*lam junk cut, so ~30 doublings reach it:
        # (1 - 1e-6)^(2^30) ~ 0.
        lam_row = jnp.maximum(jnp.abs(M).sum(axis=1).max(), 1e-30)
        eye = jnp.eye(npl, dtype=jnp.float32)
        hi_p = jax.lax.Precision.HIGHEST

        def ns_body(_, X):
            # The stable X(2I - MX) form: the X - X^2 M variant is
            # algebraically equal only while X and M commute exactly,
            # and f32 roundoff breaks that — measured divergence by
            # iteration ~9 at a kappa~500 bottom.
            T = jnp.matmul(M, X, precision=hi_p)
            return 2.0 * X - jnp.matmul(X, T, precision=hi_p)

        X0 = eye * (1.0 / lam_row)
        inv = jax.lax.fori_loop(0, 30, ns_body, X0)
        # Convergence/PD check: a non-PD or junk-dominated M leaves a
        # large ||I - X M|| (divergence shows up as inf/nan).
        Efin = eye - jnp.matmul(inv, M, precision=hi_p)
        res = jnp.abs(Efin).max()
        ok = jnp.isfinite(res) & (res < 1e-2)
        mask = (idx < nl).astype(jnp.float32)
        inv = inv * mask[:, None] * mask[None, :]

        # Junk validation (host semantics): dominant modes of M^-1 and
        # of the scaled bottom operator by power iteration.
        def pow_iter(mat, v, steps):
            def body(_, v):
                v = jnp.matmul(mat, v, precision=hi_p)
                return v / jnp.maximum(jnp.linalg.norm(v), 1e-30)
            return jax.lax.fori_loop(0, steps, body, v)

        key = jax.random.PRNGKey(7)
        v = jax.random.normal(key, (npl,), jnp.float32) * mask
        v = pow_iter(inv, v, 20)
        mu_max = v @ jnp.matmul(inv, v, precision=hi_p)
        w = jax.random.normal(jax.random.PRNGKey(8), (npl,),
                              jnp.float32) * mask
        w = pow_iter(A0, w, 10)
        lam_max = jnp.maximum(w @ jnp.matmul(A0, w, precision=hi_p),
                              1e-30)
        return inv, ok, mu_max, lam_max

    inv, ok, mu_max, lam_max = _build(rows, cols, vals, labels_d,
                                      zcol_d, npl=npL, nl=nL,
                                      nc=int(ncomp))
    ok = bool(ok)
    mu_max, lam_max = float(mu_max), float(lam_max)
    if not ok:
        log.info("device coarse inverse: f32 Newton-Schulz did not "
                 "converge; host pseudo-inverse")
        return None
    if mu_max > 1.0 / (1e-6 * lam_max):
        log.info("device coarse inverse: near-null junk beyond the "
                 "structural nullspace (1/mu=%.2e < 1e-6*lam=%.2e); "
                 "host pseudo-inverse", 1.0 / mu_max,
                 1e-6 * lam_max)
        return None
    return (inv * jnp.float32(1.0 / d_scale))


def _want_device_coarse(h: AlignedHierarchy, dtype) -> bool:
    """Whether _upload_coarse_inv takes the on-device build path
    (opt-in: PADNE_TPU_DEVICE_COARSE=1)."""
    import os

    import jax.numpy as jnp

    target = dtype or jnp.float32
    return (target == jnp.float32
            and getattr(h, "coarse_sp", None) is not None
            and bool(os.environ.get("PADNE_TPU_DEVICE_COARSE")))


def _start_coarse_inv_async(h: AlignedHierarchy, dtype):
    """Kick the on-device coarse-inverse build on a worker thread;
    returns a join() callable (or None when the device path does not
    apply).  The build's compile overlaps the level-parameter uploads
    it otherwise serializes behind; join() re-raises a failure."""
    import os

    if not _want_device_coarse(h, dtype) or os.environ.get(
            "PADNE_TPU_SYNC_COARSE"):
        return None
    import threading

    box: list = []

    def worker():
        try:
            box.append(("ok", _device_coarse_inv(h)))
        except BaseException as e:  # noqa: BLE001
            box.append(("err", e))

    th = threading.Thread(target=worker, daemon=True)
    th.start()

    def join():
        th.join()
        kind, payload = box[0]
        if kind == "err":
            raise RuntimeError("device coarse inverse failed") \
                from payload
        return payload

    return join


def _upload_coarse_inv(h: AlignedHierarchy, dtype, prebuilt=None):
    """Device coarse inverse, transfer-lean.

    With PADNE_TPU_DEVICE_COARSE=1, f32 requests build the inverse ON
    DEVICE (_device_coarse_inv: ~1 MB COO upload instead of the host
    dense inverse + a 19 MB upload); a failure raises, and only the
    numerical validation (a near-null mode beyond the structural
    nullspace) hands over to the host pseudo-inverse.  The host dense
    path is the default and the only path for exact f64 reference runs.
    Host results cast BEFORE upload; for f32 the wire format is bf16 —
    preconditioner-grade (~0.4% relative) and half the bytes — expanded
    to f32 on device."""
    import jax.numpy as jnp

    target = dtype or jnp.float32
    if _want_device_coarse(h, dtype):
        inv = prebuilt() if prebuilt is not None else _device_coarse_inv(h)
        if inv is not None:
            return inv
    ci = h.coarse_inv
    if target == jnp.float32:
        return jnp.asarray(ci.astype(jnp.bfloat16)).astype(target)
    return jnp.asarray(ci.astype(target))


def _cheb_smooth(mv, dinv, lam, deg, b, x0=None, want_r=True):
    """4th-kind Chebyshev smoother of degree `deg` (the Lottes
    recurrence): error propagator a polynomial in D^-1 A with the
    4th-kind Chebyshev roots on (0, lam].  A polynomial in D^-1 A is
    A-self-adjoint, so using the SAME smoother pre and post keeps the
    V-cycle a valid SPD preconditioner for CG.

    Maintains r = b - A x alongside x (one matvec per degree); the
    final residual is returned for free when want_r (the restriction
    consumes it), skipped otherwise (post-smoothing).
    """
    r = b if x0 is None else b - mv(x0)
    d = (4.0 / (3.0 * lam)) * (dinv * r)
    x = d if x0 is None else x0 + d
    for k in range(2, deg + 1):
        r = r - mv(d)
        d = ((2.0 * k - 3.0) / (2.0 * k + 1.0)) * d \
            + ((8.0 * k - 4.0) / ((2.0 * k + 1.0) * lam)) * (dinv * r)
        x = x + d
    if want_r:
        return x, r - mv(d)
    return x, None


def _cheb_env(var: str) -> int:
    """Chebyshev degree knob: 0/1 = off (damped Jacobi), >=2 = degree."""
    import os

    try:
        return int(os.environ.get(var, "0"))
    except ValueError:
        return 0


def _wcycle_env() -> int:
    """PADNE_TPU_WCYCLE=L: coarse levels 2..L are visited twice per
    cycle (W-shape on the top of the coarse hierarchy; level 1 — the
    widened, largest coarse level — keeps one visit: doubling it costs
    more per cycle than the iterations it saves).  The second visit is
    a stationary re-application of the same symmetric level
    preconditioner (B -> 2B - BAB), so the cycle stays SPD.  Values < 2
    are no-ops.

    Default 0 (plain V-cycle): on the tht_component board the W-cycle
    measured >4x slower on the CPU (the coarse-level preconditioner
    appears over-relaxed there, and 2B - BAB loses definiteness margin
    when BA's spectrum approaches 2).  Its iteration savings at the 1M
    bench are not measured on the GPU."""
    import os

    try:
        return int(os.environ.get("PADNE_TPU_WCYCLE", "0"))
    except ValueError:
        return 0


def _finish_vcycle_dia(h: AlignedHierarchy, params):
    """The jittable V-cycle over a prebuilt parameter list."""
    import jax
    import jax.numpy as jnp

    from . import dia

    metas = [lv.pack.meta for lv in h.levels]
    omegas = [(lv.omega_p, lv.omega_s) for lv in h.levels]
    caps = [lv.cap for lv in h.levels]
    child_lens = [lv.child_len for lv in h.levels]
    ncs = [len(lv.child_perm) for lv in h.levels]
    nlev = len(h.levels)
    lams = [lv.lam if lv.lam else 1.6 / lv.omega_s for lv in h.levels]
    cheb_deep = _cheb_env("PADNE_TPU_CHEB_DEEP")
    w_levels = _wcycle_env()
    hi_p = jax.lax.Precision.HIGHEST

    def cycle(level: int, p, b):
        if level == nlev:
            return jnp.matmul(p[-1]["coarse_inv"], b, precision=hi_p)
        e = p[level]
        meta = metas[level]
        om_p, om_s = omegas[level]
        cap = caps[level]
        nc, clen = ncs[level], child_lens[level]
        r_cols = b.shape[1]

        def mv(x):
            return dia.dia_matvec(meta, e, x)

        dinv = e["dinv"][:, None]
        if cheb_deep >= 2:
            x, r1 = _cheb_smooth(mv, dinv, lams[level], cheb_deep, b)
        else:
            x = om_s * dinv * b
            r1 = b - mv(x)
        # restrict: P^T r1 (om_p == 0 -> plain aggregation, no SpMV)
        t = r1 - om_p * mv(dinv * r1) if om_p else r1
        rc = t.reshape(-1, cap, r_cols).sum(axis=1)
        bc = jnp.zeros((clen, r_cols), rc.dtype).at[
            e["child_perm"]].set(rc[:nc], mode="drop",
                                 unique_indices=True)
        xc_pos = cycle(level + 1, p, bc)
        if 2 <= level + 1 <= w_levels and level + 1 < nlev:
            # W: one extra visit of the coarse level on its residual.
            r2 = bc - dia.dia_matvec(metas[level + 1], p[level + 1],
                                     xc_pos)
            xc_pos = xc_pos + cycle(level + 1, p, r2)
        # prolong: child positions -> aggregate order -> broadcast
        xc = xc_pos[e["child_perm"]]
        pad = t.shape[0] // cap - nc
        if pad:
            xc = jnp.concatenate(
                [xc, jnp.zeros((pad, r_cols), xc.dtype)], axis=0)
        px = jnp.broadcast_to(
            xc[:, None, :], (t.shape[0] // cap, cap, r_cols)
        ).reshape(-1, r_cols)
        x = x + (px - om_p * dinv * mv(px) if om_p else px)
        if cheb_deep >= 2:
            x, _ = _cheb_smooth(mv, dinv, lams[level], cheb_deep, b,
                                x0=x, want_r=False)
        else:
            x = x + om_s * dinv * (b - mv(x))
        return x

    def cycle_t(level: int, p, bt):
        """Transposed-layout recursion: bt, return of shape (R, np_l).

        Same math as `cycle` (float reassociation aside), but every
        level-sized array stays in the packed (R, n) layout — in the
        (n, R) layout each elementwise op and transpose pays a 16x
        lane-padding tax (R=8 of 128 lanes), which made the deep-level
        stack the largest device slice of the production V-cycle.  Only
        aggregate-sized arrays (n_l / cap rows) cross layouts at the
        level boundary, for the child-permutation scatter/gather that
        needs axis-0 addressing."""
        if level == nlev:
            ci = p[-1]["coarse_inv"]
            # ci is symmetric by construction, but use ci.T so the
            # result matches `ci @ b` even if a future coarse builder
            # breaks symmetry.
            return jnp.matmul(bt, ci.T, precision=hi_p)
        e = p[level]
        meta = metas[level]
        om_p, om_s = omegas[level]
        cap = caps[level]
        nc, clen = ncs[level], child_lens[level]
        r_cols = bt.shape[0]
        np_l = meta[0]
        naggs = np_l // cap

        def mv(xt):
            return dia.dia_matvec_t(meta, e, xt)

        dinv = e["dinv"][None, :]
        if cheb_deep >= 2:
            x, r1 = _cheb_smooth(mv, dinv, lams[level], cheb_deep, bt)
        else:
            x = om_s * dinv * bt
            r1 = bt - mv(x)
        t = r1 - om_p * mv(dinv * r1) if om_p else r1
        rc_t = t.reshape(r_cols, naggs, cap).sum(axis=2)   # (R, naggs)
        rc = rc_t.T[:nc]                                   # (nc, R)
        bc = jnp.zeros((clen, r_cols), rc.dtype).at[
            e["child_perm"]].set(rc, mode="drop", unique_indices=True)
        xc = cycle_t(level + 1, p, bc.T)                   # (R, clen)
        if 2 <= level + 1 <= w_levels and level + 1 < nlev:
            r2 = bc.T - dia.dia_matvec_t(
                metas[level + 1], p[level + 1], xc)
            xc = xc + cycle_t(level + 1, p, r2)
        xct = xc.T[e["child_perm"]].T                      # (R, nc)
        pad = naggs - nc
        if pad:
            xct = jnp.pad(xct, ((0, 0), (0, pad)))
        px = jnp.broadcast_to(
            xct[:, :, None], (r_cols, naggs, cap)).reshape(r_cols, np_l)
        x = x + (px - om_p * dinv * mv(px) if om_p else px)
        if cheb_deep >= 2:
            x, _ = _cheb_smooth(mv, dinv, lams[level], cheb_deep, bt,
                                x0=x, want_r=False)
        else:
            x = x + om_s * dinv * (bt - mv(x))
        return x

    def apply(p, r):
        return cycle(0, p, r)

    apply.cycle = cycle   # entry point at any level (used by the
    # transposed wrapper, which handles level 0 itself)
    apply.cycle_t = cycle_t
    return apply


def make_vcycle_dia_t(h: AlignedHierarchy, dtype=None,
                      lump_smoothing: bool = True,
                      lump_strength: float = 0.05,
                      slab_dtype=None, w0=None):
    """Transposed-layout V-cycle: z = apply(params, rt) on (R, np0).

    Level 0 — where ~85% of the cycle's work lives — runs in the (R, n)
    layout of the CG state (no transposes around the slab
    contraction).  Deeper levels are small and
    reuse the normal-layout cycle via a cheap transpose at the level
    boundary.

    lump_smoothing: the level-0 prolongation/restriction smoothing
    applications use a remainder-lumped operator (the remainder
    gather+scatter is costly next to the slab SpMV; the residual and
    post-smoothing keep the exact operator, so the coarse grid still
    sees exact residuals and the cycle stays symmetric — the smoothed
    transfer pair P/P^T remains an exact transpose pair).  Lumping is
    strength-SELECTIVE: only entries with
    |a_ij| < lump_strength * sqrt(a_ii a_jj) fold into the diagonal;
    strong off-offset couplings (via stitches between layers, cut
    copper edges) stay in the smoothing operator — folding those
    decouples regions and was measured at 475-vs-75 CG iterations on
    the 4-layer via-grid bench board."""
    import jax.numpy as jnp

    from . import dia

    apply_n, params = make_vcycle_dia(
        h, dtype=dtype, lump_remainder=False, slab_dtype=slab_dtype,
        w0=w0)
    lv0 = h.levels[0]
    e0 = params[0]
    lump = False
    if lump_smoothing and len(lv0.pack.rem_rows):
        # The lumped (D~, A~) pair is used ONLY inside the transfer
        # smoothing sandwich (PSD for any operator pair there).  The
        # pre/post smoother must keep the EXACT (D, A) pair: mixing the
        # smaller lumped diagonal with the exact operator violates
        # 2D - omega*A > 0 and turns M indefinite (observed: CG
        # divergence).
        d = lv0.pack.diag
        rr, rc = lv0.pack.rem_rows, lv0.pack.rem_cols
        rv = lv0.pack.rem_vals
        strength = np.abs(rv) / np.sqrt(np.maximum(d[rr] * d[rc], 1e-300))
        weak = strength < lump_strength
        if weak.any():
            import dataclasses

            lump = True
            diag_sm = d.copy()
            np.add.at(diag_sm, rr[weak], rv[weak])
            pack_sm = dataclasses.replace(
                lv0.pack, rem_rows=rr[~weak], rem_cols=rc[~weak],
                rem_vals=rv[~weak], diag=diag_sm)
            # Strong-remainder smoothing params; the weight slab is the
            # SAME device buffer as the exact operator's.
            e0["sm"] = pack_sm.to_device(dtype=dtype, w=e0["w"],
                                         slots=dia.slots_env())
            dinv_sm = np.where(
                diag_sm > 0,
                1.0 / np.where(diag_sm > 0, diag_sm, 1.0), 0.0)
            e0["sm"]["dinv"] = jnp.asarray(dinv_sm).astype(
                dtype or jnp.float32)

    meta0 = lv0.pack.meta
    om_p, om_s = lv0.omega_p, lv0.omega_s
    cap0 = lv0.cap
    nc0, clen0 = len(lv0.child_perm), lv0.child_len
    np0 = lv0.pack.np_

    # Fully lumped V-cycle (default ON; PADNE_TPU_CYCLE_LUMPED=0
    # restores the exact-operator cycle): use the strength-lumped
    # operator for EVERY level-0 application in the cycle (pre/post
    # smoothing and the coarse-grid residual, not just the transfer
    # sandwich).  The cycle then is the exact AMG preconditioner of the
    # lumped operator A~ — symmetric positive definite by construction
    # (consistent smoother/operator pair, transpose transfers), just
    # preconditioning A slightly less sharply.  Saves two
    # full-remainder gather/scatter passes per V-cycle at the price of
    # a few more CG iterations (+3 at the 1M bench).
    import os

    cycle_lumped = os.environ.get("PADNE_TPU_CYCLE_LUMPED", "1") != "0"
    # Deep levels in transposed layout (default ON): the (n_l, R)
    # normal-layout deep stack pays two full-size relayout transposes
    # per matvec; PADNE_TPU_DEEP_T=0 restores the normal-layout tail
    # for A/B.
    deep_t = os.environ.get("PADNE_TPU_DEEP_T", "1") != "0"
    # V(s,s) level-0 smoothing count (PADNE_TPU_SMOOTH_STEPS, default
    # 1): extra damped-Jacobi steps on BOTH sides keep the cycle
    # symmetric; each costs one lumped L0 matvec per side.
    smooth_steps = max(
        1, int(os.environ.get("PADNE_TPU_SMOOTH_STEPS", "1")))
    # Level-0 Chebyshev smoothing (PADNE_TPU_CHEB=K, K>=2): replaces
    # the damped-Jacobi pre/post steps with a degree-K 4th-kind
    # Chebyshev polynomial (see _cheb_smooth) — K matvecs per side
    # instead of 1, buying much stronger damping of the upper half of
    # the spectrum per cycle.
    cheb0 = _cheb_env("PADNE_TPU_CHEB")
    lam0 = lv0.lam if lv0.lam else 1.6 / om_s

    def apply_t(p, bt):
        e = p[0]
        r_cols = bt.shape[0]

        def mv_exact(xt):
            return dia.dia_matvec_t(meta0, e, xt)

        if lump:
            def mv_sm(xt):
                return dia.dia_matvec_t(meta0, e["sm"], xt)
        else:
            mv_sm = mv_exact

        mv = mv_sm if (cycle_lumped and lump) else mv_exact
        dinv_ex = e["dinv"][None, :]
        dinv_sm = e["sm"]["dinv"][None, :] if lump else dinv_ex
        dinv = dinv_sm if (cycle_lumped and lump) else dinv_ex
        if cheb0 >= 2:
            x, r1 = _cheb_smooth(mv, dinv, lam0, cheb0, bt)
        else:
            x = om_s * dinv * bt
            for _ in range(smooth_steps - 1):
                x = x + om_s * dinv * (bt - mv(x))
            r1 = bt - mv(x)
        t = r1 - om_p * mv_sm(dinv_sm * r1) if om_p else r1
        rc_t = t.reshape(r_cols, np0 // cap0, cap0).sum(axis=2)
        rc = rc_t.T[:nc0]                                # (nc, R)
        bc = jnp.zeros((clen0, r_cols), rc.dtype).at[
            p[0]["child_perm"]].set(rc, mode="drop", unique_indices=True)
        if deep_t:
            xc = apply_n.cycle_t(1, p, bc.T).T
        else:
            xc = apply_n.cycle(1, p, bc)
        xcb = xc[p[0]["child_perm"]]                     # (nc, R)
        pad = np0 // cap0 - nc0
        xct = xcb.T
        if pad:
            xct = jnp.pad(xct, ((0, 0), (0, pad)))
        px = jnp.broadcast_to(
            xct[:, :, None], (r_cols, np0 // cap0, cap0)
        ).reshape(r_cols, np0)
        x = x + (px - om_p * dinv_sm * mv_sm(px) if om_p else px)
        if cheb0 >= 2:
            x, _ = _cheb_smooth(mv, dinv, lam0, cheb0, bt,
                                x0=x, want_r=False)
        else:
            x = x + om_s * dinv * (bt - mv(x))
            for _ in range(smooth_steps - 1):
                x = x + om_s * dinv * (bt - mv(x))
        return x

    return apply_t, params


def make_vcycle_dia_sharded(h: AlignedHierarchy, mesh, axis_name: str = "tp",
                            dtype=None):
    """Multi-chip V-cycle: the sharded-prefix levels run row-sharded over
    `axis_name` (ops.dia_sharded: ppermute halos, compressed far
    exchange), the replicated tail reuses the normal-layout cycle.

    Returns (apply_local, params, specs, n_sharded, plans):

    * apply_local(params, rt) operates on the LOCAL transposed shard
      (R, np0 / tp) and must run inside shard_map over `axis_name`;
    * params — device parameter list (sharded levels' slabs built on
      their target devices, replicated tail on the default device);
    * specs — the matching PartitionSpec pytree for shard_map in_specs;
    * n_sharded — how many levels (from the top) are sharded;
    * plans — per-level ops.dia_sharded.ShardPlan (None when replicated),
      e.g. for binding the level-0 CG matvec.

    Level transfers: within the sharded prefix, restriction all-gathers
    the (R, n_l / cap) aggregate residual (small: cap-fold reduced) and
    each child shard slices its rows; the boundary into the replicated
    tail computes the child RHS replicated.  Prolongation mirrors it.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from . import dia, dia_sharded

    tp = int(mesh.shape[axis_name])
    n_sh = 0
    while n_sh < len(h.levels) and h.levels[n_sh].shard:
        n_sh += 1
    if n_sh == 0:
        raise ValueError(
            "hierarchy has no shardable levels (build_hierarchy_dia with "
            "tp= and a reachable shard_min)"
        )

    rep = P()
    params, specs, plans = [], [], []
    for i, lv in enumerate(h.levels):
        if i < n_sh:
            plan = dia_sharded.plan_shards(lv.pack, tp)
            e = dia_sharded.upload_sharded(
                lv.pack, plan, mesh, axis_name, dtype=dtype)
            sp = dia_sharded.param_specs(axis_name)
            e["dinv"] = jax.device_put(
                jnp.asarray(lv.dinv), NamedSharding(mesh, P(axis_name))
            ).astype(dtype or jnp.float32)
            sp["dinv"] = P(axis_name)
            plans.append(plan)
        else:
            e = lv.pack.to_device(dtype=dtype)
            e["dinv"] = jnp.asarray(lv.dinv).astype(dtype or jnp.float32)
            sp = {k: rep for k in e} | {"child_perm": rep}
            plans.append(None)
        e["child_perm"] = jnp.asarray(lv.child_perm)
        if i < n_sh:
            sp["child_perm"] = rep
        params.append(e)
        specs.append(sp)
    params.append({"coarse_inv": _upload_coarse_inv(h, dtype)})
    specs.append({"coarse_inv": rep})

    apply_n = _finish_vcycle_dia(h, params)
    metas = [lv.pack.meta for lv in h.levels]
    nlev = len(h.levels)
    w_levels = _wcycle_env()   # same W-shape as the serial cycle, so
    # sharded-vs-serial parity holds under any PADNE_TPU_WCYCLE value

    def cyc(level: int, p, bt):
        lv = h.levels[level]
        e = p[level]
        om_p, om_s = lv.omega_p, lv.omega_s
        cap = lv.cap
        nc, clen = len(lv.child_perm), lv.child_len
        np_l = lv.pack.np_
        np_local = np_l // tp
        aggs_local = np_local // cap
        r_cols = bt.shape[0]
        plan_meta = plans[level].meta_local

        def mv(xt):
            return dia_sharded.dia_matvec_t_local(
                metas[level], plan_meta, e, xt, axis_name)

        dinv = e["dinv"][None, :]
        x = om_s * dinv * bt
        r1 = bt - mv(x)
        t = r1 - om_p * mv(dinv * r1) if om_p else r1
        rc_l = t.reshape(r_cols, aggs_local, cap).sum(axis=2)
        rc_full = jax.lax.all_gather(
            rc_l, axis_name, axis=1, tiled=True)          # (R, np_l/cap)
        bc = jnp.zeros((clen, r_cols), rc_full.dtype).at[
            e["child_perm"]].set(rc_full.T[:nc], mode="drop",
                                 unique_indices=True)
        if level + 1 < n_sh:
            clen_local = clen // tp
            idx = jax.lax.axis_index(axis_name)
            bc_l = jax.lax.dynamic_slice(
                bc, (idx * clen_local, jnp.int32(0)),
                (clen_local, r_cols))
            xc_l = cyc(level + 1, p, bc_l.T)
            if 2 <= level + 1 <= w_levels and level + 1 < nlev:
                r2_l = bc_l.T - dia_sharded.dia_matvec_t_local(
                    metas[level + 1], plans[level + 1].meta_local,
                    p[level + 1], xc_l, axis_name)
                xc_l = xc_l + cyc(level + 1, p, r2_l)
            xc = jax.lax.all_gather(
                xc_l, axis_name, axis=1, tiled=True).T     # (clen, R)
        else:
            # Replicated tail: every shard runs the identical sub-cycle,
            # honouring the same PADNE_TPU_DEEP_T A/B gate as the
            # single-chip cycle so layout comparisons stay apples-to-
            # apples across 1-chip and sharded runs.
            import os

            if os.environ.get("PADNE_TPU_DEEP_T", "1") != "0":
                xc = apply_n.cycle_t(level + 1, p, bc.T).T
            else:
                xc = apply_n.cycle(level + 1, p, bc)
            if 2 <= level + 1 <= w_levels and level + 1 < nlev:
                # Replicated second visit (matches the serial W shape).
                r2 = bc - dia.dia_matvec(metas[level + 1], p[level + 1],
                                         xc)
                if os.environ.get("PADNE_TPU_DEEP_T", "1") != "0":
                    xc = xc + apply_n.cycle_t(level + 1, p, r2.T).T
                else:
                    xc = xc + apply_n.cycle(level + 1, p, r2)
        xcb = xc[e["child_perm"]]                          # (nc, R)
        pad = np_l // cap - nc
        if pad:
            xcb = jnp.concatenate(
                [xcb, jnp.zeros((pad, r_cols), xcb.dtype)], axis=0)
        idx = jax.lax.axis_index(axis_name)
        xcb_l = jax.lax.dynamic_slice(
            xcb, (idx * aggs_local, jnp.int32(0)),
            (aggs_local, r_cols))
        px = jnp.broadcast_to(
            xcb_l.T[:, :, None], (r_cols, aggs_local, cap)
        ).reshape(r_cols, np_local)
        x = x + (px - om_p * dinv * mv(px) if om_p else px)
        x = x + om_s * dinv * (bt - mv(x))
        return x

    def apply_local(p, rt):
        return cyc(0, p, rt)

    return apply_local, params, specs, n_sh, plans


def make_dia_cg_operator(h: AlignedHierarchy, vparams=None, dtype=None,
                         keep_widx: bool = False,
                         slots: Optional[int] = None):
    """Exact level-0 operator params for the CG matvec, sharing the
    (multi-GB) weight slab with the V-cycle params — only the exact
    diagonal and the remainder arrays are fresh device arrays.

    vparams=None (or a V-cycle holding reduced-precision slabs) builds
    a fresh full-precision slab instead; pass its "w" back into
    make_vcycle_dia* via w0= to avoid a second nnz upload.

    keep_widx: retain the device widx split in the params (consumed by
    the f64 anchor and the compensated operator, ops.comp; only
    possible when the slab is built here, not reused).

    slots: per-row-block extra-slot count; None picks the default
    policy — slots OFF when keep_widx (the f64 anchor widens the FULL
    remainder buckets).  The compensated operator takes the raw
    remainder from the host pack, so comp callers pass
    slots=dia.slots_env() explicitly to keep the fast CG matvec."""
    import jax.numpy as jnp

    from . import dia

    lv = h.levels[0]
    dtype = dtype or jnp.float32
    w = vparams[0]["w"] if vparams is not None else None
    if w is not None and w.dtype != dtype:
        # The V-cycle may hold reduced-precision slabs; the CG matvec
        # must stay exact, so build a full-precision slab.
        w = None
    keep = keep_widx and w is None
    if slots is None:
        slots = 0 if keep else dia.slots_env()
    return lv.pack.to_device(dtype=dtype, w=w, keep_widx=keep,
                             slots=slots)


def _pad_rows(a: np.ndarray, multiple: int) -> np.ndarray:
    """Pad axis 0 up to a multiple with inert entries (zero values /
    column index 0, which gathered vectors always contain)."""
    pad = (-a.shape[0]) % multiple
    if pad == 0:
        return a
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, widths, constant_values=0)


def make_vcycle(h: AMGHierarchy, dtype=None, tp: int = 1,
                axis_name: Optional[str] = None):
    """Returns (apply, params): a jittable z = apply(params, r) V(1,1)
    cycle plus its parameter pytree of device arrays.

    The level arrays are returned as an explicit pytree rather than
    closure captures so they enter jitted programs as XLA *parameters*;
    closure-captured megabyte arrays get inlined into the HLO as
    constants, which breaks/slows compilation at large n.  Every step is
    an ELL SpMV / elementwise op; the cycle is symmetric (same damped-
    Jacobi pre/post smoothing), preserving SPD for use inside CG.

    Multi-chip (tp > 1, axis_name set): every level's rows are padded to
    a multiple of tp and the returned `apply` is written for use inside
    shard_map over `axis_name` — each SpMV all-gathers the level vector,
    padding rows are inert (zero values, zero diagonal), and the dense
    coarsest solve runs replicated on the gathered residual.  Padded
    rows of every vector stay exactly zero through the cycle.
    """
    import jax
    import jax.numpy as jnp

    from .spmv import collectives

    if (tp > 1) != (axis_name is not None):
        raise ValueError("tp > 1 requires axis_name (and vice versa)")
    gather, _ = collectives(axis_name)

    def prep(a):
        return _pad_rows(a, tp) if tp > 1 else a

    params = []
    for lv in h.levels:
        entry = {
            "a_cols": jnp.asarray(prep(lv.a_cols)),
            "a_vals": jnp.asarray(prep(lv.a_vals), dtype=dtype),
            "a_diag": jnp.asarray(prep(lv.a_diag), dtype=dtype),
        }
        if lv.p_cols is not None:
            entry["p_cols"] = jnp.asarray(prep(lv.p_cols))
            entry["p_vals"] = jnp.asarray(prep(lv.p_vals), dtype=dtype)
            entry["r_cols"] = jnp.asarray(prep(lv.r_cols))
            entry["r_vals"] = jnp.asarray(prep(lv.r_vals), dtype=dtype)
        params.append(entry)
    params.append({"coarse_inv": jnp.asarray(h.coarse_inv, dtype=dtype)})
    omegas = [lv.omega for lv in h.levels]  # static floats

    def rect_matvec(cols, vals, x):
        """y[i] = sum_k vals[i,k] * x[cols[i,k]] (rectangular ELL; x is
        gathered to full length first in sharded mode)."""
        return jnp.einsum("nk,nkr->nr", vals, gather(x)[cols],
                          precision=jax.lax.Precision.HIGHEST)

    def a_matvec(entry, x):
        off = rect_matvec(entry["a_cols"], entry["a_vals"], x)
        return entry["a_diag"][:, None] * x + off

    def dinv_of(entry):
        d = entry["a_diag"]
        return jnp.where(d > 0, 1.0 / jnp.where(d > 0, d, 1.0), 0.0)

    def smooth(entry, omega, x, b):
        r = b - a_matvec(entry, x)
        return x + omega * dinv_of(entry)[:, None] * r

    def coarse_solve(cinv, b):
        hi_p = jax.lax.Precision.HIGHEST
        if axis_name is None:
            return jnp.matmul(cinv, b, precision=hi_p)
        nc = cinv.shape[0]
        bf = gather(b)                    # (nc_pad, R) replicated
        xr = jnp.matmul(cinv, bf[:nc], precision=hi_p)   # (nc, R)
        ln = b.shape[0]                   # local rows (static)
        pad = ln * tp - nc
        if pad:
            xr = jnp.concatenate(
                [xr, jnp.zeros((pad, xr.shape[1]), xr.dtype)], axis=0
            )
        idx = jax.lax.axis_index(axis_name)
        return jax.lax.dynamic_slice_in_dim(xr, idx * ln, ln, axis=0)

    num_levels = len(h.levels)

    def cycle(level: int, p, b):
        entry = p[level]
        if level == num_levels - 1:
            return coarse_solve(p[-1]["coarse_inv"], b)
        omega = omegas[level]
        # Pre-smooth from a zero guess needs no SpMV: x = omega D^-1 b.
        x = omega * dinv_of(entry)[:, None] * b
        r = b - a_matvec(entry, x)
        rc = rect_matvec(entry["r_cols"], entry["r_vals"], r)
        xc = cycle(level + 1, p, rc)
        x = x + rect_matvec(entry["p_cols"], entry["p_vals"], xc)
        return smooth(entry, omega, x, b)

    def apply(p, r):
        return cycle(0, p, r)

    return apply, params

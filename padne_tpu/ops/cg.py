"""Batched multi-RHS preconditioned conjugate gradients with deflation.

Solves A X = B for an SPSD graph Laplacian A in ELL form, for R
right-hand sides simultaneously (vectorized CG: each column keeps its own
alpha/beta but every iteration shares the one multi-RHS SpMV — the
device replacement for the reference's direct SuperLU factorization,
solver.py:767-780).  The operator's index traffic is shared by all R
columns, so multi-RHS batching amortizes it.

A is singular with nullspace = per-component constants; the solver works
in the orthogonal complement by projecting the RHS, the preconditioned
residual, and (periodically) the iterates — yielding the pseudo-inverse
action A^+ B.  The preconditioner is pluggable: Jacobi by default, or an
AMG V-cycle (ops.amg) for mesh-size-independent convergence.

Multi-chip: pass ``mesh`` (a jax.sharding.Mesh with a "tp" axis) to run
the same algorithm tensor-parallel — rows of the operator and all CG
state are sharded over the axis via shard_map; each SpMV all-gathers the
search direction and every inner product is a psum.  The serial
and sharded paths share one implementation, differentiated only by the
(gather, global-sum) collective pair.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .spmv import collectives as _collectives

# Every f32 contraction of the CG operator and the deflation projector
# asks for full f32 products (a GPU may otherwise run them in TF32).
_HIGHEST = jax.lax.Precision.HIGHEST


class CGResult(NamedTuple):
    x: jnp.ndarray           # (N, R)
    iterations: jnp.ndarray  # scalar int
    residual_norms: jnp.ndarray  # (R,) final ||b - A x|| per column


def make_projector(comp_id: jnp.ndarray, num_components: int, gsum=None):
    """Orthogonal projector onto the complement of per-component constant
    vectors: x <- x - mean_of_component(x).

    For few components this is dense one-hot matmuls (f32 at
    Precision.HIGHEST, so the means stay exact f32 on every backend)
    instead of scatters.  Beyond a few dozen components the (n, p) one-hot becomes accidentally quadratic
    (heavily eroded boards fragment into thousands of islands), so a
    segment_sum/gather formulation takes over.  With `gsum` (sharded
    mode) the component sums/counts are completed across the row shards.
    """
    if num_components == 1 and gsum is None:
        def project(x):
            return x - jnp.mean(x, axis=0, keepdims=True)

        return project

    gsum = gsum or (lambda v: v)

    if num_components > 64:
        ones = jnp.ones(comp_id.shape[0], dtype=jnp.float64)
        counts = gsum(
            jax.ops.segment_sum(ones, comp_id, num_segments=num_components)
        )
        counts = jnp.maximum(counts, 1.0)  # empty ids on other shards

        def project(x):
            sums = gsum(jax.ops.segment_sum(
                x, comp_id, num_segments=num_components
            ))                                # (p, R)
            means = (sums / counts[:, None].astype(x.dtype)).astype(x.dtype)
            return x - means[comp_id]

        return project

    # One-hot held in f32 (exact 0/1 values) and cast to the iterate's
    # dtype at use: keeps f32 CG state in f32 under jax_enable_x64 while
    # staying exact for f64 solves.
    onehot = jax.nn.one_hot(comp_id, num_components, dtype=jnp.float32)
    counts = jnp.maximum(gsum(onehot.sum(axis=0).astype(jnp.float64)), 1.0)

    def project(x):
        oh = onehot.astype(x.dtype)
        sums = gsum(jnp.matmul(oh.T, x, precision=_HIGHEST))    # (p, R)
        means = (sums / counts[:, None].astype(x.dtype)).astype(x.dtype)
        return x - jnp.matmul(oh, means, precision=_HIGHEST)

    return project


def _tree_specs(params, axis_name: str):
    """PartitionSpecs for a preconditioner parameter pytree: row-sharded
    by default; dense replicated blocks are recognized by key name."""
    from jax.sharding import PartitionSpec as P

    specs = []
    for entry in params:
        specs.append({
            k: (P(None, None) if k == "coarse_inv"
                else P(axis_name, None) if v.ndim == 2
                else P(axis_name))
            for k, v in entry.items()
        })
    return specs


def make_pcg(
    cols: jnp.ndarray,
    vals: jnp.ndarray,
    diag: jnp.ndarray,
    comp_id: jnp.ndarray,
    num_components: int,
    precond: Optional[tuple] = None,
    mesh=None,
    axis_name: str = "tp",
    operator: Optional[tuple] = None,
    stall_window: Optional[int] = None,
):
    """Build a jitted deflated-PCG solver bound to one operator.

    precond: (apply, params) pair where z = apply(params, r) on (N, R)
    arrays — e.g. ops.amg.make_vcycle's return value; None selects
    Jacobi.  All large arrays (operator, preconditioner levels) are
    threaded through the jitted program as explicit XLA parameters, not
    closure constants, so compilation stays cheap at millions of rows.

    mesh: a jax.sharding.Mesh containing `axis_name`; when given, the
    solve runs row-sharded over that axis (N must be a multiple of the
    axis size — see parallel.sharding.pad_rows / schur's padding).  A
    sharded preconditioner must have been built with the same axis (see
    amg.make_vcycle's tp/axis_name arguments).

    operator: optional (apply, params) pair replacing the default ELL
    gather matvec — y = apply(params, x) on (N, R) arrays, e.g. the
    block-offset-DIA SpMV (ops.dia).  When given, `cols/vals/diag` are
    ignored for the matvec (pass the operator's diagonal as `diag` so
    the Jacobi fallback preconditioner still works) and `mesh` must be
    None (the DIA kernel is single-device; TP uses the ELL path).

    stall_window: exit once no column has improved 3% in this many
    iterations.  ONLY safe when an outer refinement loop multiplies
    partial gains AND the inner solve has a precision floor below the
    requested tol (the mixed f32 case, where columns pinned at the
    recurrence noise floor would otherwise spin to maxiter).  In a
    full-precision single-level solve CG routinely plateaus for longer
    than any reasonable window before converging — leave it None there
    (measured: a 30-iteration window turns a 5.7e-14 scipy-parity
    solve into a 2.2e-2 error on the resistor-divider fixture).

    Returns solve(b, tol, maxiter) -> CGResult.
    """
    ax = axis_name if mesh is not None else None
    if operator is not None and mesh is not None:
        raise ValueError("custom operator does not support mesh sharding")
    if precond is None:
        if operator is not None and not (
            isinstance(operator[1], dict) and "diag" in operator[1]
        ):
            raise ValueError(
                "Jacobi fallback needs the operator's diagonal: pass "
                "precond=, or an operator params dict with a 'diag' key"
            )

        def apply_m(op, r):
            dg = op[0]["diag"] if operator is not None else op[0][2]
            minv = jnp.where(dg > 0, 1.0 / jnp.where(dg > 0, dg, 1.0), 1.0)
            return minv[:, None] * r
        precond_params = None
    else:
        precond_fn, precond_params = precond

        def apply_m(op, r):
            return precond_fn(op[1], r)

    def make_body(maxiter: int, state_in: bool, state_out: bool):
        """CG body with an all-array signature (shard_map-friendly);
        maxiter is baked in as a static.

        state_in/state_out thread the Krylov state (x, r, z, p, rz) in
        and out, so a long solve can be split into bounded-length device
        dispatches that are mathematically ONE uninterrupted CG run."""

        def body(op, comp_id, b, tol, *maybe_state):
            a_params, _ = op
            gather, gsum = _collectives(ax)

            if operator is not None:
                a_apply = operator[0]

                def matvec(x):
                    return a_apply(a_params, x)
            else:
                def matvec(x):
                    cols, vals, diag = a_params
                    xf = gather(x)
                    off = jnp.einsum("nk,nkr->nr", vals, xf[cols],
                                     precision=_HIGHEST)
                    return diag[:, None] * x + off

            def dot(a, b2):
                return gsum((a * b2).sum(axis=0))  # (R,)

            def norm(a):
                return jnp.sqrt(dot(a, a))

            project = make_projector(
                comp_id, num_components, gsum=gsum if ax else None
            )
            b = project(b)
            bnorm = norm(b)
            target = tol * jnp.maximum(bnorm, 1e-300)

            if state_in:
                (x0, r0, z0, p0, rz0, best0, stall0) = maybe_state[0]
            else:
                x0 = jnp.zeros_like(b)
                r0 = b
                z0 = project(apply_m(op, r0))
                p0 = z0
                rz0 = dot(r0, z0)
                best0 = norm(r0)
                stall0 = jnp.zeros_like(best0, dtype=jnp.int32)

            # Stall exit (opt-in, see docstring).  Window 2^31-2 ==
            # disabled: the counter can never reach it before maxiter.
            STALL_WINDOW = (2**31 - 2 if stall_window is None
                            else stall_window)

            def cond(state):
                _, r, _, _, k, _, _, stall = state
                active = norm(r) > target
                return jnp.logical_and(
                    k < maxiter,
                    jnp.any(active & (stall < STALL_WINDOW)),
                )

            def loop_body(state):
                x, r, z, p, k, rz, best, stall = state
                active = norm(r) > target  # (R,)
                ap = matvec(p)
                pap = dot(p, ap)
                alpha = jnp.where(
                    pap > 0, rz / jnp.where(pap > 0, pap, 1.0), 0.0
                )
                alpha = jnp.where(active, alpha, 0.0)
                x = x + alpha[None, :] * p
                r = r - alpha[None, :] * ap
                # Periodic re-projection kills numerical drift into the
                # nullspace.
                r = jax.lax.cond(k % 50 == 49, project, lambda v: v, r)
                z = project(apply_m(op, r))
                rz_new = dot(r, z)
                beta = jnp.where(
                    rz != 0, rz_new / jnp.where(rz != 0, rz, 1.0), 0.0
                )
                # Restart (p = z) on negative beta: below the f32
                # residual floor rz turns into rounding noise and a
                # beta > 1 run would grow p exponentially, corrupting
                # the converged iterate.
                beta = jnp.where(active & (beta > 0), beta, 0.0)
                p = z + beta[None, :] * p
                rn = norm(r)
                improved = rn < 0.97 * best
                best = jnp.minimum(best, rn)
                stall = jnp.where(improved, 0, stall + 1)
                return (x, r, z, p, k + 1, rz_new, best, stall)

            x, r, z, p_dir, iters, rz, best, stall = jax.lax.while_loop(
                cond, loop_body,
                (x0, r0, z0, p0, jnp.int64(0), rz0, best0, stall0)
            )
            rtrue = b - matvec(x)
            result = CGResult(
                x=project(x),
                iterations=iters,
                residual_norms=norm(rtrue),
            )
            if state_out:
                return result, (x, r, z, p_dir, rz, best, stall)
            return result

        return body

    if mesh is None:
        @partial(jax.jit,
                 static_argnames=("maxiter", "state_in", "state_out"))
        def _solve(op, comp_id, b, tol, maxiter: int,
                   state_in: bool = False, state_out: bool = False,
                   state=None):
            body = make_body(maxiter, state_in, state_out)
            args = (state,) if state_in else ()
            return body(op, comp_id, b, tol, *args)
    else:
        from jax.sharding import PartitionSpec as P

        from .spmv import shard_map_unchecked

        pp_specs = (None if precond_params is None
                    else _tree_specs(precond_params, axis_name))
        op_specs = ((P(axis_name, None), P(axis_name, None), P(axis_name)),
                    pp_specs)
        res_specs = CGResult(x=P(axis_name, None), iterations=P(),
                             residual_norms=P())
        row = P(axis_name, None)
        state_specs = (row, row, row, row, P(), P(), P())

        @partial(jax.jit,
                 static_argnames=("maxiter", "state_in", "state_out"))
        def _solve(op, comp_id, b, tol, maxiter: int,
                   state_in: bool = False, state_out: bool = False,
                   state=None):
            base = (op_specs, P(axis_name), P(axis_name, None), P())
            in_specs = base + ((state_specs,) if state_in else ())
            out_specs = (res_specs, state_specs) if state_out else res_specs
            inner = shard_map_unchecked(
                make_body(maxiter, state_in, state_out), mesh,
                in_specs=in_specs, out_specs=out_specs,
            )
            args = (state,) if state_in else ()
            return inner(op, comp_id, b, tol, *args)

    a_params = operator[1] if operator is not None else (cols, vals, diag)
    op = (a_params, precond_params)

    def solve(b, tol, maxiter: int = 10000) -> CGResult:
        return _solve(op, comp_id, b, tol, maxiter=maxiter)

    def solve_stateful(b, tol, maxiter: int, state=None):
        """One bounded chunk of the SAME CG run: pass the returned state
        back in to continue exactly where the previous dispatch stopped
        (state=None starts fresh).  Returns (CGResult, state)."""
        return _solve(op, comp_id, b, tol, maxiter=maxiter,
                      state_in=state is not None, state_out=True,
                      state=state)

    solve.stateful = solve_stateful
    return solve


def make_pcg_t(
    operator,
    precond,
    comp_id: jnp.ndarray,
    num_components: int,
    stall_window: int | None = 30,
):
    """Transposed-layout deflated PCG: state kept as (R, N), the layout
    the slab operator (ops.dia.dia_matvec_t) consumes without
    transposes, so every axpy/dot of the hot loop runs on contiguous
    rows.

    operator: (apply, params) with yt = apply(params, xt) on (R, N) —
    e.g. ops.dia.dia_matvec_t.  precond: (apply, params) in the same
    layout (ops.amg.make_vcycle_dia_t).  Single-device only; the
    sharded/TP path lives in make_pcg.

    The external interface stays (N, R): solve(b, tol, maxiter) takes b
    of shape (N, R) and returns CGResult with x of shape (N, R) — one
    transpose each way per solve.
    """
    a_apply, a_params = operator
    m_apply, m_params = precond
    onehot = jax.nn.one_hot(comp_id, num_components, dtype=jnp.float32)
    # Clamp: an empty component (e.g. a dummy padding component when the
    # padded size happens to equal n) must not turn means into NaN.
    counts = jnp.maximum(onehot.sum(axis=0).astype(jnp.float64), 1.0)

    def dot(a, b2):
        return (a * b2).sum(axis=1)             # (R,)

    def norm(a):
        return jnp.sqrt(dot(a, a))

    @partial(jax.jit, static_argnames=("maxiter", "state_in", "state_out"))
    def _solve(op, mp, oh32, b, tol, maxiter: int,
               state_in: bool = False, state_out: bool = False,
               state=None):
        def project(xt):
            oh = oh32.astype(xt.dtype)
            sums = jnp.matmul(xt, oh, precision=_HIGHEST)      # (R, p)
            means = (sums / counts[None, :].astype(xt.dtype)
                     ).astype(xt.dtype)
            return xt - jnp.matmul(means, oh.T, precision=_HIGHEST)

        bt = project(b.T)
        bnorm = norm(bt)
        target = tol * jnp.maximum(bnorm, 1e-300)

        def matvec(xt):
            return a_apply(op, xt)

        def apply_m(rt):
            return m_apply(mp, rt)

        if state_in:
            (x0, r0, z0, p0, rz0, best0, stall0) = state
        else:
            x0 = jnp.zeros_like(bt)
            r0 = bt
            z0 = project(apply_m(r0))
            p0 = z0
            rz0 = dot(r0, z0)
            best0 = norm(r0)
            stall0 = jnp.zeros_like(best0, dtype=jnp.int32)

        # Stall exit: a column whose recurrence residual target sits at
        # or below the f32 noise floor (point-source border columns do —
        # target ~ eps*||A||*||x||) would otherwise spin to maxiter
        # without gaining a digit.  The outer f64 refinement multiplies
        # whatever was gained, so stop once no column has improved 3%
        # in STALL_WINDOW iterations.  ONLY safe under such an outer
        # loop (see make_pcg's stall_window caveat) — pass
        # stall_window=None for full-precision standalone solves.
        STALL_WINDOW = (2**31 - 2 if stall_window is None
                        else stall_window)

        def cond(s):
            _, r, _, _, k, _, _, stall = s
            active = norm(r) > target
            return jnp.logical_and(
                k < maxiter, jnp.any(active & (stall < STALL_WINDOW)))

        def body(s):
            x, r, z, p, k, rz, best, stall = s
            active = norm(r) > target
            ap = matvec(p)
            pap = dot(p, ap)
            alpha = jnp.where(pap > 0, rz / jnp.where(pap > 0, pap, 1.0),
                              0.0)
            alpha = jnp.where(active, alpha, 0.0)
            x = x + alpha[:, None] * p
            r = r - alpha[:, None] * ap
            r = jax.lax.cond(k % 50 == 49, project, lambda v: v, r)
            z = project(apply_m(r))
            rz_new = dot(r, z)
            beta = jnp.where(rz != 0, rz_new / jnp.where(rz != 0, rz, 1.0),
                             0.0)
            beta = jnp.where(active & (beta > 0), beta, 0.0)
            p = z + beta[:, None] * p
            rn = norm(r)
            improved = rn < 0.97 * best
            best = jnp.minimum(best, rn)
            stall = jnp.where(improved, 0, stall + 1)
            return (x, r, z, p, k + 1, rz_new, best, stall)

        x, r, z, p_dir, iters, rz, best, stall = jax.lax.while_loop(
            cond, body,
            (x0, r0, z0, p0, jnp.int64(0), rz0, best0, stall0))
        rtrue = bt - matvec(x)
        result = CGResult(x=project(x).T, iterations=iters,
                          residual_norms=norm(rtrue))
        if state_out:
            return result, (x, r, z, p_dir, rz, best, stall)
        return result

    def solve(b, tol, maxiter: int = 10000) -> CGResult:
        return _solve(a_params, m_params, onehot, b, tol, maxiter=maxiter)

    def solve_stateful(b, tol, maxiter: int, state=None):
        return _solve(a_params, m_params, onehot, b, tol,
                      maxiter=maxiter, state_in=state is not None,
                      state_out=True, state=state)

    solve.stateful = solve_stateful
    return solve


def make_pcg_t_sharded(
    operator,
    precond,
    comp_id,
    num_components: int,
    mesh,
    op_specs,
    pp_specs,
    axis_name: str = "tp",
    stall_window: int | None = 30,
):
    """Multi-chip transposed-layout deflated PCG (the sharded DIA path).

    operator: (apply_local, params) where
    yt_local = apply_local(params, xt_local) on LOCAL (R, n/tp) shards,
    written for execution inside shard_map over `axis_name` — e.g.
    ops.dia_sharded.dia_matvec_t_local bound to a pack's meta.  precond:
    same contract (ops.amg.make_vcycle_dia_sharded).  op_specs /
    pp_specs: PartitionSpec pytrees matching the two parameter pytrees
    (the sharded builders return them).

    The external interface matches make_pcg_t: solve(b, tol, maxiter)
    takes (N, R) and returns CGResult with x of shape (N, R); jit
    reshards inputs/outputs per the specs.  Inner products psum over the
    axis; the deflation projector completes component sums the same way.
    """
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from .spmv import shard_map_unchecked

    a_apply, a_params = operator
    m_apply, m_params = precond
    n = int(np.asarray(comp_id).shape[0])
    onehot_np = np.zeros((n, num_components), np.float32)
    onehot_np[np.arange(n), np.asarray(comp_id)] = 1.0
    onehot = jnp.asarray(onehot_np)

    colspec = P(None, axis_name)          # (R, n) row-sharded along n
    oh_spec = P(axis_name, None)
    state_specs = (colspec,) * 4 + (P(), P(), P())

    def body(op, mp, oh_l, bt_l, tol, *maybe_state):
        def gsum(v):
            return jax.lax.psum(v, axis_name)

        counts = jnp.maximum(
            gsum(oh_l.sum(axis=0)).astype(jnp.float64), 1.0)

        def project(xt):
            oh = oh_l.astype(xt.dtype)
            sums = gsum(jnp.matmul(xt, oh, precision=_HIGHEST))  # (R, p)
            means = (sums / counts[None, :].astype(xt.dtype)
                     ).astype(xt.dtype)
            return xt - jnp.matmul(means, oh.T, precision=_HIGHEST)

        def dot(a, b2):
            return gsum((a * b2).sum(axis=1))          # (R,)

        def norm(a):
            return jnp.sqrt(dot(a, a))

        def matvec(xt):
            return a_apply(op, xt)

        def apply_m(rt):
            return m_apply(mp, rt)

        bt = project(bt_l)
        bnorm = norm(bt)
        target = tol * jnp.maximum(bnorm, 1e-300)

        if maybe_state:
            (x0, r0, z0, p0, rz0, best0, stall0) = maybe_state[0]
        else:
            x0 = jnp.zeros_like(bt)
            r0 = bt
            z0 = project(apply_m(r0))
            p0 = z0
            rz0 = dot(r0, z0)
            best0 = norm(r0)
            stall0 = jnp.zeros_like(best0, dtype=jnp.int32)

        # Stall exit (same rationale as make_pcg_t): columns floored by
        # f32 noise stop burning iterations; refinement picks up.
        # Same mixed-precision-only caveat as make_pcg_t.
        STALL_WINDOW = (2**31 - 2 if stall_window is None
                        else stall_window)

        def cond(s):
            _, r, _, _, k, _, _, stall = s
            active = norm(r) > target
            return jnp.logical_and(
                k < maxiter_static[0],
                jnp.any(active & (stall < STALL_WINDOW)))

        def loop(s):
            x, r, z, p, k, rz, best, stall = s
            active = norm(r) > target
            ap = matvec(p)
            pap = dot(p, ap)
            alpha = jnp.where(pap > 0, rz / jnp.where(pap > 0, pap, 1.0),
                              0.0)
            alpha = jnp.where(active, alpha, 0.0)
            x = x + alpha[:, None] * p
            r = r - alpha[:, None] * ap
            r = jax.lax.cond(k % 50 == 49, project, lambda v: v, r)
            z = project(apply_m(r))
            rz_new = dot(r, z)
            beta = jnp.where(rz != 0, rz_new / jnp.where(rz != 0, rz, 1.0),
                             0.0)
            beta = jnp.where(active & (beta > 0), beta, 0.0)
            p = z + beta[:, None] * p
            rn = norm(r)
            improved = rn < 0.97 * best
            best = jnp.minimum(best, rn)
            stall = jnp.where(improved, 0, stall + 1)
            return (x, r, z, p, k + 1, rz_new, best, stall)

        x, r, z, p_dir, iters, rz, best, stall = jax.lax.while_loop(
            cond, loop,
            (x0, r0, z0, p0, jnp.int64(0), rz0, best0, stall0))
        rtrue = bt - matvec(x)
        result = CGResult(x=project(x), iterations=iters,
                          residual_norms=norm(rtrue))
        if state_out_static[0]:
            return result, (x, r, z, p_dir, rz, best, stall)
        return result

    # maxiter / state flags are static per compilation; threaded through
    # mutable cells so `body` stays a plain shard_map callee.
    maxiter_static = [0]
    state_out_static = [False]

    @partial(jax.jit,
             static_argnames=("maxiter", "state_in", "state_out"))
    def _solve(op, mp, oh, bt, tol, maxiter: int,
               state_in: bool = False, state_out: bool = False,
               state=None):
        maxiter_static[0] = maxiter
        state_out_static[0] = state_out
        res_specs = CGResult(x=colspec, iterations=P(),
                             residual_norms=P())
        in_specs = (op_specs, pp_specs, oh_spec, colspec, P())
        if state_in:
            in_specs = in_specs + (state_specs,)
        out_specs = (res_specs, state_specs) if state_out else res_specs
        inner = shard_map_unchecked(
            body, mesh, in_specs=in_specs, out_specs=out_specs)
        args = (state,) if state_in else ()
        return inner(op, mp, oh, bt, tol, *args)

    def solve(b, tol, maxiter: int = 10000) -> CGResult:
        res = _solve(a_params, m_params, onehot, b.T, tol, maxiter=maxiter)
        return CGResult(x=res.x.T, iterations=res.iterations,
                        residual_norms=res.residual_norms)

    def solve_stateful(b, tol, maxiter: int, state=None):
        res, st = _solve(a_params, m_params, onehot, b.T, tol,
                         maxiter=maxiter, state_in=state is not None,
                         state_out=True, state=state)
        return CGResult(x=res.x.T, iterations=res.iterations,
                        residual_norms=res.residual_norms), st

    solve.stateful = solve_stateful
    return solve


def pcg(
    cols: jnp.ndarray,
    vals: jnp.ndarray,
    diag: jnp.ndarray,
    b: jnp.ndarray,             # (N, R)
    comp_id: jnp.ndarray,       # (N,)
    num_components: int,
    tol: float = 1e-12,
    maxiter: int = 10000,
) -> CGResult:
    """One-shot Jacobi-preconditioned deflated CG.

    Convenience wrapper; compiles per call — hold on to make_pcg's solver
    for repeated solves against one operator."""
    solver = make_pcg(cols, vals, diag, comp_id, num_components)
    return solver(b, tol, maxiter)

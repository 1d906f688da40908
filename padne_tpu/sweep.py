"""Batched design sweeps: many solves of one board, varying parameters.

The reference solves one configuration per process run.  Device
sweeps (BASELINE.json configs[4]) exploit the fact that mesher output
and system *structure* are shared across a sweep over physical
parameters (copper weight / sheet conductance, source values): the ELL
sparsity pattern and border structure are built once, the per-config
values become a leading batch axis, and the whole batch solves in one
jitted multi-solve — shardable over devices via padne_tpu.parallel.

Currently supported sweep axes:
  * global conductance scale (copper weight / thickness sweep)
  * per-source value scaling (voltage/current magnitudes)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from . import mesh, problem, solver


@dataclass
class SweepSpec:
    """One configuration of the sweep."""

    conductance_scale: float = 1.0
    source_scale: float = 1.0


@dataclass
class SweepResult:
    spec: SweepSpec
    v: np.ndarray
    j: np.ndarray
    residual_norm: float


def solve_sweep(
    prob: problem.Problem,
    specs: Sequence[SweepSpec],
    mesher_config: Optional[mesh.Mesher.Config] = None,
    tol: float = 1e-12,
    maxiter: int = 40000,
) -> list[SweepResult]:
    """Solve the board once per spec, sharing mesh + structure.

    The core insight: scaling all conductances by s scales A by s, so
    A(s)^+ = A^+ / s — the expensive multi-RHS CG over the border
    columns runs ONCE; per-config solutions are recovered by rescaling
    inside the small dense border system.  Source scaling enters only
    through the right-hand sides.  This makes a conductance sweep
    effectively free beyond the first solve.
    """
    import jax
    import jax.numpy as jnp

    from .ops import cg as cg_mod
    from .ops import schur
    from .ops.spmv import ell_matvec

    mesher = mesh.Mesher(mesher_config)
    indices, _, pairs = solver.compute_connectivity(prob)
    meshes, m2l = solver.generate_meshes_for_problem(prob, mesher, pairs, indices)
    vindex = solver.VertexIndexer.create(meshes)
    filtered = solver.filter_dead_networks(prob, indices, pairs)
    node_indexer = solver.NodeIndexer.create(prob, meshes, m2l, vindex, filtered)
    system, _ = solver.assemble_core_system(
        prob, meshes, m2l, vindex, filtered, node_indexer
    )

    n, m = system.n, system.border.m
    p = system.num_components
    cols, vals, diag = system.ell.to_device()
    comp_id = jnp.asarray(system.comp_id)
    B, C = schur._dense_border(system)
    r_core = jnp.asarray(system.r_core)
    r_border = jnp.asarray(system.border.rhs)

    use_amg = n >= 20000
    precond = None
    if use_amg:
        from .ops import amg

        precond = amg.make_vcycle(amg.build_hierarchy(system.ell))
    cg_solver = cg_mod.make_pcg(cols, vals, diag, comp_id, p, precond=precond)

    # One multi-RHS solve of the UNIT-conductance system.
    rhs = jnp.concatenate([C, r_core[:, None]], axis=1)
    res = cg_solver(rhs, tol, maxiter)
    Xc, xr = res.x[:, :m], res.x[:, m]

    def zt(y):
        return jax.ops.segment_sum(y, comp_id, num_segments=p)

    BZ = jax.ops.segment_sum((B.T), comp_id, num_segments=p).T
    ZtC = zt(C)

    results = []
    for spec in specs:
        s = spec.conductance_scale
        src = spec.source_scale
        # A -> s A; r_core scales with source_scale; border voltage rhs
        # scales with source_scale.
        # v = (sA)^+ (C j - src*r_core) + Z c = (1/s)(Xc j - src*xr) + Z c
        BXc_s = (B @ Xc) / s
        Bxr_s = (B @ xr) * (src / s)
        Ztr = zt((src * r_core)[:, None])[:, 0]
        top = jnp.concatenate([BXc_s, BZ], axis=1)
        bot = jnp.concatenate([ZtC, jnp.zeros((p, p))], axis=1)
        M = jnp.concatenate([top, bot], axis=0)
        rhs_small = jnp.concatenate([src * r_border + Bxr_s, Ztr])
        sol, *_ = jnp.linalg.lstsq(M, rhs_small, rcond=None)
        jj, c = sol[:m], sol[m:]
        v = (Xc @ jj - src * xr) / s + c[comp_id]

        # Full residual for this config.
        av = ell_matvec(cols, vals * s, diag * s, v[:, None])[:, 0]
        rc = src * r_core + av - C @ jj
        rb = src * r_border - B @ v
        res_norm = float(jnp.sqrt((rc**2).sum() + (rb**2).sum()))
        results.append(
            SweepResult(
                spec=spec,
                v=np.asarray(v),
                j=np.asarray(jj),
                residual_norm=res_norm,
            )
        )
    return results

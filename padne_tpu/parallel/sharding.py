"""Multi-chip execution: sharded SpMV/CG and batched design sweeps.

The reference is strictly single-process/CPU (SURVEY.md §2: no
DP/TP/PP/SP/EP, no distributed backend).  This module supplies the
multi-device scaling story (BASELINE.json configs[3..4]):

* **TP (tensor parallel)**: rows of the ELL operator and all CG state
  are sharded over the `tp` mesh axis; each SpMV all-gathers the search
  direction and reduces dot products with `psum`.
* **DP (data parallel)**: independent solves (mesher-parameter or design
  sweeps sharing one mesh structure but different conductances/sources)
  batch along a leading axis sharded over `dp`.

Everything is expressed with `shard_map` over a `jax.sharding.Mesh`, so
the same code runs on N GPUs or on virtual CPU devices
(xla_force_host_platform_device_count) for testing.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, dp: int = 1) -> Mesh:
    """A (dp, tp) device mesh over the first n_devices devices.

    Raises if fewer than ``n_devices`` devices exist — silently
    truncating would hide a mis-provisioned environment (e.g. asking
    for 8 chips on a 1-device host) behind a confusing dp error.
    """
    available = jax.devices()
    if n_devices is not None and len(available) < n_devices:
        raise RuntimeError(
            f"requested a {n_devices}-device mesh but only "
            f"{len(available)} JAX device(s) exist "
            f"({available[0].platform}); provision virtual devices with "
            f"XLA_FLAGS=--xla_force_host_platform_device_count=N + "
            f"jax_platforms=cpu before first backend use"
        )
    devices = available[: (n_devices or len(available))]
    n = len(devices)
    if n % dp != 0:
        raise ValueError(f"dp={dp} does not divide device count {n}")
    grid = np.asarray(devices).reshape(dp, n // dp)
    return Mesh(grid, axis_names=("dp", "tp"))


def pad_rows(arr: np.ndarray, multiple: int, axis: int = 0,
             fill=0) -> np.ndarray:
    """Pad `axis` up to a multiple (rows padded with identity/no-op
    entries are harmless in the Laplacian: zero vals, self columns)."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def prepare_sharded_system(ell, b: np.ndarray, mesh: Mesh):
    """Pad + device_put a single system for TP execution.

    ell: ops.assembly.EllMatrix; b: (n, R) right-hand sides.
    Returns (cols, vals, diag, b_padded) device arrays sharded by row.
    """
    tp = mesh.shape["tp"]
    n = len(ell.diag)
    n_pad = n + ((-n) % tp)
    cols = pad_rows(ell.cols, tp)
    # Padding rows reference themselves with zero weight.
    for i in range(n, n_pad):
        cols[i, :] = i
    vals = pad_rows(ell.vals, tp)
    diag = pad_rows(ell.diag, tp)
    bp = pad_rows(np.asarray(b), tp)

    row_sharding = NamedSharding(mesh, P("tp", None))
    vec_sharding = NamedSharding(mesh, P("tp", None))
    return (
        jax.device_put(jnp.asarray(cols), row_sharding),
        jax.device_put(jnp.asarray(vals), row_sharding),
        jax.device_put(jnp.asarray(diag), NamedSharding(mesh, P("tp"))),
        jax.device_put(jnp.asarray(bp), vec_sharding),
    )


def sharded_cg(mesh: Mesh, cols, vals, diag, b, iters: int = 200,
               tol: float = 0.0):
    """Row-sharded Jacobi-PCG over the `tp` axis (single system).

    cols/vals: (n, K) sharded P('tp', None); diag: (n,) P('tp');
    b: (n, R) P('tp', None).  Runs a fixed number of iterations (static
    for jit) with per-column masking once `tol` is reached.
    """
    from ..ops.spmv import shard_map_unchecked

    n = b.shape[0]

    @functools.partial(
        shard_map_unchecked,
        mesh=mesh,
        in_specs=(P("tp", None), P("tp", None), P("tp"), P("tp", None)),
        out_specs=P("tp", None),
    )
    def solve(cols_l, vals_l, diag_l, b_l):
        # cols_l: (n_local, K) with GLOBAL column indices.
        minv = jnp.where(diag_l > 0, 1.0 / jnp.where(diag_l > 0, diag_l, 1.0), 1.0)

        def matvec(p_l):
            p_full = jax.lax.all_gather(p_l, "tp", axis=0, tiled=True)  # (n, R)
            gathered = p_full[cols_l]  # (n_local, K, R)
            off = jnp.einsum("nk,nkr->nr", vals_l, gathered,
                             precision=jax.lax.Precision.HIGHEST)
            return diag_l[:, None] * p_l + off

        def pdot(a_l, b2_l):
            return jax.lax.psum((a_l * b2_l).sum(axis=0), "tp")  # (R,)

        bnorm = jnp.sqrt(pdot(b_l, b_l))
        target = tol * jnp.maximum(bnorm, 1e-300)

        x = jnp.zeros_like(b_l)
        r = b_l
        z = minv[:, None] * r
        p = z
        rz = pdot(r, z)

        def body(_, state):
            x, r, z, p, rz = state
            rn = jnp.sqrt(pdot(r, r))
            active = rn > target
            ap = matvec(p)
            pap = pdot(p, ap)
            alpha = jnp.where(pap > 0, rz / jnp.where(pap > 0, pap, 1.0), 0.0)
            alpha = jnp.where(active, alpha, 0.0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
            z = minv[:, None] * r
            rz_new = pdot(r, z)
            beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
            beta = jnp.where(active, beta, 0.0)
            p = z + beta[None, :] * p
            return (x, r, z, p, rz_new)

        x, r, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, z, p, rz))
        return x

    return solve(cols, vals, diag, b)


def batched_sharded_cg(mesh: Mesh, cols, vals, diag, b, iters: int = 200):
    """DP x TP: a batch of systems sharing one sparsity structure.

    cols: (n, K) replicated structure; vals: (B, n, K) sharded
    P('dp', 'tp', None); diag: (B, n) P('dp', 'tp'); b: (B, n, R)
    P('dp', 'tp', None).  This is the vmapped design-sweep solver
    (BASELINE.json configs[4]).
    """
    from ..ops.spmv import shard_map_unchecked

    @functools.partial(
        shard_map_unchecked,
        mesh=mesh,
        in_specs=(
            P("tp", None),
            P("dp", "tp", None),
            P("dp", "tp"),
            P("dp", "tp", None),
        ),
        out_specs=P("dp", "tp", None),
    )
    def solve(cols_l, vals_l, diag_l, b_l):
        # vals_l: (B_local, n_local, K); b_l: (B_local, n_local, R)
        minv = jnp.where(diag_l > 0, 1.0 / jnp.where(diag_l > 0, diag_l, 1.0), 1.0)

        def matvec(p_l):
            p_full = jax.lax.all_gather(p_l, "tp", axis=1, tiled=True)
            gathered = jnp.take(p_full, cols_l, axis=1)  # (B_l, n_local, K, R)
            off = jnp.einsum("bnk,bnkr->bnr", vals_l, gathered,
                             precision=jax.lax.Precision.HIGHEST)
            return diag_l[..., None] * p_l + off

        def pdot(a2, b2):
            return jax.lax.psum((a2 * b2).sum(axis=1), "tp")  # (B_l, R)

        x = jnp.zeros_like(b_l)
        r = b_l
        z = minv[..., None] * r
        p = z
        rz = pdot(r, z)

        def body(_, state):
            x, r, z, p, rz = state
            ap = matvec(p)
            pap = pdot(p, ap)
            alpha = jnp.where(pap > 0, rz / jnp.where(pap > 0, pap, 1.0), 0.0)
            x = x + alpha[:, None, :] * p
            r = r - alpha[:, None, :] * ap
            z = minv[..., None] * r
            rz_new = pdot(r, z)
            beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
            p = z + beta[:, None, :] * p
            return (x, r, z, p, rz_new)

        x, *_ = jax.lax.fori_loop(0, iters, body, (x, r, z, p, rz))
        return x

    return solve(cols, vals, diag, b)

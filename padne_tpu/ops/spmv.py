"""Sparse matrix-vector products in ELL layout.

The multi-RHS SpMV of the generic (gather) solve path (reference
equivalent: SuperLU factorization inside scipy.spsolve, solver.py:773).
``ell_matvec`` is pure XLA: one gather + weighted reduction computing
y = diag * x + OffDiag @ x, where the ELL arrays hold the off-diagonal
entries.  The large-mesh path uses the slab format instead (ops.dia).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def collectives(axis_name):
    """(gather, gsum) pair for writing row-sharded kernels once.

    With axis_name=None both are identities (single-device semantics);
    inside shard_map over `axis_name`, `gather` reassembles the full
    vector from row shards (all_gather) and `gsum` completes a locally
    reduced sum (psum).
    """
    if axis_name is None:
        return (lambda x: x), (lambda v: v)

    def gather(x):
        return jax.lax.all_gather(x, axis_name, axis=0, tiled=True)

    def gsum(v):
        return jax.lax.psum(v, axis_name)

    return gather, gsum


def shard_map_unchecked(f, mesh, in_specs, out_specs):
    """jax.shard_map with replication (vma) checking off."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def ell_matvec(cols: jnp.ndarray, vals: jnp.ndarray, diag: jnp.ndarray,
               x: jnp.ndarray) -> jnp.ndarray:
    """XLA ELL SpMV.

    cols/vals: (N, K); diag: (N,); x: (N, R) or (N,).
    """
    if x.ndim == 1:
        gathered = x[cols]                      # (N, K)
        off = (vals * gathered).sum(axis=1)
        return diag * x + off
    gathered = x[cols]                          # (N, K, R)
    off = jnp.einsum("nk,nkr->nr", vals, gathered,
                     precision=jax.lax.Precision.HIGHEST)
    return diag[:, None] * x + off

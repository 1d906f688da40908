"""Field post-processing: per-face gradients and power density.

Replaces the reference's per-face Python loops (solver.py:689-745) with
single vectorized expressions over (F, 3, 2) coordinate batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.validation import checked


@jax.jit
def face_gradients(vertices: jnp.ndarray, triangles: jnp.ndarray,
                   values: jnp.ndarray) -> jnp.ndarray:
    """Gradient of the P1 (linear) interpolant on each face.

    vertices: (V, 2); triangles: (F, 3); values: (V,).  Returns (F, 2).

    For a triangle with CCW-signed area A and vertices a, b, c:
        grad f = (1 / 2A) * sum_k f_k * rot90(opposite_edge_k)
    with rot90(v) = (-v_y, v_x) and opposite_edge_k oriented CCW.
    """
    p = vertices[triangles]          # (F, 3, 2)
    f = values[triangles]            # (F, 3)
    # Opposite edge of corner k is (p[k+1] -> p[k+2]).
    e = jnp.stack([p[:, 2] - p[:, 1], p[:, 0] - p[:, 2], p[:, 1] - p[:, 0]],
                  axis=1)            # (F, 3, 2)
    rot = jnp.stack([-e[..., 1], e[..., 0]], axis=-1)  # (F, 3, 2)
    area2 = (
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0])
    )                                # signed 2*area
    # Safe divide: CDT output never has zero-area faces, but padding
    # faces in the batched path (all vertices = vertex 0) do.
    safe = jnp.where(area2 != 0.0, area2, 1.0)
    grad = jnp.einsum("fk,fkd->fd", f, rot,
                      precision=jax.lax.Precision.HIGHEST) / safe[:, None]
    return jnp.where((area2 != 0.0)[:, None], grad, 0.0)


@jax.jit
def power_density(vertices: jnp.ndarray, triangles: jnp.ndarray,
                  values: jnp.ndarray, conductance: float) -> jnp.ndarray:
    """p = sigma * |grad V|^2 per face (reference compute_power_density,
    solver.py:728-745, with sigma = layer sheet conductance)."""
    g = face_gradients(vertices, triangles, values)
    return conductance * (g * g).sum(axis=1)


@jax.jit
def _power_density_flat(vertices, triangles, values, conductance):
    """Concatenated-mesh variant: conductance is per-face."""
    g = face_gradients(vertices, triangles, values)
    return conductance * (g * g).sum(axis=1)


@checked
def power_density_batch(meshes, values_list, conductances):
    """Power density for MANY meshes in ONE padded jit call.

    A per-mesh power_density call compiles one XLA program per distinct
    (V, F) shape — a many-mesh board (e.g. the reference's many_meshes
    fixtures, 178 meshes) paid ~170 compilations.  Concatenating into a
    single flat system (vertex indices offset per mesh, per-face
    conductance) and padding V/F up to power-of-two buckets makes the
    compile count O(distinct buckets), shared process-wide.

    meshes: TriMesh-likes with .vertices (V,2) / .triangles (F,3);
    values_list: per-mesh (V,) vertex potentials; conductances: per-mesh
    scalar sheet conductance.  Returns a list of per-mesh (F,) arrays.
    """
    import numpy as np

    if not meshes:
        return []
    nv = [m.num_vertices for m in meshes]
    nf = [len(m.triangles) for m in meshes]
    voff = np.concatenate([[0], np.cumsum(nv)])
    V, F = int(voff[-1]), int(np.sum(nf))
    # Power-of-two padding buckets: the same compiled program serves any
    # board whose totals round to the same bucket.
    Vp = 1 << max(V - 1, 1).bit_length()
    Fp = 1 << max(F - 1, 1).bit_length()
    verts = np.zeros((Vp, 2))
    tris = np.zeros((Fp, 3), np.int32)   # padding faces -> vertex 0
    vals = np.zeros(Vp)
    cond = np.zeros(Fp)                  # padding faces -> zero power
    at = 0
    for i, m in enumerate(meshes):
        verts[voff[i]:voff[i + 1]] = m.vertices
        vals[voff[i]:voff[i + 1]] = values_list[i]
        tris[at:at + nf[i]] = np.asarray(m.triangles) + voff[i]
        cond[at:at + nf[i]] = conductances[i]
        at += nf[i]
    # Padding faces (all vertices = vertex 0) have zero area; the
    # face_gradients safe-divide returns zero gradient there.
    pd = _power_density_flat(
        jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(vals),
        jnp.asarray(cond))
    pd = np.asarray(pd)
    out = []
    at = 0
    for i in range(len(meshes)):
        out.append(pd[at:at + nf[i]])
        at += nf[i]
    return out

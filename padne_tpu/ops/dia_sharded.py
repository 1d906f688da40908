"""Row-sharded block-offset-DIA operators: the multi-chip SpMV.

Shards the ops.dia format over a 1-D ``tp`` device axis.  The format is
shard-friendly by construction: the slab contraction reads x through a
contiguous window of ``dmax`` blocks around each row block, so sharding
rows by whole slab groups makes the inter-shard dependency exactly one
halo of ``dmax * B`` elements per neighbor — a one-hop ``ppermute``,
not an all_gather (the ELL path's all_gather of the full vector is what
caps it at small meshes).

The off-offset remainder splits per shard:

* **near** entries — the column lies inside the shard's halo-extended x
  window (the common case: Hilbert ordering keeps |row - col| small).
  These read from the already-exchanged window; zero extra traffic.
* **far** entries — true long-range couplings (e.g. deflation-breaking
  connection vertices).  Their source values travel in a *compressed*
  exchange: each shard contributes only the x entries some other shard
  actually needs (padded to the max per-shard count), one small
  all_gather of (R, tp * Ms) instead of the full vector.

The weight slabs are built per shard directly on their target device
(``upload_sharded``) — the multi-GB global W is never materialized on
one device or the host.

No reference counterpart: the reference is single-process scipy
(solver.py:767-780); this is the SURVEY §5 ">HBM / long-context analog"
slot (sharded SpMV with halo exchange between devices).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dia import DiaPack, _dmax, _xla_main


@dataclass
class ShardPlan:
    """Host-side sharding of one DiaPack's remainder + geometry.

    All (tp, M) arrays are padded with inert entries (row 0 / index 0 /
    value 0) so every shard sees the same static shapes.
    """

    tp: int
    np_local: int
    halo: int                 # halo width in elements (= dmax * B)
    near_row: np.ndarray      # (tp, Mn) int32 local row
    near_win: np.ndarray      # (tp, Mn) int32 index into local padded window
    near_val: np.ndarray      # (tp, Mn) float
    far_row: np.ndarray       # (tp, Mf) int32 local row
    far_pos: np.ndarray       # (tp, Mf) int32 index into gathered exchange
    far_val: np.ndarray       # (tp, Mf) float
    src_idx: np.ndarray       # (tp, Ms) int32 local col feeding the exchange

    @property
    def meta_local(self):
        return (self.tp, self.np_local, self.halo,
                self.near_row.shape[1], self.far_row.shape[1],
                self.src_idx.shape[1])


def shardable(pack: DiaPack, tp: int) -> bool:
    """A pack shards iff whole grid steps divide evenly and the slab
    window never reaches past the immediate neighbor."""
    if tp <= 1 or pack.ng % tp:
        return False
    np_local = pack.np_ // tp
    return _dmax(pack.offs) * pack.b <= np_local


def _pad_rows_2d(parts: list[np.ndarray], dtype) -> np.ndarray:
    m = max((len(p) for p in parts), default=0)
    out = np.zeros((len(parts), m), dtype=dtype)
    for i, p in enumerate(parts):
        out[i, : len(p)] = p
    return out


def plan_shards(pack: DiaPack, tp: int) -> ShardPlan:
    """Split the remainder into per-shard near/far lists and build the
    compressed far exchange."""
    if not shardable(pack, tp):
        raise ValueError("pack is not shardable over this tp")
    np_local = pack.np_ // tp
    halo = _dmax(pack.offs) * pack.b
    rows = pack.rem_rows.astype(np.int64)
    cols = pack.rem_cols.astype(np.int64)
    vals = pack.rem_vals

    shard = rows // np_local
    win_lo = shard * np_local - halo
    near = (cols >= win_lo) & (cols < win_lo + np_local + 2 * halo)

    near_row, near_win, near_val = [], [], []
    for s in range(tp):
        sel = near & (shard == s)
        near_row.append((rows[sel] - s * np_local).astype(np.int32))
        near_win.append((cols[sel] - (s * np_local - halo)).astype(np.int32))
        near_val.append(vals[sel])

    # Compressed exchange for far entries: unique source columns, laid
    # out grouped by their owning shard, each group padded to Ms.
    f_rows, f_cols, f_vals = rows[~near], cols[~near], vals[~near]
    fc = np.unique(f_cols)
    src_shard = fc // np_local
    counts = np.bincount(src_shard, minlength=tp)
    ms = int(counts.max(initial=0))
    src_idx_parts = []
    # Global gathered position of each fc entry: owner * Ms + rank.
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(len(fc)) - starts[src_shard]
    gathered_pos = (src_shard * ms + rank).astype(np.int64)
    pos_of_col = dict(zip(fc.tolist(), gathered_pos.tolist()))
    for s in range(tp):
        local_cols = fc[src_shard == s] - s * np_local
        src_idx_parts.append(local_cols.astype(np.int32))

    far_row, far_pos, far_val = [], [], []
    f_shard = f_rows // np_local
    for s in range(tp):
        sel = f_shard == s
        far_row.append((f_rows[sel] - s * np_local).astype(np.int32))
        far_pos.append(np.asarray(
            [pos_of_col[c] for c in f_cols[sel].tolist()], dtype=np.int32
        ))
        far_val.append(f_vals[sel])

    return ShardPlan(
        tp=tp, np_local=np_local, halo=halo,
        near_row=_pad_rows_2d(near_row, np.int32),
        near_win=_pad_rows_2d(near_win, np.int32),
        near_val=_pad_rows_2d(near_val, np.float64),
        far_row=_pad_rows_2d(far_row, np.int32),
        far_pos=_pad_rows_2d(far_pos, np.int32),
        far_val=_pad_rows_2d(far_val, np.float64),
        src_idx=_pad_rows_2d(src_idx_parts, np.int32),
    )


def _tp_devices(mesh, axis_name: str):
    """The device list along `axis_name`; every other mesh axis must be
    trivial for this 1-D row sharding."""
    tp = int(mesh.shape[axis_name])
    if int(np.prod([s for a, s in mesh.shape.items() if a != axis_name])) != 1:
        raise ValueError(
            "sharded DIA needs a 1-D mesh (only the tp axis may be > 1)"
        )
    return list(mesh.devices.reshape(tp)), tp


def upload_sharded(pack: DiaPack, plan: ShardPlan, mesh, axis_name: str,
                   dtype=None) -> dict:
    """Device parameter dict with the W slab built per shard ON its
    target device (the global W never exists in one memory), plus the
    sharded remainder/diag arrays.

    Returns params dict; the matching PartitionSpecs come from
    `param_specs`.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    devices, tp = _tp_devices(mesh, axis_name)
    dtype = dtype or jnp.float32
    d, b, g, ng = len(pack.offs), pack.b, pack.g, pack.ng
    ng_l = ng // tp
    chunk = ng_l * g * d * b * b

    widx = pack.widx                        # composed once (sharded-path only)
    gi = widx // (g * d * b * b)            # grid step of each entry
    shard_of = (gi // ng_l).astype(np.int64)

    # Cast on host BEFORE the upload (same rule as DiaPack.to_device):
    # f64 requests ship values as-is — an exact-f64 operator — while
    # everything else rounds to f32 host-side, so the transfer never
    # carries doubled bytes that a device cast would throw away.
    f64 = dtype == jnp.float64
    val_np = np.float64 if f64 else np.float32
    slab_build_dtype = jnp.float64 if f64 else jnp.float32

    def build_local(idx, v):
        w = jnp.zeros(chunk, slab_build_dtype)
        w = w.at[idx].set(v, mode="promise_in_bounds", unique_indices=True)
        return w.reshape(ng_l, g, d, b, b).astype(dtype)

    shards = []
    for s, dev in enumerate(devices):
        sel = shard_of == s
        with jax.default_device(dev):
            # asarray INSIDE the context: a direct host->shard upload
            # (staging through the default device would transit every
            # byte twice and park transients on device 0's HBM).
            idx = jnp.asarray((widx[sel] - s * chunk).astype(
                np.int32 if chunk < 2**31 else np.int64))
            v = jnp.asarray(pack.wval[sel].astype(val_np))
            shards.append(jax.jit(build_local)(idx, v))
    w = jax.make_array_from_single_device_arrays(
        (ng, g, d, b, b),
        NamedSharding(mesh, P(axis_name, None, None, None, None)),
        shards,
    )

    def put(arr, spec):
        return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, spec))

    def put_val(arr, spec):
        return put(np.asarray(arr, val_np), spec).astype(dtype)

    row = P(axis_name, None)
    return {
        "w": w,
        "diag": put_val(pack.diag, P(axis_name)),
        "near_row": put(plan.near_row, row),
        "near_win": put(plan.near_win, row),
        "near_val": put_val(plan.near_val, row),
        "far_row": put(plan.far_row, row),
        "far_pos": put(plan.far_pos, row),
        "far_val": put_val(plan.far_val, row),
        "src_idx": put(plan.src_idx, row),
    }


def param_specs(axis_name: str):
    """PartitionSpecs matching upload_sharded's dict."""
    from jax.sharding import PartitionSpec as P

    row = P(axis_name, None)
    return {
        "w": P(axis_name, None, None, None, None),
        "diag": P(axis_name),
        "near_row": row, "near_win": row, "near_val": row,
        "far_row": row, "far_pos": row, "far_val": row,
        "src_idx": row,
    }


def dia_matvec_t_local(meta, plan_meta, params, xt, axis_name: str):
    """Local-shard transposed matvec; call INSIDE shard_map over
    `axis_name`.

    meta: the pack's GLOBAL meta (np_, b, g, ng, offs); plan_meta:
    ShardPlan.meta_local (static).  params: upload_sharded dict as seen
    inside shard_map (leading tp axis already sliced — (tp, M) arrays
    arrive as (1, M)).  xt: (R, np_local).
    """
    import jax
    import jax.numpy as jnp

    np_, b, g, ng, offs = meta
    tp, np_local, halo, mn, mf, ms = plan_meta
    meta_local = (np_local, b, g, ng // tp, offs)
    xt32 = xt.astype(params["w"].dtype)

    lh = jax.lax.ppermute(
        xt32[:, -halo:], axis_name, [(i, i + 1) for i in range(tp - 1)])
    rh = jax.lax.ppermute(
        xt32[:, :halo], axis_name, [(i, i - 1) for i in range(1, tp)])
    xt_pad = jnp.concatenate([lh, xt32, rh], axis=1)

    yt = _xla_main(meta_local, params["w"], xt_pad)
    yt = yt + params["diag"][None, :] * xt32

    if mn or mf:
        # Scatter-adds run in the (rows, R) layout, the same transpose
        # sandwich as dia_matvec_t.
        idx_parts, contrib_parts = [], []
        if mn:
            x_win = xt_pad.T                                    # (win, R)
            idx_parts.append(params["near_row"][0])
            contrib_parts.append(
                params["near_val"][0][:, None] * x_win[params["near_win"][0]]
            )
        if mf:
            # Padded src_idx slots gather an arbitrary real value, but
            # nothing reads them: far_pos only maps REAL columns and the
            # padded far entries carry val=0 — no mask needed.
            comp = xt32[:, params["src_idx"][0]]
            comp_full = jax.lax.all_gather(
                comp, axis_name, axis=1, tiled=True)            # (R, tp*Ms)
            idx_parts.append(params["far_row"][0])
            contrib_parts.append(
                params["far_val"][0][:, None] * comp_full.T[params["far_pos"][0]]
            )
        rem = jnp.zeros((np_local, xt.shape[0]), yt.dtype).at[
            jnp.concatenate(idx_parts)
        ].add(jnp.concatenate(contrib_parts).astype(yt.dtype), mode="drop")
        yt = yt + rem.T
    return yt.astype(xt.dtype)

"""Block-offset-diagonal (DIA) sparse operators.

The slab format of the solver's level operators (reference hot path:
the SuperLU factorization inside scipy.spsolve, reference
solver.py:767-780).

Format.  Rows/columns are blocked at B=128.  After a locality ordering
(Hilbert curve over vertex coordinates, ops.bell.hilbert_order), ~95% of
the nonzeros of a FEM mesh operator fall on a handful of *block
offsets* d = col_block - row_block (measured: the top 5 offsets cover
95% at B=128).  Those offsets are stored as dense (ng, G, D, B, B)
weight slabs W (G row-blocks per group); the SpMV becomes, per
row-block, D static-offset (R, B) @ (B, B) products against a
contiguous window of x — no gathers.  The few percent of stragglers
are a sorted-COO remainder handled by one small gather + scatter-add.
The diagonal is kept as a separate vector (the FEM assembly produces it
separately, ops.assembly.EllMatrix).

The weight slabs are (1/fill) larger than the nonzeros: a dense slab
streams ~30x the bytes an ELL form of the same operator needs (see
ROADMAP).  Slabs are never materialized on the host nor uploaded: the
host ships nnz-sized scatter indices and the device builds W with one
scatter (same discipline as ops.bell).

The contraction (`_xla_main`) is an XLA einsum per offset over the
slabs, f32 at Precision.HIGHEST so no backend substitutes a
reduced-precision (TF32) product.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np


DEFAULT_B = 128   # row/column block size
DEFAULT_G = 8     # row-blocks per slab group


def choose_offsets(
    rows: np.ndarray,
    cols: np.ndarray,
    b: int = DEFAULT_B,
    coverage: float = 0.95,
    max_offsets: int = 8,
) -> tuple[int, ...]:
    """Pick the block offsets to densify: greedily by nnz count until
    `coverage` of the nonzeros are covered (or max_offsets reached).
    Offset 0 (the block diagonal) is always included."""
    if len(rows) == 0:
        return (0,)
    return _offsets_from_bd(cols // b - rows // b, coverage, max_offsets)


def _offsets_from_bd(bd: np.ndarray, coverage: float,
                     max_offsets: int) -> tuple[int, ...]:
    """Offset selection from precomputed block deltas (col_b - row_b)."""
    # bincount over the offset span beats np.unique's sort (~1 s at
    # 6M nnz); the span is bounded by the Hilbert-order locality.
    bdmin = int(bd.min())
    cnts = np.bincount(bd - bdmin)
    u = np.nonzero(cnts)[0]
    c = cnts[u]
    u = u + bdmin
    order = np.argsort(-c)
    total = len(bd)
    picked = []
    covered = 0
    for i in order:
        if len(picked) >= max_offsets:
            break
        picked.append(int(u[i]))
        covered += int(c[i])
        if covered >= coverage * total:
            break
    if 0 not in picked:
        picked.append(0)
    return tuple(sorted(picked))


@dataclass
class DiaPack:
    """Host-side packing of a square operator in block-offset form.

    All arrays are nnz-sized or O(n); the dense weight slabs are built
    on device by `to_device` (one scatter).
    """

    n: int                 # logical rows (before padding)
    np_: int               # padded rows = ng * G * B
    b: int
    g: int
    ng: int
    offs: tuple[int, ...]
    # Split flat index into W: widx = widx_hi * b + widx_lo.  Kept split
    # (int32 + uint8/16 instead of one int64 — the flat index exceeds
    # int32 range at 1M-row packs), and widx_hi travels as an int16
    # delta stream (_hi_delta): 3 bytes/entry on the wire and no 50+ MB
    # compose/split round-trips on a page-fault-bound host.
    widx_hi: np.ndarray    # (nnz_main,) int32: (rb * d + slot) * b + col_local
    widx_lo: np.ndarray    # (nnz_main,) uint8/16: row_local
    wval: np.ndarray       # (nnz_main,) float
    rem_rows: np.ndarray   # (nnz_rem,) int32, sorted
    rem_cols: np.ndarray   # (nnz_rem,) int32
    rem_vals: np.ndarray   # (nnz_rem,) float
    diag: np.ndarray       # (np_,) float64, zero on padding rows
    # start_upload() parks async device copies of the nnz arrays here;
    # to_device consumes them (field, not in __eq__/__repr__ noise).
    _dev: Optional[dict] = None
    # rem_ell() result cache as (rem_rows_ref, result) — the bucketing
    # (np.unique + searchsorted over nnz_rem) is needed by both
    # to_device and the anchor's ratio encoding in the same setup.  The
    # identity check on rem_rows keeps dataclasses.replace()-derived
    # packs (which copy this field but swap the remainder arrays) from
    # inheriting a stale result.
    _rem_cache: Optional[tuple] = None

    @property
    def meta(self) -> tuple:
        """Static description consumed by the jitted matvec."""
        return (self.np_, self.b, self.g, self.ng, self.offs)

    @property
    def widx(self) -> np.ndarray:
        """Composed (nnz_main,) int64 flat index into W (materializes a
        fresh array — prefer widx_hi/widx_lo in hot paths)."""
        return (self.widx_hi.astype(np.int64) * self.b
                + self.widx_lo.astype(np.int64))

    def _hi_delta(self):
        """widx_hi as an int16 delta stream + exceptions (2 B/entry on
        the wire instead of 4).  The packer emits entries in CSR row
        order, so hi is near-sorted with steps bounded by ~(d+1)*b —
        comfortably int16; the rare larger jump (a run of empty row
        blocks) rides a sparse exception list the device patches in
        before the reconstructing cumsum."""
        hi = self.widx_hi.astype(np.int64)
        d = np.diff(hi, prepend=np.int64(0))   # d[0] == hi[0]
        exc = np.nonzero((d > 32767) | (d < -32768))[0]
        with np.errstate(over="ignore"):
            d16 = d.astype(np.int16)           # wrapped slots get patched
        return d16, exc.astype(np.int32), d[exc].astype(np.int32)

    def start_upload(self):
        """Begin async device transfer of the nnz-sized arrays (widx
        delta stream + row-locals + values).  Called as soon as the
        pack exists so the transfer overlaps the remaining host-side
        hierarchy build; to_device picks the
        handles up later."""
        import jax.numpy as jnp

        if self._dev is not None or not len(self.widx_hi):
            return
        d16, exc_i, exc_v = self._hi_delta()
        self._dev = {
            "d16": jnp.asarray(d16),
            "exc_i": jnp.asarray(exc_i),
            "exc_v": jnp.asarray(exc_v),
            "lo": jnp.asarray(self.widx_lo),
            "vals": jnp.asarray(self.wval.astype(np.float32)),
        }

    REM_BUCKETS = (1, 2, 3)

    def rem_ell(self):
        """Degree-bucketed unique-row layout of the remainder.

        Rows are grouped by remainder degree into REM_BUCKETS classes;
        a degree-d row in bucket d carries exactly its d (col, val)
        pairs — NO padding slots, so the device gathers only real
        entries (most rows have degree 1-2, the max is ~5, so a flat
        Kr-padded layout would gather mostly padding).  Rows with degree
        beyond the last bucket spill to a COO tail (rare high-degree
        connection vertices).  Contributions from all buckets
        concatenate into ONE sorted-unique-index scatter-add, which
        lowers to a cheaper scatter than the generic duplicate-handling
        one.

        Returns ({d: (rows (U_d,), cols (U_d, d), vals (U_d, d))},
        spill_rows, spill_cols, spill_vals).
        """
        if (self._rem_cache is not None
                and self._rem_cache[0] is self.rem_rows):
            return self._rem_cache[1]
        result = _bucket_rem(self.rem_rows, self.rem_cols, self.rem_vals,
                             self.REM_BUCKETS)
        self._rem_cache = (self.rem_rows, result)
        return result

    def to_device(self, dtype=None, w=None, keep_widx: bool = False,
                  slab_dtype=None, slots: int = 0) -> dict:
        """Device parameter dict: W slab (one on-device scatter), the
        unique-row remainder, and the diagonal.

        w: reuse an already-built device slab (any dtype) instead of
        scattering a fresh one — avoids re-uploading the nnz-sized
        index/value arrays when one pack feeds two operators (e.g. the
        exact f32 CG matvec and a bf16 V-cycle).

        slab_dtype: store (and for bf16, UPLOAD) the weight slab in
        this dtype while the remainder/diag streams keep `dtype` — the
        deep V-cycle levels run bf16 slabs anyway, so shipping their
        nnz values as 2 B/entry halves that wire traffic.

        keep_widx: additionally return the reconstructed device widx
        split as params["_hi"]/params["_lo"] (int32 / uint8) — consumed
        by coo_from_widx for value-correction overlays (the f64 anchor
        residual) without re-uploading nnz-sized index arrays.

        slots: pack up to this many per-row-block extra offsets of the
        remainder into dense slot tables (ExtraSlots) consumed inside
        the matvec kernel; only the unplaced tail stays in the COO
        remainder buckets.  NOTE: with slots the r{d}_ bucket params
        hold only the post-slot tail — consumers that widen the FULL
        remainder (the f64 anchor, _setup_anchor) must build with
        slots=0; the compensated operator (ops.comp) instead takes the
        raw remainder from the host pack and composes fine with
        slots + keep_widx."""
        import jax
        import jax.numpy as jnp
        dtype = dtype or jnp.float32
        slab_target = slab_dtype or dtype
        d, b, g, ng = len(self.offs), self.b, self.g, self.ng
        size = ng * g * d * b * b

        if keep_widx and w is not None:
            raise ValueError(
                "keep_widx needs the slab built here (the widx split is "
                "reconstructed during the scatter); it cannot be honored "
                "when reusing an existing slab via w="
            )
        if w is None:
            # Delta-compressed upload (see _hi_delta); start_upload()
            # may already have the transfers in flight.
            if self._dev is not None:
                d16, exc_i, exc_v, lo, vals = (
                    self._dev["d16"], self._dev["exc_i"],
                    self._dev["exc_v"], self._dev["lo"],
                    self._dev["vals"])
            else:
                d16_h, exc_i_h, exc_v_h = self._hi_delta()
                d16 = jnp.asarray(d16_h)
                exc_i = jnp.asarray(exc_i_h)
                exc_v = jnp.asarray(exc_v_h)
                lo = jnp.asarray(self.widx_lo)
                wire = (jnp.bfloat16 if slab_target == jnp.bfloat16
                        else np.float32)
                vals = jnp.asarray(self.wval.astype(wire))

            @partial(jax.jit, static_argnames=("total",))
            def _build(d16, exc_i, exc_v, lo, v, total: int):
                d32 = d16.astype(jnp.int32)
                if exc_i.shape[0]:
                    d32 = d32.at[exc_i].set(exc_v)
                hi = jnp.cumsum(d32)
                it = jnp.int64 if total >= 2**31 else jnp.int32
                idx = hi.astype(it) * b + lo.astype(it)
                w = jnp.zeros(total, v.dtype)
                w = w.at[idx].set(v, mode="promise_in_bounds",
                                  unique_indices=True)
                return (w.reshape(ng, g, d, b, b).astype(slab_target),
                        hi)

            w, hi_dev = _build(d16, exc_i, exc_v, lo, vals, size)
            lo_dev = lo
            self._dev = None   # release the nnz device buffers
        else:
            hi_dev = lo_dev = None

        host, ex = self._host_params(dtype=dtype, slab_dtype=slab_dtype,
                                     slots=slots)
        params = self._finish_params(w, jax.device_put(host), ex,
                                     dtype=dtype, slab_dtype=slab_dtype)
        if keep_widx:
            params["_hi"], params["_lo"] = hi_dev, lo_dev
        return params

    def _host_params(self, dtype=None, slab_dtype=None, slots: int = 0):
        """Host-side small-array dict of to_device, pre-put (plus the
        ExtraSlots pack when slots are requested).  Split out so
        `to_device_many` can send MANY packs' dicts in ONE
        device_put."""
        import jax.numpy as jnp

        dtype = dtype or jnp.float32
        slab_target = slab_dtype or dtype
        ex = None
        if slots and len(self.rem_rows):
            ex = pack_extra_slots(self, e_max=slots)
            buckets, sp_r, sp_c, sp_v = _bucket_rem(
                ex.tail_rows, ex.tail_cols, ex.tail_vals,
                self.REM_BUCKETS)
        else:
            buckets, sp_r, sp_c, sp_v = self.rem_ell()
        # Cast on host BEFORE the upload: a f64 upload followed by a
        # device cast doubles the transferred bytes.  f64 requests
        # upload values as-is (no f32 round-trip — the f64 operator
        # must be EXACT for the anchor residual).
        f64 = dtype == jnp.float64

        # Host-side value cast mirroring the old per-array device cast
        # chain (f64 -> f32 -> target), so a bf16 target double-rounds
        # identically to the previous implementation.
        def _val_np(a):
            a = np.asarray(a)
            if f64:
                return a.astype(np.float64)
            a32 = a.astype(np.float32)
            tgt = np.dtype(dtype) if dtype is not None else np.float32
            return a32 if tgt == np.float32 else a32.astype(
                np.dtype(jnp.bfloat16).type
                if dtype == jnp.bfloat16 else tgt)

        host = {
            "sp_rows": np.asarray(sp_r),
            "sp_cols": np.asarray(sp_c),
            "sp_vals": _val_np(sp_v),
            "diag": _val_np(self.diag),
        }
        for d, (rows_d, cols_d, vals_d) in buckets.items():
            host[f"r{d}_rows"] = np.asarray(rows_d)
            host[f"r{d}_cols"] = np.asarray(cols_d)
            host[f"r{d}_vals"] = _val_np(vals_d)
        if ex is not None:
            st = (jnp.bfloat16 if slab_target == jnp.bfloat16
                  else (jnp.float64 if f64 else jnp.float32))
            wire = (np.float64 if f64 else
                    (np.dtype(jnp.bfloat16).type
                     if st == jnp.bfloat16 else np.float32))
            host["_xs_idx"] = np.asarray(ex.idx)
            host["_xs_vals"] = ex.vals.astype(wire)
            host["_xs_cls"] = np.asarray(ex.cls)
            host["xs_tgt"] = np.asarray(ex.tgt.reshape(-1))
        bucket_rows = [buckets[d][0] for d in self.REM_BUCKETS
                       if len(buckets[d][0])]
        if rem_gather_enabled() and bucket_rows:
            # Gather-merge mode: bucket rows are unique and disjoint
            # across degrees, so their contributions merge into y with
            # ONE row gather through a host-precomputed inverse map —
            # rows without a remainder entry read a trailing zero row.
            # Replaces the scatter-add (opt-in; not measured on the
            # GPU).  The rare high-degree spill keeps the tiny COO
            # scatter.
            rows_cat = np.concatenate(bucket_rows)
            rg_map = np.full(self.np_, len(rows_cat), np.int32)
            rg_map[rows_cat] = np.arange(len(rows_cat), dtype=np.int32)
            host["rg_map"] = rg_map
        return host, ex

    def _finish_params(self, w, put, ex, dtype=None, slab_dtype=None):
        """Assemble the device parameter dict from the put results of
        _host_params (builds the on-device slot tables when present)."""
        import jax.numpy as jnp

        dtype = dtype or jnp.float32
        slab_target = slab_dtype or dtype
        params = {"w": w, **put}
        if ex is not None:
            f64 = dtype == jnp.float64
            st = (jnp.bfloat16 if slab_target == jnp.bfloat16
                  else (jnp.float64 if f64 else jnp.float32))
            # Slot tables are built ON DEVICE from the placed entries
            # (9 B/entry on the wire vs 8 B/slot-cell dense); the tables
            # themselves are (nb, E, b) — 20 MB-class at 1M rows.
            wslot, cslot = _build_slot_tables(
                params.pop("_xs_idx"), params.pop("_xs_vals"),
                params.pop("_xs_cls"), nb=ex.nb, e=ex.e, b=ex.b)
            params["xs_ci"] = cslot
            params["xs_w"] = wslot.astype(st)
        return params


def to_device_many(items, extra_host=None):
    """Batched to_device for packs whose weight slab already exists:
    `items` is a list of (pack, w, kwargs) with kwargs accepting
    dtype/slab_dtype/slots.  All packs' small host arrays (plus the
    optional extra_host dict) ship in ONE jax.device_put instead of one
    put per level.  Returns (params_list, extra_put)."""
    import jax

    hosts, exs = [], []
    for pack, w, kw in items:
        host, ex = pack._host_params(**kw)
        hosts.append(host)
        exs.append(ex)
    puts = jax.device_put((hosts, extra_host or {}))
    params = [pack._finish_params(w, put, ex, dtype=kw.get("dtype"),
                                  slab_dtype=kw.get("slab_dtype"))
              for (pack, w, kw), put, ex in zip(items, puts[0], exs)]
    return params, puts[1]


def _bucket_rem(rr, rc, rv, rem_buckets=DiaPack.REM_BUCKETS):
    """Degree-bucketed unique-row layout of a row-sorted COO remainder
    (see DiaPack.rem_ell for the format rationale)."""
    out = {}
    if len(rr) == 0:
        for d in rem_buckets:
            z = np.zeros(0, np.int32)
            out[d] = (z, z.reshape(0, d), np.zeros((0, d)))
        z = np.zeros(0, np.int32)
        return (out, z, z, np.zeros(0))
    u, start, counts = np.unique(rr, return_index=True,
                                 return_counts=True)
    seq = np.arange(len(rr))
    which = np.searchsorted(u, rr)
    slot = seq - start[which]
    deg = counts[which]        # per-entry degree of its row
    for d in rem_buckets:
        ud = u[counts == d]
        sel = deg == d
        cols_d = np.zeros((len(ud), d), np.int32)
        vals_d = np.zeros((len(ud), d))
        row_of = np.searchsorted(ud, rr[sel])
        cols_d[row_of, slot[sel]] = rc[sel]
        vals_d[row_of, slot[sel]] = rv[sel]
        out[d] = (ud.astype(np.int32), cols_d, vals_d)
    sp = deg > rem_buckets[-1]
    return (out, rr[sp].astype(np.int32), rc[sp].astype(np.int32),
            rv[sp])


@dataclass
class ExtraSlots:
    """Per-row-block extra-offset packing of a DiaPack remainder.

    The remainder of a Hilbert-ordered FEM operator is long-tailed in
    block offset (p99 reaches thousands of blocks — no fixed x-window
    covers it) but extremely CONCENTRATED per row block: at 1M DoF the
    top 4 distinct column blocks of each 128-row block hold 99% of the
    322k remainder entries.  This packs those entries as E "slots" per
    row block: slot e of block rb targets one column block tgt[rb, e]
    and holds at most one entry per local row — a (b,) weight vector
    plus a (b,) column-local index.  The matvec then needs ONE
    block-row x gather (nb*E rows of b lanes — the fast gather shape)
    and an E-way select-and-sum per row block inside the slab
    contraction (_xla_main), replacing most of the per-entry
    gather+scatter-add.  Entries that don't fit (beyond the top-E blocks, or
    duplicate rows within a slot) stay in the COO tail.
    """

    e: int                  # slots per row block
    nb: int                 # row blocks
    b: int
    tgt: np.ndarray         # (nb, e) int32 absolute target block;
    #                         unused slots self-target (weights are 0)
    idx: np.ndarray         # (n_placed,) int32 flat (rb*e + slot)*b + rl
    cls: np.ndarray         # (n_placed,) uint8/16 column-local index
    vals: np.ndarray        # (n_placed,) float64 weights
    tail_rows: np.ndarray   # row-sorted COO leftovers
    tail_cols: np.ndarray
    tail_vals: np.ndarray


_BUILD_SLOT_JIT = None


def _build_slot_tables(idx, vals, cls, nb: int, e: int, b: int):
    """Scatter the placed slot entries into dense (nb, E, b) weight and
    column-index tables on device (one cached jit shared across the
    hierarchy's to_device calls — one compile per shape)."""
    global _BUILD_SLOT_JIT
    if _BUILD_SLOT_JIT is None:
        import jax
        import jax.numpy as jnp

        @partial(jax.jit, static_argnames=("nb", "e", "b"))
        def build(idx, vals, cls, nb: int, e: int, b: int):
            flat = nb * e * b
            wslot = jnp.zeros(flat, vals.dtype).at[idx].set(
                vals, mode="promise_in_bounds", unique_indices=True)
            cslot = jnp.zeros(flat, jnp.int32).at[idx].set(
                cls.astype(jnp.int32), mode="promise_in_bounds",
                unique_indices=True)
            return wslot.reshape(nb, e, b), cslot.reshape(nb, e, b)

        _BUILD_SLOT_JIT = build
    return _BUILD_SLOT_JIT(idx, vals, cls, nb=nb, e=e, b=b)


def pack_extra_slots(pack: DiaPack, e_max: int = 4) -> ExtraSlots:
    """Assign remainder entries of `pack` to per-row-block extra slots.

    Greedy by block popularity: each row block's candidate (column
    block, duplicate-rank) groups are ranked by entry count and the top
    e_max become slots.  The duplicate rank splits multiple entries of
    the same (row, column block) — such a pair needs two slots with the
    same target — and guarantees at most one entry per (slot, local
    row), so the flat scatter indices are unique.
    """
    b = pack.b
    nb = pack.np_ // b
    rr = pack.rem_rows.astype(np.int64)
    rc = pack.rem_cols.astype(np.int64)
    rv = pack.rem_vals
    lo_t = np.uint8 if b <= 256 else np.uint16
    tgt = np.broadcast_to(
        np.arange(nb, dtype=np.int32)[:, None], (nb, e_max)).copy()
    if len(rr) == 0 or e_max == 0:
        z = np.zeros(0, np.int32)
        return ExtraSlots(
            e=e_max, nb=nb, b=b, tgt=tgt, idx=z,
            cls=np.zeros(0, lo_t), vals=np.zeros(0),
            tail_rows=pack.rem_rows, tail_cols=pack.rem_cols,
            tail_vals=pack.rem_vals)
    rb, rl = rr // b, rr % b
    cb, cl = rc // b, rc % b
    # Duplicate rank within (rb, cb, rl): the k-th entry of a row into
    # the same column block must go to a k-th slot with that target.
    key = (rb * nb + cb) * b + rl
    order = np.argsort(key, kind="stable")
    ks = key[order]
    grp_start = np.r_[True, ks[1:] != ks[:-1]]
    gid = np.cumsum(grp_start) - 1
    pos = np.arange(len(ks))
    rank = pos - pos[grp_start][gid]
    rank = np.minimum(rank, 15)
    # Candidate identity (rb, cb, rank) -> count; per-rb top-e_max win.
    ckey = (rb[order] * nb + cb[order]) * 16 + rank
    uc, inv_c, cnt = np.unique(ckey, return_inverse=True,
                               return_counts=True)
    crb = uc // (nb * 16)
    co = np.lexsort((-cnt, crb))
    crb_s = crb[co]
    cstart = np.r_[True, crb_s[1:] != crb_s[:-1]]
    cgid = np.cumsum(cstart) - 1
    cpos = np.arange(len(co))
    crank = cpos - cpos[cstart][cgid]
    slot_of = np.full(len(uc), -1, np.int64)
    slot_of[co] = np.where(crank < e_max, crank, -1)
    entry_slot = slot_of[inv_c]          # in `order` space
    placed = entry_slot >= 0

    rb_o, rl_o = rb[order], rl[order]
    cb_o, cl_o = cb[order], cl[order]
    rv_o = rv[order]
    tgt[rb_o[placed], entry_slot[placed]] = cb_o[placed]
    idx = ((rb_o[placed] * e_max + entry_slot[placed]) * b
           + rl_o[placed]).astype(np.int32)
    t_r, t_c, t_v = rr[order][~placed], rc[order][~placed], rv_o[~placed]
    t_order = np.argsort(t_r, kind="stable")
    return ExtraSlots(
        e=e_max, nb=nb, b=b, tgt=tgt, idx=idx,
        cls=cl_o[placed].astype(lo_t), vals=rv_o[placed],
        tail_rows=t_r[t_order].astype(np.int32),
        tail_cols=t_c[t_order].astype(np.int32),
        tail_vals=t_v[t_order])


def pack_dia(
    n: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    diag: Optional[np.ndarray] = None,
    offs: Optional[tuple] = None,
    b: int = DEFAULT_B,
    g: Optional[int] = None,
    coverage: float = 0.95,
    max_offsets: int = 8,
    np_override: Optional[int] = None,
) -> DiaPack:
    """Pack COO triplets (off-diagonal, duplicate-free) + diagonal.

    The caller is responsible for having permuted indices into a
    locality-preserving order (bell.hilbert_order) — the offset coverage
    and therefore the speed depend on it.

    np_override: force the padded length (must be a multiple of b and
    >= n); used by the aligned AMG hierarchy where each level's length
    is slot_count * child_length.  `g` is then chosen as the largest of
    (8, 4, 2, 1) dividing np_override / b.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    nat = None
    if len(rows) >= 200_000:
        # Native single-pass packer (offset histogram + split W index +
        # row-sorted remainder): replaces ~15 nnz-sized numpy
        # temporaries whose first-touch page faults dominate at
        # millions of entries (measured 4.8 s -> ~1 s at 6.5M nnz).
        from padne_tpu import native

        nat = native.pack_dia(b, rows, cols, vals, coverage, max_offsets,
                              offs=offs)
        offs = nat[0]
        rb = cb = bd0 = None
    elif offs is None and len(rows):
        # Share the block-index arrays with the packing below — the
        # rows//b / cols//b temporaries cost ~1 s at 6.5M nnz on a
        # page-fault-bound host.
        rb, cb = rows // b, cols // b
        bd0 = cb - rb
        offs = _offsets_from_bd(bd0, coverage, max_offsets)
    elif offs is None:
        offs = (0,)
        rb = cb = bd0 = None
    else:
        rb = cb = bd0 = None
    # The slot-table assignment below requires sorted offsets; an
    # unsorted caller-supplied tuple would silently misassign slots.
    offs = tuple(sorted(offs))
    d = len(offs)
    if np_override is not None:
        if np_override % b or np_override < n:
            raise ValueError("np_override must be a multiple of b and >= n")
        nb = np_override // b
        if g is None:
            g = next(gg for gg in (8, 4, 2, 1) if nb % gg == 0)
        elif nb % g:
            raise ValueError("np_override not divisible by g*b")
        ng = nb // g
        np_ = np_override
    else:
        g = g or DEFAULT_G
        nb = max((n + b - 1) // b, 1)
        ng = (nb + g - 1) // g
        np_ = ng * g * b

    diag_pad = np.zeros(np_, dtype=np.float64)
    if diag is not None:
        diag_pad[:n] = diag

    lo_t = np.uint8 if b <= 256 else np.uint16
    if nat is not None:
        _, hi, lo16, wv, rr, rcc, rv = nat
        return DiaPack(
            n=n, np_=np_, b=b, g=g, ng=ng, offs=offs,
            widx_hi=hi, widx_lo=lo16 if lo_t == np.uint16
            else lo16.astype(np.uint8),
            wval=wv, rem_rows=rr, rem_cols=rcc, rem_vals=rv,
            diag=diag_pad,
        )
    if len(rows) == 0:
        return DiaPack(
            n=n, np_=np_, b=b, g=g, ng=ng, offs=offs,
            widx_hi=np.zeros(0, np.int32), widx_lo=np.zeros(0, lo_t),
            wval=np.zeros(0),
            rem_rows=np.zeros(0, np.int32), rem_cols=np.zeros(0, np.int32),
            rem_vals=np.zeros(0), diag=diag_pad,
        )

    # Allocation-lean packing: the CI VM faults fresh pages in at
    # ~100-250 MB/s, so temporaries — not arithmetic — dominate at
    # millions of nnz.  Membership AND slot assignment come from one
    # small signed-slot table over the offset span (replaces np.isin +
    # searchsorted); the widx composition reuses the gathered arrays as
    # scratch.
    if rb is None:
        rb, cb = rows // b, cols // b
        bd0 = cb - rb
    bd = bd0
    off_arr = np.asarray(offs)
    dmin, dspan = int(off_arr[0]), int(off_arr[-1] - off_arr[0])
    lut_slot = np.full(dspan + 1, -1, dtype=np.int64)
    lut_slot[off_arr - dmin] = np.arange(d)
    np.subtract(bd, dmin, out=bd)
    # Unsigned trick: negatives wrap to huge values, so one comparison
    # covers both range ends.
    valid = bd.view(np.uint64) <= np.uint64(dspan)
    np.multiply(bd, valid, out=bd)          # clamp invalid to index 0
    slots = lut_slot[bd]
    sel = valid
    np.bitwise_and(sel, slots >= 0, out=sel)

    ds = slots[sel]
    r_s, c_s = rows[sel], cols[sel]
    rb_s, cb_s = rb[sel], cb[sel]
    # c_loc / r_loc in place, then the split index composed into rb_s:
    # W[gi, gg, ds, col_local, row_local] with gi*g + gg == row_block;
    # the kernel computes y^T_blk (R, B) += x^T_blk (R, B) @ W
    # (contraction over col_local).  widx_hi = (rb*d + ds)*b + c_loc,
    # widx_lo = row_local.
    np.multiply(cb_s, b, out=cb_s)
    np.subtract(c_s, cb_s, out=cb_s)        # cb_s = col_local; c_s free
    np.multiply(rb_s, b, out=c_s)
    np.subtract(r_s, c_s, out=r_s)          # r_s = row_local
    np.multiply(rb_s, d, out=rb_s)
    np.add(rb_s, ds, out=rb_s)
    np.multiply(rb_s, b, out=rb_s)
    np.add(rb_s, cb_s, out=rb_s)            # rb_s = widx_hi

    np.logical_not(sel, out=sel)
    rr, rc, rv = rows[sel], cols[sel], vals[sel]
    order = np.argsort(rr, kind="stable")
    np.logical_not(sel, out=sel)
    return DiaPack(
        n=n, np_=np_, b=b, g=g, ng=ng, offs=offs,
        widx_hi=rb_s.astype(np.int32), widx_lo=r_s.astype(lo_t),
        wval=vals[sel],
        rem_rows=rr[order].astype(np.int32),
        rem_cols=rc[order].astype(np.int32),
        rem_vals=rv[order], diag=diag_pad,
    )


def pack_ell_as_dia(ell, perm: Optional[np.ndarray] = None, **kw) -> DiaPack:
    """assembly.EllMatrix (optionally permuted by `perm`: new->old)
    -> DiaPack."""
    n, k = ell.cols.shape
    nz = ell.vals != 0
    rows = np.repeat(np.arange(n, dtype=np.int64), k)[nz.ravel()]
    cols = ell.cols.astype(np.int64).ravel()[nz.ravel()]
    vals = ell.vals.ravel()[nz.ravel()]
    diag = ell.diag
    if perm is not None:
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        rows, cols = inv[rows], inv[cols]
        diag = diag[perm]
    return pack_dia(n, rows, cols, vals, diag=diag, **kw)


def pack_csr_as_dia(a, **kw) -> DiaPack:
    """Square scipy CSR/COO (diagonal included in the matrix) -> DiaPack."""
    coo = a.tocoo()
    diag = np.asarray(a.diagonal(), dtype=np.float64)
    mask = coo.row != coo.col
    return pack_dia(
        a.shape[0], coo.row[mask].astype(np.int64),
        coo.col[mask].astype(np.int64), coo.data[mask], diag=diag, **kw,
    )


def pack_csr_pos_as_dia(a, pos, diag, np_override, b: int = DEFAULT_B,
                        coverage: float = 0.95,
                        max_offsets: int = 8) -> DiaPack:
    """Scipy CSR + padded-position map -> DiaPack (the AMG per-level
    shape: entry (i, j) lands at (pos[i], pos[j]), the diagonal is
    skipped and supplied pre-padded as `diag`).

    At production sizes this walks the CSR natively (pg_pack_dia_csr)
    — no permuted-COO numpy temporaries; small levels take the generic
    pack_dia path."""
    a = a.tocsr()
    if a.nnz >= 200_000:
        from padne_tpu import native

        nat = native.pack_dia_csr(a, pos, b, coverage, max_offsets)
        offs, hi, lo16, wv, rr, rcc, rv = nat
        nb = np_override // b
        g = next(gg for gg in (8, 4, 2, 1) if nb % gg == 0)
        ng = nb // g
        lo_t = np.uint8 if b <= 256 else np.uint16
        # n == np_override here, matching the generic path below (rows
        # arrive as padded positions, so the "logical" size is padded).
        return DiaPack(
            n=np_override, np_=np_override, b=b, g=g, ng=ng, offs=offs,
            widx_hi=hi, widx_lo=lo16 if lo_t == np.uint16
            else lo16.astype(np.uint8),
            wval=wv, rem_rows=rr, rem_cols=rcc, rem_vals=rv, diag=diag,
        )
    coo = a.tocoo()
    mask = coo.row != coo.col
    pos = np.asarray(pos, dtype=np.int64)
    return pack_dia(
        np_override, pos[coo.row[mask]], pos[coo.col[mask]],
        coo.data[mask], diag=diag, b=b, coverage=coverage,
        max_offsets=max_offsets, np_override=np_override,
    )


# ---------------------------------------------------------------------------
# Device matvec


def _dmax(offs) -> int:
    return max(max(abs(o) for o in offs), 1)


def _xla_main(meta, w, xt_pad, extra=None):
    """yt (R, np_) = OffDiag @ x: one einsum per offset over shifted
    slices of the halo-padded xt (R, np_ + 2*dmax*B), plus the
    ExtraSlots contribution when `extra` = (tgt, ci, we) is given."""
    import jax
    import jax.numpy as jnp

    np_, b, g, ng, offs = meta
    dmax = _dmax(offs)
    r = xt_pad.shape[0]
    nb = ng * g
    acc = jnp.zeros((nb, r, b), xt_pad.dtype)
    wb = w.reshape(nb, len(offs), b, b)
    for di, o in enumerate(offs):
        xs = jax.lax.dynamic_slice_in_dim(
            xt_pad, (dmax + o) * b, np_, axis=1)
        xsb = xs.reshape(r, nb, b)
        acc = acc + jax.lax.dot_general(
            xsb, wb[:, di].astype(xt_pad.dtype),
            (((2,), (1,)), ((1,), (0,))),
            preferred_element_type=xt_pad.dtype,
            # HIGHEST keeps f32 products exact f32 (a GPU may otherwise
            # run them in TF32); for f64 it has no effect.
            precision=(jax.lax.Precision.HIGHEST
                       if xt_pad.dtype == jnp.float32 else None))
    yt = acc.transpose(1, 0, 2).reshape(r, np_)
    if extra is not None:
        tgt, ci, we = extra
        n_e = we.shape[1]
        xb = jax.lax.dynamic_slice_in_dim(
            xt_pad, dmax * b, np_, axis=1).reshape(r, nb, b)
        xe = jnp.take(xb, tgt, axis=1).reshape(r, nb, n_e, b)
        sel = jnp.take_along_axis(xe, ci[None], axis=3)
        contrib = (we[None].astype(xt_pad.dtype) * sel).sum(axis=2)
        yt = yt + contrib.reshape(r, np_)
    return yt


def dia_matvec(meta, params, x, compute_dtype=None):
    """y = (Diag + OffDiag) @ x for (np_, R) or (np_,) x.  Jit-traceable;
    `meta` must be static under jit.

    The contraction follows the slab dtype unless compute_dtype
    overrides it — the f64 anchor residual passes float64 while reusing
    the f32 slab (cast per offset inside the einsum)."""
    import jax.numpy as jnp

    np_, b, g, ng, offs = meta
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    dmax = _dmax(offs)
    if compute_dtype is None:
        compute_dtype = params["w"].dtype
    xt = x.astype(compute_dtype).T
    xt_pad = jnp.pad(xt, ((0, 0), (dmax * b, dmax * b)))
    main = _xla_main(meta, params["w"], xt_pad,
                     extra=_slot_extra(params)).T
    main = _apply_remainder(params, x, main)
    y = main + params["diag"][:, None] * x
    y = y.astype(x.dtype)
    return y[:, 0] if squeeze else y


def dia_matvec_t(meta, params, xt, skip_remainder: bool = False):
    """Transposed-layout matvec: yt = ((Diag + OffDiag) @ xt.T).T for
    xt of shape (R, np_).

    The CG state lives in this (R, n) layout, so the slab contraction
    needs no transposes; only the remainder scatter needs the row layout
    and, above a size threshold, runs inside a transpose sandwich (see
    _apply_remainder_t).

    skip_remainder: apply only slab + diagonal (used for the V-cycle
    smoothing applications against the remainder-lumped diagonal)."""
    import jax.numpy as jnp

    np_, b, g, ng, offs = meta
    dmax = _dmax(offs)
    xt32 = xt.astype(params["w"].dtype)
    xt_pad = jnp.pad(xt32, ((0, 0), (dmax * b, dmax * b)))
    yt = _xla_main(meta, params["w"], xt_pad,
                   extra=None if skip_remainder else _slot_extra(params))
    yt = yt + params["diag"][None, :] * xt32
    has_rem = params["sp_rows"].shape[0] or any(
        params[f"r{d}_rows"].shape[0] for d in DiaPack.REM_BUCKETS)
    if not skip_remainder and has_rem:
        if _rem_count(params) <= _rem_t_max():
            yt = _apply_remainder_t(params, np_, b, xt32, yt)
        else:
            x = xt32.T
            rem = _apply_remainder(params, x, jnp.zeros_like(x))
            yt = yt + rem.T
    return yt.astype(xt.dtype)


def _slot_extra(params):
    """The (tgt, ci, we) ExtraSlots triple from a to_device params dict
    (None when the pack was built without slots)."""
    if "xs_tgt" not in params:
        return None
    return (params["xs_tgt"], params["xs_ci"], params["xs_w"])


def build_slabs(packs_and_dtypes) -> list:
    """Build several packs' weight slabs in ONE jitted program.

    [(pack, slab_dtype), ...] -> [w, ...].  Functionally identical to
    each pack's to_device slab scatter, but a single XLA executable
    (one compile and one dispatch instead of one per level).  Pass the
    returned slabs back into to_device(w=...)."""
    import jax
    import jax.numpy as jnp

    args = []
    meta = []
    for pack, st in packs_and_dtypes:
        d16, exc_i, exc_v = pack._hi_delta()
        wire = jnp.bfloat16 if st == jnp.bfloat16 else np.float32
        args += [jnp.asarray(d16), jnp.asarray(exc_i),
                 jnp.asarray(exc_v), jnp.asarray(pack.widx_lo),
                 jnp.asarray(pack.wval.astype(wire))]
        meta.append((pack.ng, pack.g, len(pack.offs), pack.b,
                     "bf16" if st == jnp.bfloat16 else "f32"))
    meta = tuple(meta)

    @partial(jax.jit, static_argnames=("meta",))
    def _many(meta, *flat):
        out = []
        for i, (ng, g, d, b, stname) in enumerate(meta):
            d16, exc_i, exc_v, lo, v = flat[5 * i:5 * i + 5]
            d32 = d16.astype(jnp.int32)
            if exc_i.shape[0]:
                d32 = d32.at[exc_i].set(exc_v)
            hi = jnp.cumsum(d32)
            total = ng * g * d * b * b
            it = jnp.int64 if total >= 2**31 else jnp.int32
            idx = hi.astype(it) * b + lo.astype(it)
            w = jnp.zeros(total, v.dtype)
            w = w.at[idx].set(v, mode="promise_in_bounds",
                              unique_indices=True)
            st = jnp.bfloat16 if stname == "bf16" else jnp.float32
            out.append(w.reshape(ng, g, d, b, b).astype(st))
        return tuple(out)

    return list(_many(meta, *args))


def slots_env(default: int = 8) -> int:
    """Per-row-block extra-slot count for production LEVEL-0 operators
    (PADNE_TPU_SLOTS; 0 disables).  Default 8: at the 1M bench the
    slots absorb ~99% of the level-0 remainder into the slab
    contraction (E=8 leaves a lumped-smoother tail of ~8k entries vs
    ~38k at E=4).  Deep V-cycle levels never pack slots regardless of
    this value (see make_vcycle_dia)."""
    import os

    try:
        return max(0, int(os.environ.get("PADNE_TPU_SLOTS", default)))
    except ValueError:
        return default


def rem_gather_enabled() -> bool:
    """Whether to_device builds the gather-merge remainder map
    (PADNE_TPU_REM_GATHER; default off, not measured on the GPU)."""
    import os

    return os.environ.get("PADNE_TPU_REM_GATHER", "0") != "0"


def _apply_remainder(params, x, y):
    """y += Remainder @ x in the (np_, R) layout.

    Per-degree buckets gather only real entries.  With the rg_map
    present (to_device under PADNE_TPU_REM_GATHER) the bucket
    contributions concatenate into one (U+1, R) table — zero row last —
    and merge into y with a single row GATHER through the inverse map;
    otherwise they go through one sorted-unique-index scatter per
    bucket.  The spill COO (degree > max-bucket outlier rows) always
    uses the small duplicate-handling scatter."""
    import jax
    import jax.numpy as jnp

    parts = [] if "rg_map" in params else None
    for d in DiaPack.REM_BUCKETS:
        rows_d = params[f"r{d}_rows"]
        if not rows_d.shape[0]:
            continue
        vals_d = params[f"r{d}_vals"]
        cols_d = params[f"r{d}_cols"]
        contrib = vals_d[:, 0, None] * x[cols_d[:, 0]]
        for k in range(1, d):
            contrib = contrib + vals_d[:, k, None] * x[cols_d[:, k]]
        if parts is not None:
            parts.append(contrib.astype(y.dtype))
            continue
        # Each bucket's rows are sorted and unique — the fast scatter
        # lowering (one scatter per bucket beats one merged unsorted
        # scatter).
        y = jax.lax.scatter_add(
            y, rows_d[:, None], contrib.astype(y.dtype),
            jax.lax.ScatterDimensionNumbers(
                update_window_dims=(1,), inserted_window_dims=(0,),
                scatter_dims_to_operand_dims=(0,)),
            indices_are_sorted=True, unique_indices=True,
            mode=jax.lax.GatherScatterMode.FILL_OR_DROP)
    if parts:
        table = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        table = jnp.concatenate(
            [table, jnp.zeros((1, table.shape[1]), table.dtype)])
        y = y + table[params["rg_map"]]
    if params["sp_rows"].shape[0]:
        sp = params["sp_vals"][:, None] * x[params["sp_cols"]]
        y = y.at[params["sp_rows"]].add(sp.astype(y.dtype), mode="drop")
    return y


def _rem_count(params) -> int:
    """Total remainder entries in a to_device params dict (tail after
    slot packing).  Static under jit — derived from array shapes."""
    n = int(params["sp_rows"].shape[0])
    for d in DiaPack.REM_BUCKETS:
        n += int(params[f"r{d}_rows"].shape[0]) * d
    return n


def _rem_t_max(default: int = 32768) -> int:
    """Entry-count ceiling for the transposed remainder path
    (PADNE_TPU_REM_T). Above it, the (R, n) block-gather materializes
    too much intermediate and the transpose sandwich wins.

    Captured at TRACE time (like the build-time knobs, e.g.
    PADNE_TPU_DEEP_T): changing the env var after a jitted caller has
    compiled has no effect until that caller is re-traced."""
    import os

    return int(os.environ.get("PADNE_TPU_REM_T", default))


def _apply_remainder_t(params, np_: int, b: int, xt, yt):
    """yt += Remainder @ x computed ENTIRELY in the (R, np_) layout.

    The normal remainder path transposes the full (R, n) operand to
    (n, R) and back around the gather/scatter — two full-array
    relayouts whose cost does not shrink with the number of remainder
    entries.  For small tails (the lumped
    smoothing operator after slot packing keeps only a few thousand
    strong entries) this path stays transposed:

    * gather: whole 128-lane column BLOCKS via jnp.take on the block
      axis (the same block gather as the slot xe stream),
      then a one-hot multiply-sum selects the lane — no per-element
      random access;
    * scatter: one sorted-unique axis-1 scatter-add per degree bucket.
      Minor-axis scatters are slower per entry than axis-0 ones, but on
      a few-thousand-entry tail that is microseconds against the
      milliseconds the relayouts cost.
    """
    import jax.numpy as jnp

    r = xt.shape[0]
    nb = np_ // b
    xb = xt.reshape(r, nb, b)
    lane = jnp.arange(b, dtype=jnp.int32)

    # Entries per gather chunk: bounds the (r, chunk, b) block-gather
    # transient to ~33 MB at R=8/f32 instead of growing with the whole
    # tail (134 MB at the 32768-entry ceiling).
    sel_chunk = 8192

    def select_chunk(cols_flat):
        xg = jnp.take(xb, cols_flat // b, axis=1)        # (r, m, b)
        oh = (cols_flat % b)[:, None] == lane[None, :]   # (m, b)
        return (xg * oh[None].astype(xt.dtype)).sum(-1)  # (r, m)

    def select(cols_flat):
        m = cols_flat.shape[0]
        if m <= sel_chunk:
            return select_chunk(cols_flat)
        return jnp.concatenate(
            [select_chunk(cols_flat[s:s + sel_chunk])
             for s in range(0, m, sel_chunk)], axis=1)

    for d in DiaPack.REM_BUCKETS:
        rows_d = params[f"r{d}_rows"]
        if not rows_d.shape[0]:
            continue
        vals_d = params[f"r{d}_vals"]
        cols_d = params[f"r{d}_cols"]
        sel = select(cols_d.reshape(-1))
        contrib = (vals_d.reshape(-1)[None] * sel).reshape(
            r, -1, d).sum(-1)
        yt = yt.at[:, rows_d].add(contrib.astype(yt.dtype), mode="drop",
                                  unique_indices=True,
                                  indices_are_sorted=True)
    if params["sp_rows"].shape[0]:
        sel = select(params["sp_cols"])
        sp = params["sp_vals"][None] * sel
        # Spill rows may repeat (duplicate-handling scatter).
        yt = yt.at[:, params["sp_rows"]].add(sp.astype(yt.dtype),
                                             mode="drop")
    return yt


def coo_from_widx(meta, hi, lo):
    """Reconstruct per-entry (rows, cols) of the slab's main entries
    from the device widx split (params["_hi"]/["_lo"], to_device with
    keep_widx=True).  Jit-traceable; used to overlay nnz-sized value
    corrections (e.g. the f32→f64 value residue in the anchor residual)
    without uploading index arrays a second time.

    widx_hi = (rb * d + slot) * b + col_local, widx_lo = row_local.
    """
    import jax.numpy as jnp

    np_, b, g, ng, offs = meta
    d = len(offs)
    offs_arr = jnp.asarray(np.asarray(offs, np.int32))
    c_loc = hi % b
    t = hi // b
    slot = t % d
    rb = t // d
    rows = rb * b + lo.astype(jnp.int32)
    cols = (rb + offs_arr[slot]) * b + c_loc
    return rows, cols


# a64 ≈ a32 * (1 + q * RATIO16_SCALE) with q int16 — see ratio16_encode.
RATIO16_SCALE = 2.0 ** -24 / 32767.0


def ratio16_encode(a64) -> np.ndarray:
    """int16 fixed-point ratio residue of a float64 stream against its
    own float32 rounding: a64 ≈ a32 * (1 + q * RATIO16_SCALE).

    For normal a32 the half-ulp bound gives |(a64-a32)/a32| <= 2^-24,
    so q = round(ratio * 2^24 * 32767) fits int16 with a uniform
    quantization step of 2^-24/32767 ≈ 2^-39 relative — the residue
    uploads as 2 bytes/entry instead of the 4-8 of a direct f32/f64
    stream, at an operator error two decades below f64 refinement
    floors.  Zero a32 (a64 underflowed f32) encodes as 0 and subnormal
    blow-ups clip; both leave an absolute error under the f32 subnormal
    half-ulp (~7e-46) — far below any physical matrix scale.
    """
    a64 = np.asarray(a64, np.float64)
    with np.errstate(over="ignore"):
        a32 = a64.astype(np.float32).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        # isfinite guard: a64 beyond f32 range (a32 = inf) would make
        # the ratio NaN and the int16 cast undefined; q=0 keeps the
        # encode well-defined (the widened value is then a32 itself,
        # i.e. the non-finite input stays visibly non-finite).
        ok = (a32 != 0.0) & np.isfinite(a32)
        r = np.where(ok, (a64 - a32) / np.where(ok, a32, 1.0), 0.0)
    q = np.rint(np.clip(r / RATIO16_SCALE, -32767.0, 32767.0))
    return q.astype(np.int16)


def ratio16_widen(a32_dev, q_dev):
    """Device decode of ratio16_encode: float64 a32 * (1 + q*scale)."""
    import jax.numpy as jnp

    return a32_dev.astype(jnp.float64) * (
        1.0 + q_dev.astype(jnp.float64) * RATIO16_SCALE)


def pad_to(x, np_: int):
    """Zero-pad axis 0 of an (n, ...) array to the DIA padded length."""
    import jax.numpy as jnp

    pad = np_ - x.shape[0]
    if pad == 0:
        return x
    return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

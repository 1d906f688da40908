"""Exact operator for the refinement residual, resident on the device.

The refinement ladder needs the TRUE (f64) full-system residual after
every pass.  The reference gets it for free (float64 CPU solve,
reference solver.py:767-780); here the resident CG operator is f32, so
without this module every pass would download v, run an f64 CSR SpMV
on the host and upload the residual again.

At setup this module builds an ELL view of the EXACT level-0 operator
ON DEVICE — rows/cols reconstructed from the already-resident widx
split (dia.coo_from_widx), hi values gathered from the resident slab,
and the f32->f64 value residue shipped as exact f32 lo-halves (~2^-48
relative operator error; see _f32_lo for why the int16 ratio residue is
not tight enough) — so the only new uploads are the 4 B/nnz lo streams
and the small raw remainder.  Per call, `matvec` then evaluates
y = A64 @ x for f32 x with ~1e-13 relative accuracy, in one of two
modes:

* mode="f64" (the solver's default): the ELL products in native f64;
* mode="dekker": k ELL products per row in f32 with Dekker two-product
  error capture (split-based, safe without FMA guarantees), summed
  with an exact Knuth two-sum chain — the value residue rides along at
  f32.

Both modes evaluate the diagonal in f64 and the high-degree tail (rows
with more than k entries) as a tiny f64 scatter-add, and are exact
enough that the refinement ladder converges to 1e-8 relative entirely
on device: one rc upload, one v download, nothing n-sized in between.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np


def _split(a):
    """Dekker split: a == ah + al with ah carrying <= 12 mantissa bits,
    so products of two "h"/"l" halves are exact in f32."""
    c = a * 4097.0          # 2**12 + 1
    ah = c - (c - a)
    return ah, a - ah


def _two_prod(a, b):
    """p + e == a * b exactly (f32, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


@dataclass
class CompOperator:
    """Device-resident compensated exact operator (see module doc)."""

    np0: int
    k: int
    tail_n: int
    mode: str
    params: dict            # device arrays, see build()


def _require_x64(jax) -> None:
    """The compensated operator stores f64 tails and int64 slab gather
    indices; with jax_enable_x64 off JAX silently downcasts both,
    corrupting indices for slabs >= 2^31 elements and defeating the
    accuracy claim.  Fail fast for direct callers (schur gates
    want_comp on x64 already)."""
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "comp.build() requires jax_enable_x64 (f64 tails + int64 "
            "slab indices); enable x64 or use the plain f32 operator")


def _host_degrees(pack) -> np.ndarray:
    """Per-(padded-)row entry count of the exact operator, main slab +
    remainder, computed from the host pack arrays."""
    b, d = pack.b, len(pack.offs)
    rb = (pack.widx_hi // b) // d
    rows_main = rb * b + pack.widx_lo.astype(np.int64)
    deg = np.bincount(rows_main, minlength=pack.np_)
    if len(pack.rem_rows):
        deg = deg + np.bincount(pack.rem_rows, minlength=pack.np_)
    return deg


def choose_k(pack, k_cap: int = 10) -> tuple[int, int]:
    """(k, tail_n): smallest ELL width k <= k_cap whose over-degree
    tail stays tiny (<= max(4096, nnz/500) entries)."""
    deg = _host_degrees(pack)
    nnz = int(deg.sum())
    budget = max(4096, nnz // 500)
    for k in range(4, k_cap + 1):
        tail = int(np.maximum(deg - k, 0).sum())
        if tail <= budget:
            return k, tail
    return k_cap, int(np.maximum(deg - k_cap, 0).sum())


def build(meta, op_params, pack, mode: str = "dekker",
          k_cap: int = 10) -> CompOperator:
    """Build the compensated operator from an exact-operator params
    dict holding the widx split (to_device(keep_widx=True)) plus the
    host pack (for the ratio streams and raw remainder).

    Uploads: int16 ratio streams (slab + diag + remainder) and the raw
    remainder triplets — ~2-14 B/entry on only the small streams; the
    nnz-sized index/value data is reconstructed from resident arrays.
    """
    import jax
    import jax.numpy as jnp

    from . import dia

    _require_x64(jax)
    np_, b, g, ng, offs = meta
    d = len(offs)
    hi_dev, lo_dev = op_params["_hi"], op_params["_lo"]
    w_dev = op_params["w"]
    if w_dev.dtype != jnp.float32:
        raise ValueError("comp build needs the f32 exact slab")

    k, tail_n = choose_k(pack, k_cap)

    def _f32_lo(a64):
        """Exact f32 lo-half of an f64 stream: a64 ≈ f32(a64) + lo with
        |lo| <= ulp32/2 and the lo itself f32-rounded — a combined
        representation error ~2^-48 relative.  An int16 ratio residue
        (dia.ratio16_encode, 2^-39) is NOT enough here: at production
        conductance scales (|a| ~ 2e3 S) and volt-scale fields the
        2^-39 operator quantization alone floors the 1M-DoF full-system
        residual at ~1.9e-6 absolute ≈ 1.2e-7 relative — ABOVE the
        1e-8 refinement target (see test_comp's cancellation test)."""
        a64 = np.asarray(a64, np.float64)
        return (a64 - a64.astype(np.float32).astype(np.float64)
                ).astype(np.float32)

    # Uploads: f32 lo-half value streams + the raw remainder (the
    # nnz-sized hi values and all indices stay resident/derived), in
    # one batched device_put.
    up = jax.device_put({
        "lo_slab": _f32_lo(pack.wval),
        "lo_diag": _f32_lo(pack.diag),
        "rem_r": pack.rem_rows.astype(np.int32),
        "rem_c": pack.rem_cols.astype(np.int32),
        "rem_v32": pack.rem_vals.astype(np.float32),
        "rem_lo": _f32_lo(pack.rem_vals),
    })
    lo_slab, lo_diag = up["lo_slab"], up["lo_diag"]
    rem_r, rem_c = up["rem_r"], up["rem_c"]
    rem_v32, rem_lo = up["rem_v32"], up["rem_lo"]

    @partial(jax.jit, static_argnames=("k", "tail_n"))
    def _build(hi, lo, w, lo_slab, lo_diag, diag32, rem_r, rem_c,
               rem_v32, rem_lo, k: int, tail_n: int):
        rows_m, cols_m = dia.coo_from_widx(meta, hi, lo)
        idx = hi.astype(jnp.int64) * b + lo.astype(jnp.int64)
        v_m = w.reshape(-1)[idx]
        lo_m = lo_slab
        lo_r = rem_lo
        rows = jnp.concatenate([rows_m, rem_r])
        cols = jnp.concatenate([cols_m, rem_c])
        vals = jnp.concatenate([v_m, rem_v32])
        vlo = jnp.concatenate([lo_m, lo_r])

        order = jnp.argsort(rows)
        rows_s = rows[order]
        # rank of each entry within its row (stable sort keeps this
        # well-defined); entries with rank >= k spill to the f64 tail.
        starts = jnp.searchsorted(rows_s, jnp.arange(np_,
                                                     dtype=rows_s.dtype))
        rank = jnp.arange(rows.shape[0], dtype=jnp.int32) - starts[
            rows_s].astype(jnp.int32)
        in_ell = rank < k
        # ELL scatter; spill entries route to a dropped dummy row.
        tgt_row = jnp.where(in_ell, rows_s, np_)
        tgt_rank = jnp.minimum(rank, k - 1)
        ell_cols = jnp.zeros((np_ + 1, k), jnp.int32).at[
            tgt_row, tgt_rank].set(cols[order], mode="drop")[:np_]
        ell_vals = jnp.zeros((np_ + 1, k), jnp.float32).at[
            tgt_row, tgt_rank].set(vals[order], mode="drop")[:np_]
        ell_lo = jnp.zeros((np_ + 1, k), jnp.float32).at[
            tgt_row, tgt_rank].set(vlo[order], mode="drop")[:np_]
        # Static-size tail: spill entries sort first on the (stable)
        # in_ell key.
        spill = jnp.argsort(in_ell)[:tail_n]
        tail_rows = rows_s[spill]
        tail_cols = cols[order][spill]
        tail_vals = (vals[order][spill].astype(jnp.float64)
                     + vlo[order][spill].astype(jnp.float64))
        diag64 = diag32.astype(jnp.float64) + lo_diag.astype(
            jnp.float64)
        return (ell_cols, ell_vals, ell_lo, tail_rows, tail_cols,
                tail_vals, diag64)

    (ell_cols, ell_vals, ell_lo, tail_rows, tail_cols, tail_vals,
     diag64) = _build(hi_dev, lo_dev, w_dev, lo_slab, lo_diag,
                      op_params["diag"], rem_r, rem_c, rem_v32, rem_lo,
                      k=k, tail_n=tail_n)
    params = {
        "ell_cols": ell_cols, "ell_vals": ell_vals, "ell_lo": ell_lo,
        "tail_rows": tail_rows, "tail_cols": tail_cols,
        "tail_vals": tail_vals, "diag64": diag64,
    }
    return CompOperator(np0=np_, k=k, tail_n=tail_n, mode=mode,
                        params=params)


def matvec(op: CompOperator, params: dict, x32):
    """y = A64 @ x for f32 x, as float64, ~1e-13 relative accuracy.
    Jit-traceable; `params` is passed explicitly so the arrays enter
    jitted programs as arguments, not inlined constants."""
    import jax.numpy as jnp

    cols = params["ell_cols"]
    v = params["ell_vals"]
    xg = x32[cols]                                   # (np0, k)
    if op.mode == "f64":
        y = (v.astype(jnp.float64) * xg.astype(jnp.float64)).sum(1)
        y = y + (params["ell_lo"] * xg).astype(jnp.float64).sum(1)
    else:
        p, e = _two_prod(v, xg)
        hi = p[:, 0]
        lo = jnp.zeros_like(hi)
        for i in range(1, op.k):
            s = hi + p[:, i]
            t = s - hi
            err = (hi - (s - t)) + (p[:, i] - t)
            hi, lo = s, lo + err
        low = lo + e.sum(1) + (params["ell_lo"] * xg).sum(1)
        y = hi.astype(jnp.float64) + low.astype(jnp.float64)
    y = y + params["diag64"] * x32.astype(jnp.float64)
    if op.tail_n:
        y = y.at[params["tail_rows"]].add(
            params["tail_vals"] * x32[params["tail_cols"]].astype(
                jnp.float64),
            mode="drop")
    return y

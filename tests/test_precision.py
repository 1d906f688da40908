"""Every f32 contraction on the solve path states Precision.HIGHEST.

A GPU may run a DEFAULT-precision f32 dot_general in TF32 (~3 decimal
digits).  The CG operator, the deflation projector, the V-cycle, the
Schur reconstruction and the power density must keep full f32 products,
so each traced program is searched for f32 dot_generals without HIGHEST.
"""

import numpy as np
import pytest

import jax
import jax.extend.core as jcore
import jax.numpy as jnp

from padne_tpu.ops import amg, assembly, cg, dia, postproc, schur

from test_schur_dia import make_system


def _subjaxprs(params):
    for v in params.values():
        items = v if isinstance(v, (tuple, list)) else (v,)
        for it in items:
            if isinstance(it, jcore.ClosedJaxpr):
                yield it.jaxpr
            elif isinstance(it, jcore.Jaxpr):
                yield it


def f32_dots(jaxpr):
    """Precisions of the all-f32 dot_generals in a jaxpr and all its
    sub-jaxprs."""
    found = []
    stack = [jaxpr]
    while stack:
        jx = stack.pop()
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                dts = {v.aval.dtype for v in eqn.invars}
                if dts == {np.dtype(np.float32)}:
                    found.append(eqn.params["precision"])
            stack.extend(_subjaxprs(eqn.params))
    return found


def _assert_highest(fn, *args):
    found = f32_dots(jax.make_jaxpr(fn)(*args).jaxpr)
    assert found, "no f32 dot_general traced: the check saw nothing"
    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    bad = [p for p in found if p != hi]
    assert not bad, f"{len(bad)}/{len(found)} f32 dots lack HIGHEST: {bad}"


@pytest.fixture(scope="module")
def dia_solver():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADNE_TPU_COARSE_SIZE", "200")
        return schur.DiaBorderedSolver(
            make_system(g=40, with_regulator=True))


def _ell_system(n=600, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    extra = rng.integers(0, n, (n, 2))
    edges = np.concatenate([edges, extra[extra[:, 0] != extra[:, 1]]])
    return assembly.build_ell(n, edges.astype(np.int64),
                              rng.random(len(edges)) + 0.5)


def case_dia_cg(s):
    """The DIA path's CG: slab operator, V-cycle and projector."""
    b = jnp.ones((s.np0, s.m + 1), jnp.float32)
    return lambda b: s.cg_solver(b, 1e-6, 3), b


def case_ell_cg(s):
    """The generic path's CG with its ELL V-cycle, f32."""
    ell = _ell_system()
    h = amg.build_hierarchy(ell)
    vc = amg.make_vcycle(h, dtype=jnp.float32)
    cols, vals, diag = ell.to_device(dtype=jnp.float32)
    comp = jnp.asarray(np.arange(600) % 3)
    solver = cg.make_pcg(cols, vals, diag, comp, 3, precond=vc)
    b = jnp.ones((600, 2), jnp.float32)
    return lambda b: solver(b, 1e-6, 3), b


def case_projector(s):
    project = cg.make_projector(jnp.asarray(np.arange(500) % 4), 4)
    return project, jnp.ones((500, 3), jnp.float32)


def case_schur_combine(s):
    x = jnp.ones((s.np0, s.m + 1), jnp.float32)
    j = jnp.ones(s.m, jnp.float32)
    c = jnp.ones(s.p + 1, jnp.float32)
    return (lambda x: s._combine(x, j, c, s.comp_pad_dev)), x


def case_schur_refine(s):
    s._join_comp()
    x = jnp.ones((s.np0, s.m), jnp.float32)
    xr = jnp.ones(s.np0, jnp.float32)
    r64 = jnp.zeros(s.np0, jnp.float64)
    dj = jnp.ones(s.m, jnp.float32)
    c = jnp.ones(s.p + 1, jnp.float32)
    c_ = s._comp
    return (lambda x: c_["update"](c_["op"].params, x, r64, r64, xr, dj,
                                   c)), x


def case_power_density(s):
    v = jnp.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    t = jnp.asarray([[0, 1, 2]], jnp.int32)
    return (lambda val: postproc.power_density(
        v.astype(jnp.float32), t, val, 2.0)), jnp.ones(3, jnp.float32)


CASES = [case_dia_cg, case_ell_cg, case_projector, case_schur_combine,
         case_schur_refine, case_power_density]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_f32_dots_are_highest(case, dia_solver):
    fn, arg = case(dia_solver)
    _assert_highest(fn, arg)


def test_slab_contraction_is_highest():
    """ops.dia's einsum itself, outside any solver."""
    rng = np.random.default_rng(0)
    n = 700
    rows = rng.integers(0, n, 3000)
    cols = np.clip(rows + rng.integers(-40, 41, 3000), 0, n - 1)
    keep = rows != cols
    pk = dia.pack_dia(n, rows[keep], cols[keep], rng.random(keep.sum()),
                      diag=np.ones(n))
    params = pk.to_device()
    xt = jnp.ones((2, pk.np_), jnp.float32)
    _assert_highest(lambda xt: dia.dia_matvec_t(pk.meta, params, xt), xt)

"""End-to-end solves on GENERATED fixture boards.

This tier keeps the strongest correctness gate alive without the
read-only reference mount (tests/test_boards.py skips when it is
absent): every scenario class is generated by tests/boardgen.py and
must load, solve, and pass the residual gate plus a per-board physics
check.  Reference counterparts: the fixture-board tier,
reference test_solver.py:1117-1444 + conftest.py:30-101.
"""

import warnings

import numpy as np
import pytest

import boardgen
from padne_tpu import kicad, solver


@pytest.fixture(scope="module")
def boards(tmp_path_factory):
    return boardgen.generate_all(tmp_path_factory.mktemp("gen_boards"))


def _solve(boards, name):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prob = kicad.load_kicad_project(
            boards / name / f"{name}.kicad_pro")
    # A directive the grammar does not recognize silently drops the
    # element, leaving a weaker board than the scenario intends — any
    # such warning means the FIXTURE is broken (this bit us once:
    # "RESISTOR" vs "RESISTANCE").
    unknown = [str(w.message) for w in caught
               if "Unknown directive" in str(w.message)]
    assert not unknown, f"generated board {name} has bad directives: {unknown}"
    with np.errstate(all="ignore"):
        sol = solver.solve(prob)
    return prob, sol


def _probe(sol, x, y, layer_idx=0):
    """Potential at the mesh vertex nearest (x, y) on a layer."""
    ls = sol.layer_solutions[layer_idx]
    best = (np.inf, None)
    for m, pot in zip(ls.meshes, ls.potentials):
        d = np.hypot(m.vertices[:, 0] - x, m.vertices[:, 1] - y)
        k = int(np.argmin(d))
        if d[k] < best[0]:
            best = (float(d[k]), float(pot.values[k]))
    assert best[0] < 0.75, f"no mesh vertex near ({x}, {y})"
    return best[1]


def _all_potentials(sol):
    out = []
    for ls in sol.layer_solutions:
        for zf in ls.potentials:
            out.append(np.asarray(zf.values))
    return np.concatenate(out) if out else np.zeros(0)


ALL_GENERATED = [
    "gen_strip", "gen_two_layer_via", "gen_zone_plane",
    "gen_rotated_pads", "gen_overlapping_vias", "gen_via_stack_4layer",
    "gen_floating_island", "gen_regulator", "gen_resistor_divider",
]


@pytest.mark.parametrize("name", ALL_GENERATED)
def test_generated_board_solves(boards, name):
    _, sol = _solve(boards, name)
    v = _all_potentials(sol)
    assert len(v) > 0
    assert np.isfinite(v).all()
    # the reference's global residual gate (test_solver.py:2083-2089)
    assert sol.solver_info.residual_norm < 1e-9


def test_strip_voltage_span(boards):
    # 1 V source across the strip: potentials span ~1 V
    _, sol = _solve(boards, "gen_strip")
    v = _all_potentials(sol)
    assert abs((v.max() - v.min()) - 1.0) < 1e-6


def test_via_stack_4layer_has_4_copper_layers(boards):
    prob, sol = _solve(boards, "gen_via_stack_4layer")
    assert len(prob.layers) == 4
    # current flows F.Cu -> via chain -> B.Cu: each intermediate layer
    # carries an annular ring around the via
    assert len(sol.layer_solutions) == 4


def test_floating_island_is_dropped(boards):
    prob, sol = _solve(boards, "gen_floating_island")
    # one live mesh carries the solve; the island shows up as a
    # disconnected display mesh
    n_disc = sum(len(ls.disconnected_meshes) for ls in sol.layer_solutions)
    assert n_disc >= 1
    v = _all_potentials(sol)
    assert abs((v.max() - v.min()) - 2.0) < 1e-6


def test_overlapping_vias_union_holes(boards):
    prob, _ = _solve(boards, "gen_overlapping_vias")
    # both via barrels produce networks; geometry loads without slivers
    assert len(prob.networks) >= 2


# Trace geometry shared by the regulator/divider scenarios: 12 mm x
# 1.5 mm x 35 um copper -> 8 squares at ~4.8e-4 ohm/sq.
_TRACE_R = 8.0 / (5.95e4 * 0.035)


def test_regulator_sets_output_rail(boards):
    _, sol = _solve(boards, "gen_regulator")
    v = _all_potentials(sol)
    assert np.isfinite(v).all()
    # The source pins the input rail at exactly 5 V above ground and the
    # regulator pins its output at exactly 3.3 V (both are hard MNA
    # constraints at the pad vertices).
    assert _probe(sol, 100, 100) - _probe(sol, 100, 108) == pytest.approx(
        5.0, abs=1e-6)
    assert _probe(sol, 100, 104) - _probe(sol, 106, 108) == pytest.approx(
        3.3, abs=1e-6)
    # Load current ~3.3/10 A flows OUT(U2->TPO) and back GND(TPG->UG):
    # the copper drop along the output trace proves the load is wired.
    i_load = 3.3 / (10.0 + 2 * _TRACE_R)
    drop_out = _probe(sol, 100, 104) - _probe(sol, 112, 104)
    assert drop_out == pytest.approx(i_load * _TRACE_R, rel=0.6)
    # The regulator mirrors gain * i_load into the input rail: the input
    # trace TPI->U1 carries ~0.9 * i_load (reference solver.py:512-538).
    drop_in = abs(_probe(sol, 100, 100) - _probe(sol, 112, 100))
    assert drop_in == pytest.approx(0.9 * i_load * _TRACE_R, rel=0.6)


def test_resistor_divider_current_path(boards):
    _, sol = _solve(boards, "gen_resistor_divider")
    v = _all_potentials(sol)
    # 1 V forced across the series path; both islands hold potentials
    # within the source span
    assert v.max() - v.min() <= 1.0 + 1e-6
    assert v.max() - v.min() > 0.9  # most of the drop is across the 100R
    # ~10 mA flows through the 100R bridge; each island's trace drop is
    # i * R_trace (~38 uV) — zero if the resistor element were dropped.
    i = 1.0 / (100.0 + 2 * _TRACE_R)
    drop_a = _probe(sol, 100, 100) - _probe(sol, 112, 100)
    assert drop_a == pytest.approx(i * _TRACE_R, rel=0.6)
    gap = _probe(sol, 112, 100) - _probe(sol, 120, 100)
    assert gap == pytest.approx(i * 100.0, rel=0.01)


@pytest.mark.parametrize("name", ["gen_resistor_divider", "gen_regulator"])
def test_mixed_precision_escalation(boards, name):
    """The accelerator path (f32 inner + f64 refinement) must reach
    the f64 answer even when kappa(A)*eps32 > 1 makes f32 refinement
    flatline.  Regression: gen_resistor_divider (milliohm couplings
    against ~38 uV trace drops) stalled at max|dV| ~2e-2 V until
    solve_bordered learned to escalate the inner solve to f64; the
    reference has no analog (scipy is all-f64, solver.py:767-780)."""
    import jax.numpy as jnp

    from padne_tpu.ops import schur

    prob = kicad.load_kicad_project(boards / name / f"{name}.kicad_pro")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        system, *_ = solver.build_system(prob)
        r64 = schur.solve_bordered(system)
        r32 = schur.solve_bordered(system, device_dtype=jnp.float32)
    assert r32.residual_norm < 1e-9
    assert np.abs(r64.v - r32.v).max() < 1e-8


@pytest.mark.parametrize("name", ALL_GENERATED)
def test_scipy_parity_generated(boards, name):
    """1e-6 V parity vs a scipy direct solve of the same assembled
    system, swept over the generated scenarios (the reference-board
    sweep in test_boards.py needs the read-only mount; this tier is
    always on).  Regression: a stall-exit window applied to the f64
    inner CG silently cost 2e-2 V on gen_resistor_divider."""
    import scipy.sparse.linalg

    from padne_tpu.ops import schur

    prob = kicad.load_kicad_project(boards / name / f"{name}.kicad_pro")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        system, *_ = solver.build_system(prob)
        if system.n == 0 or system.border.m <= 1:
            pytest.skip("degenerate board: no live core system")
        result = schur.solve_bordered(system)
        L, r = solver.system_to_scipy(system)
        z = scipy.sparse.linalg.spsolve(L.tocsc(), r)
    if not np.isfinite(z).all():
        pytest.skip("scipy direct solve is singular for this board")
    assert np.abs(z[: system.n] - result.v).max() < 1e-6

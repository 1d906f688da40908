import math
import warnings

import numpy as np
import pytest

from padne_tpu import geom, mesh, problem, solver


def find_vertex_value(sol: solver.Solution, conn: problem.Connection) -> float:
    """Voltage at the mesh vertex closest to the connection point."""
    layer_idx = next(
        i for i, l in enumerate(sol.problem.layers) if l is conn.layer
    )
    ls = sol.layer_solutions[layer_idx]
    best = (np.inf, None)
    for m, pot in zip(ls.meshes, ls.potentials):
        d = np.hypot(m.vertices[:, 0] - conn.point.x, m.vertices[:, 1] - conn.point.y)
        k = int(np.argmin(d))
        if d[k] < best[0]:
            best = (float(d[k]), float(pot.values[k]))
    assert best[0] < 1e-4, f"no vertex near {conn.point}"
    return best[1]


def solve_pure_network(network: problem.Network):
    """Solve a mesh-free lumped network through the bordered-system path.
    All nodes become internal core variables."""
    from padne_tpu.ops import schur

    prob = problem.Problem(layers=[], networks=[network])
    vindex = solver.VertexIndexer.create([])
    node_indexer = solver.NodeIndexer.create(prob, [], [], vindex, [network])
    system, extra = solver.assemble_core_system(
        prob, [], [], vindex, [network], node_indexer
    )
    result = schur.solve_bordered(system)
    values = {
        node: result.v[idx] for node, idx in node_indexer.node_to_index.items()
    }
    currents = {elem: result.j[k] for k, elem in enumerate(extra)}
    return values, currents, result


class TestNetworkSolver:
    def test_current_into_resistor(self):
        n_f, n_t = problem.NodeID(), problem.NodeID()
        csrc = problem.CurrentSource(f=n_f, t=n_t, current=1.1)
        res = problem.Resistor(a=n_f, b=n_t, resistance=2.2)
        net = problem.Network(connections=[], elements=[csrc, res])
        s, _, result = solve_pure_network(net)
        assert s[n_t] - s[n_f] == pytest.approx(1.1 * 2.2, abs=1e-9)
        assert result.residual_norm < 1e-9

    def test_voltage_into_resistor(self):
        n_p, n_n = problem.NodeID(), problem.NodeID()
        vsrc = problem.VoltageSource(p=n_p, n=n_n, voltage=3.3)
        res = problem.Resistor(a=n_p, b=n_n, resistance=2.2)
        net = problem.Network(connections=[], elements=[vsrc, res])
        s, currents, result = solve_pure_network(net)
        assert s[n_p] - s[n_n] == pytest.approx(3.3, abs=1e-9)
        assert currents[vsrc] == pytest.approx(3.3 / 2.2, abs=1e-9)
        assert result.residual_norm < 1e-9

    def test_voltage_regulator(self):
        n_p, n_n, n_f, n_t = (problem.NodeID() for _ in range(4))
        res_v = problem.Resistor(a=n_p, b=n_n, resistance=2.2)
        res_c = problem.Resistor(a=n_f, b=n_t, resistance=1.4)
        res_coupling = problem.Resistor(a=n_t, b=n_n, resistance=100000)
        reg = problem.VoltageRegulator(
            v_p=n_p, v_n=n_n, s_f=n_f, s_t=n_t, voltage=3.3, gain=0.3
        )
        net = problem.Network(
            connections=[], elements=[res_c, res_v, res_coupling, reg]
        )
        s, currents, result = solve_pure_network(net)
        assert s[n_p] - s[n_n] == pytest.approx(3.3, abs=1e-8)
        i_out = currents[reg]
        assert i_out == pytest.approx(3.3 / 2.2, abs=1e-8)
        v_sense = s[n_f] - s[n_t]
        assert v_sense == pytest.approx(i_out * 0.3 * 1.4, abs=1e-8)
        assert result.residual_norm < 1e-9

    def test_voltage_divider_chain(self):
        # 10V across two 1k resistors -> 5V midpoint.
        a, b, c = problem.NodeID(), problem.NodeID(), problem.NodeID()
        net = problem.Network(
            connections=[],
            elements=[
                problem.VoltageSource(p=a, n=c, voltage=10.0),
                problem.Resistor(a=a, b=b, resistance=1000.0),
                problem.Resistor(a=b, b=c, resistance=1000.0),
            ],
        )
        s, currents, _ = solve_pure_network(net)
        assert s[a] - s[c] == pytest.approx(10.0, abs=1e-9)
        assert s[b] - s[c] == pytest.approx(5.0, abs=1e-9)


def make_linear_strip_problem(width=10.0, height=1.0, voltage=1.0):
    fracs = [0.05, 0.25, 0.5, 0.75, 0.95]
    pts_left = [(0.0, f * height) for f in fracs]
    pts_right = [(width, f * height) for f in fracs]
    boundary = (
        [(0.0, 0.0)]
        + sorted(pts_left, key=lambda p: p[1])
        + [(0.0, height), (width, height)]
        + sorted(pts_right, key=lambda p: p[1], reverse=True)
        + [(width, 0.0)]
    )
    rect = geom.Polygon(boundary)
    layer = problem.Layer(
        shape=geom.MultiPolygon([rect]), name="TestLayer", conductance=1.0
    )
    networks = []
    conns_left, conns_right = [], []
    for pl, pr in zip(pts_left, pts_right):
        cl = problem.Connection(layer=layer, point=geom.Point(*pl))
        cr = problem.Connection(layer=layer, point=geom.Point(*pr))
        conns_left.append(cl)
        conns_right.append(cr)
        vs = problem.VoltageSource(p=cr.node_id, n=cl.node_id, voltage=voltage)
        networks.append(problem.Network(connections=[cl, cr], elements=[vs]))
    return problem.Problem(layers=[layer], networks=networks), conns_left, conns_right


class TestSyntheticProblems:
    def test_linear_rectangle(self):
        prob, conns_left, conns_right = make_linear_strip_problem()
        solution = solver.solve(prob)

        for network in prob.networks:
            vs = network.elements[0]
            conn_p = next(c for c in network.connections if c.node_id == vs.p)
            conn_n = next(c for c in network.connections if c.node_id == vs.n)
            vp = find_vertex_value(solution, conn_p)
            vn = find_vertex_value(solution, conn_n)
            assert vp - vn == pytest.approx(vs.voltage, abs=1e-6)

        avg_left = np.mean([find_vertex_value(solution, c) for c in conns_left])
        avg_right = np.mean([find_vertex_value(solution, c) for c in conns_right])
        assert avg_right > avg_left

        # Potential is linear in x within 0.05 (reference gate,
        # test_solver.py:594).
        slope = (avg_right - avg_left) / 10.0
        ls = solution.layer_solutions[0]
        for m, pot in zip(ls.meshes, ls.potentials):
            expected = avg_left + m.vertices[:, 0] * slope
            assert np.abs(pot.values - expected).max() < 0.05

        assert solution.solver_info.residual_norm < 1e-9

    def test_linear_rectangle_scipy_parity(self):
        import scipy.sparse.linalg

        prob, _, _ = make_linear_strip_problem()
        indices, _, pairs = solver.compute_connectivity(prob)
        meshes, m2l = solver.generate_meshes_for_problem(
            prob, mesh.Mesher(), pairs, indices
        )
        vindex = solver.VertexIndexer.create(meshes)
        filtered = solver.filter_dead_networks(prob, indices, pairs)
        node_indexer = solver.NodeIndexer.create(prob, meshes, m2l, vindex, filtered)
        system, _ = solver.assemble_core_system(
            prob, meshes, m2l, vindex, filtered, node_indexer
        )
        from padne_tpu.ops import schur

        result = schur.solve_bordered(system)
        L, r = solver.system_to_scipy(system)
        z_ref = scipy.sparse.linalg.spsolve(L, r)
        dv = np.abs(z_ref[: system.n] - result.v).max()
        # 1e-6 V parity gate (BASELINE.md).
        assert dv < 1e-6

    def test_coaxial_structure(self):
        inner_r, outer_r = 1.0, 9.0
        inner = geom.circle(0, 0, inner_r, segments=64)
        outer = geom.circle(0, 0, outer_r, segments=64)
        ring_mp = geom.difference(outer, inner)
        assert len(ring_mp.geoms) == 1
        annulus = ring_mp.geoms[0]
        assert len(annulus.interiors) == 1

        layer = problem.Layer(
            shape=ring_mp, name="AnnulusLayer", conductance=1.0
        )

        def angle_sorted(ring):
            pts = [(float(x), float(y)) for x, y in ring]
            return sorted(pts, key=lambda p: math.atan2(p[1], p[0]) % (2 * math.pi))

        outer_pts = angle_sorted(annulus.exterior)
        inner_pts = angle_sorted(annulus.interiors[0])

        networks = []
        outer_conns = [
            problem.Connection(layer=layer, point=geom.Point(*p)) for p in outer_pts
        ]
        inner_conns = [
            problem.Connection(layer=layer, point=geom.Point(*p)) for p in inner_pts
        ]
        for conns in (outer_conns, inner_conns):
            for ca, cb in zip(conns, conns[1:] + [conns[0]]):
                vs = problem.VoltageSource(p=ca.node_id, n=cb.node_id, voltage=0.0)
                networks.append(
                    problem.Network(connections=[ca, cb], elements=[vs])
                )
        vs = problem.VoltageSource(
            p=inner_conns[0].node_id, n=outer_conns[0].node_id, voltage=1.0
        )
        networks.append(
            problem.Network(
                connections=[inner_conns[0], outer_conns[0]], elements=[vs]
            )
        )

        prob = problem.Problem(layers=[layer], networks=networks)
        # Slightly denser than default: the 0.03 gate is about solver
        # correctness; at the default 0.6 mm bound the pure P1
        # discretization error of this mesher's output is ~0.035 (verified
        # identical to a scipy direct solve on the same mesh).
        cfg = mesh.Mesher.Config(
            maximum_size=0.45, variable_size_maximum_factor=1.0
        )
        solution = solver.solve(prob, mesher_config=cfg)

        # Analytic: V(r) = ln(outer/r) / ln(outer/inner), 0 at outer, 1 at
        # inner; check interior vertices within 0.03 (reference
        # test_solver.py:749).
        v_outer = find_vertex_value(solution, outer_conns[0])
        ls = solution.layer_solutions[0]
        ln_ratio = math.log(outer_r / inner_r)
        for m, pot in zip(ls.meshes, ls.potentials):
            r = np.hypot(m.vertices[:, 0], m.vertices[:, 1])
            interior = (r > inner_r * 1.2) & (r < outer_r * 0.9)
            expected = np.log(outer_r / r) / ln_ratio
            err = np.abs((pot.values - v_outer) - expected)
            assert err[interior].max() < 0.03

        assert solution.solver_info.residual_norm < 1e-9

    def test_superposition(self):
        """Solving with both sources = sum of single-source solves."""
        width, height = 8.0, 2.0
        rect = geom.Polygon(
            [(0, 0), (width / 2, 0), (width, 0), (width, height), (0, height)]
        )
        layer = problem.Layer(
            shape=geom.MultiPolygon([rect]), name="L", conductance=1.0
        )
        c_a = problem.Connection(layer=layer, point=geom.Point(0, 0))
        c_b = problem.Connection(layer=layer, point=geom.Point(width, 0))
        c_m = problem.Connection(layer=layer, point=geom.Point(width / 2, 0))

        def solve_with(i1, i2):
            nets = [
                problem.Network(
                    connections=[c_a, c_m],
                    elements=[
                        problem.CurrentSource(
                            f=c_a.node_id, t=c_m.node_id, current=i1
                        )
                    ],
                ),
                problem.Network(
                    connections=[c_b, c_m],
                    elements=[
                        problem.CurrentSource(
                            f=c_b.node_id, t=c_m.node_id, current=i2
                        )
                    ],
                ),
                # A 0V anchor so the potential is pinned consistently.
                problem.Network(
                    connections=[c_m],
                    elements=[],
                ),
            ]
            prob = problem.Problem(layers=[layer], networks=nets)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return solver.solve(prob)

        s_both = solve_with(0.5, 0.25)
        s_1 = solve_with(0.5, 0.0)
        s_2 = solve_with(0.0, 0.25)

        def values_rel(sol, conn_ref):
            ls = sol.layer_solutions[0]
            ref = find_vertex_value(sol, conn_ref)
            return np.concatenate([p.values - ref for p in ls.potentials])

        v_both = values_rel(s_both, c_m)
        v_sum = values_rel(s_1, c_m) + values_rel(s_2, c_m)
        assert np.abs(v_both - v_sum).max() < 1e-6


class TestPostprocessing:
    def test_power_density_linear_field(self):
        """p = sigma |grad V|^2 exactly for a linear potential."""
        import jax.numpy as jnp

        from padne_tpu.ops import postproc

        m = mesh.Mesher(
            mesh.Mesher.Config(maximum_size=1.0, variable_size_maximum_factor=1.0)
        ).poly_to_mesh(geom.box(0, 0, 5, 5))
        grad = np.array([2.0, -1.0])
        vals = m.vertices @ grad + 0.7
        sigma = 3.0
        pd = postproc.power_density(
            jnp.asarray(m.vertices), jnp.asarray(m.triangles), jnp.asarray(vals), sigma
        )
        expected = sigma * (grad @ grad)
        assert np.allclose(np.asarray(pd), expected, rtol=1e-12)

    def test_face_gradients_constant(self):
        import jax.numpy as jnp

        from padne_tpu.ops import postproc

        m = mesh.Mesher(mesh.Mesher.Config.RELAXED).poly_to_mesh(geom.box(0, 0, 2, 2))
        g = postproc.face_gradients(
            jnp.asarray(m.vertices),
            jnp.asarray(m.triangles),
            jnp.asarray(np.full(m.num_vertices, 4.2)),
        )
        assert np.allclose(np.asarray(g), 0.0)

    def test_power_density_batch_matches_per_mesh(self):
        """The padded multi-mesh batch (one jit for ALL meshes) must
        match per-mesh calls exactly, with finite values on every real
        face regardless of padding."""
        import jax.numpy as jnp

        from padne_tpu.ops import postproc

        cfgs = [1.2, 0.8, 2.5]  # distinct sizes -> distinct mesh shapes
        meshes = [
            mesh.Mesher(mesh.Mesher.Config(
                maximum_size=s, variable_size_maximum_factor=1.0)
            ).poly_to_mesh(geom.box(0, 0, 4 + i, 5))
            for i, s in enumerate(cfgs)
        ]
        rng = np.random.default_rng(0)
        vals = [rng.standard_normal(m.num_vertices) for m in meshes]
        conds = [3.0, 0.5, 7.7]
        batched = postproc.power_density_batch(meshes, vals, conds)
        for m, v, c, pd in zip(meshes, vals, conds, batched):
            ref = postproc.power_density(
                jnp.asarray(m.vertices), jnp.asarray(m.triangles),
                jnp.asarray(v), c)
            assert np.isfinite(pd).all()
            assert np.allclose(pd, np.asarray(ref), rtol=1e-12, atol=1e-12)
        assert postproc.power_density_batch([], [], []) == []


class TestDiagnostics:
    def test_unterminated_current_warns(self):
        # Current source into a plane with no voltage pin and a second
        # current source pulling from an unconnected region -> ill-posed,
        # should warn, not crash.
        rect = geom.box(0, 0, 4, 4)
        layer = problem.Layer(
            shape=geom.MultiPolygon([rect]), name="L", conductance=1.0
        )
        c_a = problem.Connection(layer=layer, point=geom.Point(1, 1))
        internal = problem.NodeID()  # floating internal node
        net = problem.Network(
            connections=[c_a],
            elements=[
                problem.CurrentSource(f=c_a.node_id, t=internal, current=1.0)
            ],
        )
        prob = problem.Problem(layers=[layer], networks=[net])
        with pytest.warns(solver.SolverWarning):
            solution = solver.solve(prob)
        assert solution is not None


class TestMixedPrecision:
    def test_mixed_matches_f64(self):
        """f32 inner solves + f64 refinement reach the same solution as
        the all-f64 path (the accelerator configuration)."""
        import jax.numpy as jnp

        from padne_tpu.ops import schur

        prob, _, _ = make_linear_strip_problem(voltage=2.0)
        indices, _, pairs = solver.compute_connectivity(prob)
        meshes, m2l = solver.generate_meshes_for_problem(
            prob, mesh.Mesher(), pairs, indices
        )
        vindex = solver.VertexIndexer.create(meshes)
        filtered = solver.filter_dead_networks(prob, indices, pairs)
        ni = solver.NodeIndexer.create(prob, meshes, m2l, vindex, filtered)
        system, _ = solver.assemble_core_system(
            prob, meshes, m2l, vindex, filtered, ni
        )
        r64 = schur.solve_bordered(system)
        r32 = schur.solve_bordered(system, device_dtype=jnp.float32)
        assert r32.residual_norm < 1e-9
        assert np.abs(r64.v - r32.v).max() < 1e-8

"""Solution artifact, ParaView export, HTML viewer, and CLI tests."""

import warnings

import numpy as np
import pytest
from xml.etree import ElementTree as etree

from padne_tpu import cli, geom, mesh, problem, solver
from padne_tpu.io import htmlview, paraview, solution as solution_io


@pytest.fixture(scope="module")
def small_solution():
    rect = geom.Polygon([(0, 0), (4, 0), (8, 0), (8, 2), (0, 2)])
    layer = problem.Layer(
        shape=geom.MultiPolygon([rect, geom.box(10, 10, 12, 12)]),
        name="F.Cu",
        conductance=1.0,
    )
    c_a = problem.Connection(layer=layer, point=geom.Point(0, 0))
    c_b = problem.Connection(layer=layer, point=geom.Point(8, 0))
    net = problem.Network(
        connections=[c_a, c_b],
        elements=[
            problem.VoltageSource(p=c_b.node_id, n=c_a.node_id, voltage=2.5)
        ],
    )
    prob = problem.Problem(
        layers=[layer], networks=[net], project_name="unit_fixture"
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return solver.solve(prob)


class TestSolutionArtifact:
    def test_roundtrip(self, small_solution, tmp_path):
        path = tmp_path / "sol.npz"
        solution_io.save_solution(small_solution, path)
        loaded = solution_io.load_solution(path)
        assert loaded.problem.project_name == "unit_fixture"
        assert len(loaded.layer_solutions) == 1
        orig = small_solution.layer_solutions[0]
        got = loaded.layer_solutions[0]
        assert len(got.meshes) == len(orig.meshes)
        for mo, mg, po, pg in zip(
            orig.meshes, got.meshes, orig.potentials, got.potentials
        ):
            assert np.array_equal(mo.vertices, mg.vertices)
            assert np.array_equal(mo.triangles, mg.triangles)
            assert np.array_equal(po.values, pg.values)
        assert len(got.disconnected_meshes) == len(orig.disconnected_meshes)
        assert (
            loaded.solver_info.residual_norm
            == small_solution.solver_info.residual_norm
        )


class TestParaview:
    def test_export_well_formed(self, small_solution, tmp_path):
        paraview.export_solution(small_solution, tmp_path)
        files = list(tmp_path.glob("*.vtu"))
        assert len(files) == 1
        tree = etree.parse(str(files[0]))
        root = tree.getroot()
        assert root.tag == "VTKFile"
        assert root.get("type") == "UnstructuredGrid"
        pieces = root.findall(".//Piece")
        assert pieces
        for piece in pieces:
            np_pts = int(piece.get("NumberOfPoints"))
            np_cells = int(piece.get("NumberOfCells"))
            volt = piece.find("PointData/DataArray[@Name='voltage']")
            assert len(volt.text.split()) == np_pts
            conn = piece.find("Cells/DataArray[@Name='connectivity']")
            assert len(conn.text.split()) == 3 * np_cells
            types = piece.find("Cells/DataArray[@Name='types']")
            assert set(types.text.split()) == {"5"}
            pts = piece.find("Points/DataArray")
            assert len(pts.text.split()) == 3 * np_pts

    def test_y_negated(self, small_solution, tmp_path):
        paraview.export_solution(small_solution, tmp_path)
        tree = etree.parse(str(next(tmp_path.glob("*.vtu"))))
        coords = np.array(
            tree.find(".//Points/DataArray").text.split(), dtype=float
        ).reshape(-1, 3)
        m = small_solution.layer_solutions[0].meshes[0]
        assert np.allclose(coords[: m.num_vertices, 1], -m.vertices[:, 1])

    def test_filename_sanitization(self):
        used = set()
        assert paraview.sanitize_filename("F.Cu", used) == "F.Cu"
        assert paraview.sanitize_filename("F.Cu", used) == "F.Cu_2"
        assert paraview.sanitize_filename("a b/c", used) == "a_b_c"
        assert paraview.sanitize_filename("  ", used) == "layer"


class TestHtmlView:
    def test_export(self, small_solution, tmp_path):
        out = tmp_path / "view.html"
        htmlview.export_html(small_solution, out)
        text = out.read_text()
        assert "webgl" in text
        assert "unit_fixture" in text
        assert len(text) > 5000


class TestCli:
    def test_solve_info_paraview_html(self, boards_dir, tmp_path, capsys):
        board = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
        out = tmp_path / "out.npz"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cli.main(["solve", str(board), str(out)])
        assert out.exists()
        cli.main(["info", str(out)])
        captured = capsys.readouterr()
        assert "residual" in captured.out
        cli.main(["paraview", str(out), str(tmp_path / "pv")])
        assert list((tmp_path / "pv").glob("*.vtu"))
        cli.main(["html", str(out), str(tmp_path / "v.html")])
        assert (tmp_path / "v.html").exists()

    def test_bad_input_exits_nonzero(self, tmp_path):
        with pytest.raises(SystemExit) as e:
            cli.main(["solve", str(tmp_path / "missing.kicad_pro"),
                      str(tmp_path / "o.npz")])
        assert e.value.code == 1

    def test_mesher_flags(self):
        args = cli.parse_args(
            ["solve", "a.kicad_pro", "b.npz", "--mesh-size", "0.3",
             "--mesh-angle", "25"]
        )
        cfg = cli.mesher_config_from_args(args)
        assert cfg.maximum_size == 0.3
        assert cfg.minimum_angle == 25


class TestColormaps:
    def test_tables(self):
        from padne_tpu import colormaps

        for cm in (colormaps.VIRIDIS, colormaps.PLASMA, colormaps.INFERNO):
            assert cm.table.shape == (256, 3)
            assert (cm.table >= 0).all() and (cm.table <= 1).all()
            lo = cm(0.0)
            hi = cm(1.0)
            assert lo != hi
            assert cm(-5) == lo and cm(7) == hi

    def test_map_array(self):
        from padne_tpu import colormaps

        out = colormaps.VIRIDIS.map_array(np.linspace(0, 1, 10))
        assert out.shape == (10, 3)

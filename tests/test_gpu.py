"""Checks that only an NVIDIA GPU can run.

They skip elsewhere (the CPU test run has no card).  `python
chip_smoke.py` runs the same operator check in-process on the card, at
the benchmark board's full width.
"""

import pytest


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device: {dev.platform});"
                    f" run python chip_smoke.py on the card")
    return dev


@pytest.mark.gpu
def test_device_operators_match_f64_references(gpu, tmp_path, monkeypatch):
    """Every device operator of the DIA solve against its host f64
    reference (chip_smoke phase 2), on a 50k-DoF cut of the bench
    board."""
    import chip_smoke
    from padne_tpu import kicad, mesh, solver
    from padne_tpu.ops import schur

    pro, size = chip_smoke.make_board(tmp_path, 50_000)
    cfg = mesh.Mesher.Config(maximum_size=size,
                             variable_size_maximum_factor=1.0)
    system, *_ = solver.build_system(kicad.load_kicad_project(pro),
                                     mesher_config=cfg)
    monkeypatch.setenv("PADNE_TPU_SYNC_COMP", "1")
    results = chip_smoke.check_operators(schur.DiaBorderedSolver(system),
                                         system)
    assert {name for name, *_ in results} == set(chip_smoke.TOLERANCES)

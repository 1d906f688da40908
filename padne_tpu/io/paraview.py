"""ParaView VTU export (VTK XML UnstructuredGrid, one file per layer).

Format parity with the reference exporter (paraview.py:96-298): ASCII
DataArrays, a per-mesh Piece with a "voltage" point scalar, negated Y
for ParaView orientation, triangle cell type 5, and sanitized, deduped
filenames.  Additionally exports the per-face "power_density" cell field
(the reference only exports voltage).
"""

from __future__ import annotations

import itertools
import logging
from pathlib import Path
from typing import Set

import numpy as np
from xml.etree.ElementTree import Element, ElementTree, SubElement, indent

from .. import mesh as mesh_mod
from .. import solver as solver_mod

log = logging.getLogger(__name__)


_FILENAME_SAFE = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-"
)


def sanitize_filename(name: str, used_names: Set[str],
                      fallback_prefix: str = "layer") -> str:
    """Turn a KiCad layer name into a unique filesystem-safe stem.

    Unsafe characters become "_"; runs of "_" (including at the ends)
    collapse away; an empty result falls back to `fallback_prefix`; a
    stem already present in `used_names` gets a "_<k>" suffix.
    """
    mapped = "".join(c if c in _FILENAME_SAFE else "_" for c in name.strip())
    stem = "_".join(piece for piece in mapped.split("_") if piece)
    stem = stem or fallback_prefix
    candidates = itertools.chain(
        [stem], (f"{stem}_{k}" for k in itertools.count(2))
    )
    chosen = next(c for c in candidates if c not in used_names)
    used_names.add(chosen)
    return chosen


def _data_array(parent, data_type: str, values, name=None, components=None):
    arr = SubElement(parent, "DataArray")
    arr.set("type", data_type)
    arr.set("format", "ascii")
    if name is not None:
        arr.set("Name", name)
    if components is not None:
        arr.set("NumberOfComponents", str(components))
    arr.text = " ".join(str(v) for v in values)
    return arr


def create_piece(m: mesh_mod.TriMesh, potentials: mesh_mod.ZeroForm,
                 power: mesh_mod.TwoForm | None = None) -> Element:
    piece = Element("Piece")
    piece.set("NumberOfPoints", str(m.num_vertices))
    piece.set("NumberOfCells", str(m.num_faces))

    point_data = SubElement(piece, "PointData")
    point_data.set("Scalars", "voltage")
    _data_array(point_data, "Float64", potentials.values.tolist(), name="voltage")

    if power is not None:
        cell_data = SubElement(piece, "CellData")
        cell_data.set("Scalars", "power_density")
        _data_array(
            cell_data, "Float64", power.values.tolist(), name="power_density"
        )

    points = SubElement(piece, "Points")
    coords = np.zeros((m.num_vertices, 3))
    coords[:, 0] = m.vertices[:, 0]
    coords[:, 1] = -m.vertices[:, 1]  # ParaView orientation
    _data_array(points, "Float64", coords.reshape(-1).tolist(), components=3)

    cells = SubElement(piece, "Cells")
    _data_array(
        cells, "Int32", m.triangles.reshape(-1).tolist(), name="connectivity"
    )
    _data_array(
        cells, "Int32", (3 * (np.arange(m.num_faces) + 1)).tolist(), name="offsets"
    )
    _data_array(cells, "UInt8", [5] * m.num_faces, name="types")
    return piece


def export_solution(solution: solver_mod.Solution, output_dir: Path) -> None:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    used: Set[str] = set()
    total_files = total_pieces = 0
    for layer_idx, ls in enumerate(solution.layer_solutions):
        layer_name = solution.problem.layers[layer_idx].name
        pairs = list(zip(ls.meshes, ls.potentials))
        if not pairs:
            log.warning("Skipping layer '%s' - no meshes", layer_name)
            continue
        filename = sanitize_filename(layer_name, used)
        root = Element("VTKFile")
        root.set("type", "UnstructuredGrid")
        root.set("version", "0.1")
        root.set("byte_order", "LittleEndian")
        grid = SubElement(root, "UnstructuredGrid")
        for mi, (m, pot) in enumerate(pairs):
            power = (
                ls.power_densities[mi] if mi < len(ls.power_densities) else None
            )
            grid.append(create_piece(m, pot, power))
            total_pieces += 1
        indent(root)
        ElementTree(root).write(
            str(output_dir / f"{filename}.vtu"),
            xml_declaration=True,
            encoding="utf-8",
        )
        total_files += 1
    log.info(
        "Exported %d mesh pieces across %d layer files to %s",
        total_pieces, total_files, output_dir,
    )

"""Minimal ESRI Shapefile reader (polygons) — replaces geopandas ``read_file``
for forest outlines and exclusion shapes (reference ``preprocessing.py:153``,
``helpers.py:44``, ``helpers.py:733``).

Reads ``.shp`` (geometry; shape types 5/15/25 Polygon[Z/M]) and, when present,
``.dbf`` (dBASE III attributes).  Ring winding resolves holes: per shapefile
spec, clockwise rings are exteriors, counter-clockwise rings are holes; holes
are attached to the exterior whose bbox contains them.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from treedetection_tpu_torch.vector.polygon import signed_area


def read_shapefile(path: str) -> Tuple[List[List[List[np.ndarray]]], List[Dict[str, Any]]]:
    """-> (geometries, properties); geometry structure matches read_gpkg:
    list of polygons, each a list of rings [exterior, *holes]."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 100:
        raise ValueError(f"Corrupt shapefile: {path}")
    code, = struct.unpack(">i", data[:4])
    if code != 9994:
        raise ValueError(f"Not a shapefile: {path}")
    file_len_words, = struct.unpack(">i", data[24:28])
    file_len = file_len_words * 2

    geoms: List[List[List[np.ndarray]]] = []
    off = 100
    while off + 8 <= min(file_len, len(data)):
        _recno, content_len_words = struct.unpack(">ii", data[off:off + 8])
        off += 8
        content = data[off:off + content_len_words * 2]
        off += content_len_words * 2
        if len(content) < 4:
            break
        shape_type, = struct.unpack("<i", content[:4])
        if shape_type in (5, 15, 25):  # Polygon, PolygonZ, PolygonM
            geoms.append(_parse_polygon(content))
        elif shape_type == 0:  # null shape
            geoms.append([])
        else:
            geoms.append([])  # non-polygon shapes ignored

    props = _read_dbf(os.path.splitext(path)[0] + ".dbf", len(geoms))
    return geoms, props


def _parse_polygon(content: bytes) -> List[List[np.ndarray]]:
    num_parts, num_points = struct.unpack("<ii", content[36:44])
    parts = np.frombuffer(content, dtype="<i4", count=num_parts, offset=44)
    pts_off = 44 + 4 * num_parts
    pts = np.frombuffer(content, dtype="<f8", count=num_points * 2, offset=pts_off)
    pts = pts.reshape(num_points, 2).copy()

    rings: List[np.ndarray] = []
    bounds_list = []
    for i in range(num_parts):
        a = parts[i]
        b = parts[i + 1] if i + 1 < num_parts else num_points
        ring = pts[a:b]
        if len(ring) >= 4:
            rings.append(ring)
            bounds_list.append((ring[:, 0].min(), ring[:, 1].min(),
                                ring[:, 0].max(), ring[:, 1].max()))

    # winding: shapefile exteriors are clockwise => negative signed area in
    # standard math orientation
    polygons: List[List[np.ndarray]] = []
    poly_bounds: List[Tuple[float, float, float, float]] = []
    holes: List[Tuple[np.ndarray, Tuple[float, float, float, float]]] = []
    for ring, b in zip(rings, bounds_list):
        if signed_area(ring) <= 0:
            polygons.append([ring])
            poly_bounds.append(b)
        else:
            holes.append((ring, b))
    if not polygons and holes:
        # some writers emit a single CCW ring; treat it as exterior
        polygons = [[h[0]] for h in holes]
        holes = []
    for ring, hb in holes:
        for rings_out, pb in zip(polygons, poly_bounds):
            if (pb[0] <= hb[0] and pb[1] <= hb[1] and pb[2] >= hb[2] and pb[3] >= hb[3]):
                rings_out.append(ring)
                break
        else:
            if polygons:
                polygons[0].append(ring)
    return polygons


def _read_dbf(path: str, n_expected: int) -> List[Dict[str, Any]]:
    if not os.path.exists(path):
        return [{} for _ in range(n_expected)]
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 32:
        return [{} for _ in range(n_expected)]
    n_records, = struct.unpack("<I", data[4:8])
    header_len, record_len = struct.unpack("<HH", data[8:12])
    fields = []
    off = 32
    while off < header_len - 1 and data[off] != 0x0D:
        fd = data[off:off + 32]
        name = fd[:11].split(b"\0")[0].decode("latin-1")
        ftype = chr(fd[11])
        flen = fd[16]
        fields.append((name, ftype, flen))
        off += 32

    out: List[Dict[str, Any]] = []
    off = header_len
    for _ in range(min(n_records, n_expected if n_expected else n_records)):
        rec = data[off:off + record_len]
        off += record_len
        if len(rec) < record_len:
            break
        pos = 1  # skip deletion flag
        props: Dict[str, Any] = {}
        for name, ftype, flen in fields:
            raw = rec[pos:pos + flen]
            pos += flen
            text = raw.decode("latin-1", "replace").strip()
            if ftype in ("N", "F"):
                try:
                    props[name] = float(text) if ("." in text or "e" in text.lower()) else int(text)
                except ValueError:
                    props[name] = None
            elif ftype == "L":
                props[name] = text.upper() in ("T", "Y")
            else:
                props[name] = text
        out.append(props)
    while len(out) < n_expected:
        out.append({})
    return out

"""GeoPackage (GPKG) vector I/O over the stdlib ``sqlite3`` — no GDAL/fiona.

Implements the OGC GeoPackage 1.3 encoding for vector features: the
``gpkg_contents`` / ``gpkg_geometry_columns`` / ``gpkg_spatial_ref_sys``
registry tables plus one feature table with a GPKG geometry BLOB column
(standard header + little-endian WKB Polygon/MultiPolygon).

This replaces every ``gpd.read_file`` / ``GeoDataFrame.to_file`` GPKG call in
the reference (stitch output ``helpers.py:545-548``, postprocess I/O
``postprocessing.py:891-894,937-939``, fusion ``helpers.py:752,826``).
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from treedetection_tpu_torch.vector.polygon import ensure_closed, ensure_open, polygon_bounds

WKB_POLYGON = 3
WKB_MULTIPOLYGON = 6

GPKG_APP_ID = 0x47504B47  # "GPKG"


# --- WKB ------------------------------------------------------------------

def wkb_write_polygon(rings: Sequence[np.ndarray]) -> bytes:
    """Little-endian WKB Polygon from [exterior, *holes] rings."""
    out = bytearray()
    out += struct.pack("<BI", 1, WKB_POLYGON)
    out += struct.pack("<I", len(rings))
    for ring in rings:
        r = ensure_closed(np.asarray(ring, dtype=np.float64))
        out += struct.pack("<I", len(r))
        out += r.astype("<f8").tobytes()
    return bytes(out)


def wkb_write_multipolygon(polys: Sequence[Sequence[np.ndarray]]) -> bytes:
    out = bytearray()
    out += struct.pack("<BI", 1, WKB_MULTIPOLYGON)
    out += struct.pack("<I", len(polys))
    for rings in polys:
        out += wkb_write_polygon(rings)
    return bytes(out)


def _rd(fmt: str, buf: bytes, off: int) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    return struct.unpack_from(fmt, buf, off), off + size


def wkb_read(buf: bytes, off: int = 0) -> Tuple[List[List[np.ndarray]], int]:
    """Parse WKB at ``off`` -> (list of polygons, each list of rings, new off).

    Points/lines are skipped (returned empty); Z/M dimensions are dropped.
    """
    (byte_order,), off = _rd("B", buf, off)
    endian = "<" if byte_order == 1 else ">"
    (geom_type,), off = _rd(endian + "I", buf, off)
    base = geom_type % 1000
    has_z = geom_type >= 1000
    dims = 2 + (1 if 1000 <= geom_type < 2000 or 3000 <= geom_type < 4000 else 0) \
             + (1 if geom_type >= 2000 else 0)

    def read_ring(o):
        (n,), o = _rd(endian + "I", buf, o)
        pts = np.frombuffer(buf, dtype=endian + "f8", count=n * dims, offset=o)
        o += n * dims * 8
        return pts.reshape(n, dims)[:, :2].copy(), o

    if base == WKB_POLYGON:
        (nrings,), off = _rd(endian + "I", buf, off)
        rings = []
        for _ in range(nrings):
            ring, off = read_ring(off)
            rings.append(ring)
        return [rings], off
    if base == WKB_MULTIPOLYGON:
        (npolys,), off = _rd(endian + "I", buf, off)
        polys = []
        for _ in range(npolys):
            sub, off = wkb_read(buf, off)
            polys.extend(sub)
        return polys, off
    if base in (4, 5, 7):  # multi point/linestring, geometrycollection
        (n,), off = _rd(endian + "I", buf, off)
        polys = []
        for _ in range(n):
            sub, off = wkb_read(buf, off)
            polys.extend(sub)
        return polys, off
    if base == 1:  # point
        off += dims * 8
        return [], off
    if base == 2:  # linestring
        (_ring), off = read_ring(off)
        return [], off
    raise ValueError(f"Unsupported WKB geometry type {geom_type}")


# --- GPKG geometry blob ---------------------------------------------------

def gpkg_blob(wkb: bytes, srs_id: int, bounds: Optional[Tuple[float, float, float, float]] = None) -> bytes:
    flags = 0b00000001  # little-endian header
    env = b""
    if bounds is not None:
        flags |= 0b00000010  # envelope: [minx, maxx, miny, maxy]
        env = struct.pack("<4d", bounds[0], bounds[2], bounds[1], bounds[3])
    return b"GP" + struct.pack("<BBi", 0, flags, srs_id) + env + wkb


def gpkg_blob_parse(blob: bytes) -> Tuple[int, bytes]:
    """-> (srs_id, wkb_bytes)."""
    if blob[:2] != b"GP":
        raise ValueError("Not a GPKG geometry blob")
    version, flags = blob[2], blob[3]
    endian = "<" if flags & 1 else ">"
    srs_id, = struct.unpack(endian + "i", blob[4:8])
    env_code = (flags >> 1) & 0b111
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}.get(env_code, 0)
    return srs_id, blob[8 + env_len:]


# --- database -------------------------------------------------------------

_SRS_SQL = """
CREATE TABLE IF NOT EXISTS gpkg_spatial_ref_sys (
  srs_name TEXT NOT NULL, srs_id INTEGER PRIMARY KEY,
  organization TEXT NOT NULL, organization_coordsys_id INTEGER NOT NULL,
  definition TEXT NOT NULL, description TEXT)
"""
_CONTENTS_SQL = """
CREATE TABLE IF NOT EXISTS gpkg_contents (
  table_name TEXT PRIMARY KEY, data_type TEXT NOT NULL, identifier TEXT UNIQUE,
  description TEXT DEFAULT '', last_change DATETIME DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
  min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE, srs_id INTEGER)
"""
_GEOM_COLS_SQL = """
CREATE TABLE IF NOT EXISTS gpkg_geometry_columns (
  table_name TEXT NOT NULL, column_name TEXT NOT NULL, geometry_type_name TEXT NOT NULL,
  srs_id INTEGER NOT NULL, z TINYINT NOT NULL, m TINYINT NOT NULL,
  CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, column_name))
"""


def _sql_type(v: Any) -> str:
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, (int, np.integer)):
        return "INTEGER"
    if isinstance(v, (float, np.floating)):
        return "DOUBLE"
    return "TEXT"


def write_gpkg(path: str,
               geometries: Sequence[Any],
               properties: Optional[Sequence[Dict[str, Any]]] = None,
               layer: str = "features",
               srs_id: int = 25832) -> None:
    """Write polygons (+ per-feature properties) to a GeoPackage.

    ``geometries``: each item is an (N,2) ring, a list of rings (polygon with
    holes), or a list of lists of rings (multipolygon).
    """
    if properties is None:
        properties = [{} for _ in geometries]
    if os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        cur.execute(f"PRAGMA application_id = {GPKG_APP_ID}")
        cur.execute("PRAGMA user_version = 10300")
        cur.execute(_SRS_SQL)
        cur.execute(_CONTENTS_SQL)
        cur.execute(_GEOM_COLS_SQL)
        cur.executemany(
            "INSERT OR IGNORE INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
            [("Undefined cartesian SRS", -1, "NONE", -1, "undefined", None),
             ("Undefined geographic SRS", 0, "NONE", 0, "undefined", None),
             ("WGS 84", 4326, "EPSG", 4326, "GEOGCS[\"WGS 84\"]", None),
             (f"EPSG:{srs_id}", srs_id, "EPSG", srs_id, f"PROJCS[\"EPSG:{srs_id}\"]", None)])

        keys: List[str] = []
        for props in properties:
            for k in props:
                if k not in keys:
                    keys.append(k)
        col_types = {k: "TEXT" for k in keys}
        for props in properties:
            for k, v in props.items():
                if v is not None:
                    col_types[k] = _sql_type(v)
        col_defs = "".join(f', "{k}" {col_types[k]}' for k in keys)
        cur.execute(f'CREATE TABLE "{layer}" '
                    f'(fid INTEGER PRIMARY KEY AUTOINCREMENT, geom BLOB{col_defs})')

        total_bounds = [np.inf, np.inf, -np.inf, -np.inf]
        rows = []
        for geom, props in zip(geometries, properties):
            polys = _normalize_geometry(geom)
            if not polys:
                continue
            all_pts = np.vstack([r for rings in polys for r in rings])
            b = polygon_bounds(all_pts)
            total_bounds = [min(total_bounds[0], b[0]), min(total_bounds[1], b[1]),
                            max(total_bounds[2], b[2]), max(total_bounds[3], b[3])]
            wkb = (wkb_write_polygon(polys[0]) if len(polys) == 1
                   else wkb_write_multipolygon(polys))
            blob = gpkg_blob(wkb, srs_id, b)
            rows.append([blob] + [_to_sql_value(props.get(k)) for k in keys])
        ph = ",".join("?" * (1 + len(keys)))
        cols = "geom" + "".join(f', "{k}"' for k in keys)
        cur.executemany(f'INSERT INTO "{layer}" ({cols}) VALUES ({ph})', rows)

        if not rows:
            total_bounds = [None, None, None, None]
        cur.execute("INSERT INTO gpkg_contents "
                    "(table_name, data_type, identifier, min_x, min_y, max_x, max_y, srs_id) "
                    "VALUES (?,?,?,?,?,?,?,?)",
                    (layer, "features", layer, *total_bounds, srs_id))
        cur.execute("INSERT INTO gpkg_geometry_columns VALUES (?,?,?,?,0,0)",
                    (layer, "geom", "MULTIPOLYGON", srs_id))
        con.commit()
    finally:
        con.close()


def _to_sql_value(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (list, tuple, np.ndarray)):
        return repr([float(x) for x in np.asarray(v).ravel()])
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    return v


def _normalize_geometry(geom) -> List[List[np.ndarray]]:
    """-> list of polygons, each a list of rings."""
    if geom is None:
        return []
    if isinstance(geom, np.ndarray):
        return [[geom]] if len(geom) >= 3 else []
    if isinstance(geom, (list, tuple)):
        if len(geom) == 0:
            return []
        first = geom[0]
        if isinstance(first, np.ndarray):
            return [list(geom)]  # polygon with holes
        return [list(p) for p in geom]  # multipolygon
    raise TypeError(f"Unsupported geometry object: {type(geom)}")


def read_gpkg(path: str, layer: Optional[str] = None
              ) -> Tuple[List[List[List[np.ndarray]]], List[Dict[str, Any]], int]:
    """Read a GPKG feature table -> (geometries, properties, srs_id).

    Each geometry is a list of polygons (multipolygon structure), each polygon a
    list of rings, each ring an (N, 2) array.
    """
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        if layer is None:
            row = cur.execute(
                "SELECT table_name FROM gpkg_contents WHERE data_type='features' LIMIT 1"
            ).fetchone()
            if row is None:
                raise ValueError(f"No feature layer in {path}")
            layer = row[0]
        geom_col_row = cur.execute(
            "SELECT column_name, srs_id FROM gpkg_geometry_columns WHERE table_name=?",
            (layer,)).fetchone()
        geom_col, srs_id = geom_col_row if geom_col_row else ("geom", 0)
        info = cur.execute(f'PRAGMA table_info("{layer}")').fetchall()
        columns = [r[1] for r in info]
        prop_cols = [c for c in columns if c not in ("fid", geom_col)]
        sel = f'"{geom_col}"' + "".join(f', "{c}"' for c in prop_cols)
        geoms, props = [], []
        for row in cur.execute(f'SELECT {sel} FROM "{layer}"'):
            blob = row[0]
            if blob is None:
                geoms.append([])
            else:
                _, wkb = gpkg_blob_parse(blob)
                polys, _ = wkb_read(wkb)
                geoms.append(polys)
            props.append(dict(zip(prop_cols, row[1:])))
        return geoms, props, int(srs_id)
    finally:
        con.close()

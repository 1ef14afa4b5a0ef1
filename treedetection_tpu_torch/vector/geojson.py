"""GeoJSON FeatureCollection read/write helpers.

The reference's per-tile prediction files are COCO-ish JSON with
``polygon_coords`` (reference ``prediction.py:253-263``); its final outputs are
GPKG.  GeoJSON here covers interchange/debug and the ``project_to_geojson``
parity path (reference ``helpers.py:115-263``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _ring_to_list(ring: np.ndarray) -> List[List[float]]:
    r = np.asarray(ring, dtype=float)
    if len(r) and not np.array_equal(r[0], r[-1]):
        r = np.vstack([r, r[:1]])
    return r.tolist()


def geometry_to_geojson(geom) -> Optional[Dict[str, Any]]:
    """Accepts ring / [rings] / [[rings]] (same convention as gpkg writer)."""
    from treedetection_tpu_torch.vector.gpkg import _normalize_geometry
    polys = _normalize_geometry(geom)
    if not polys:
        return None
    if len(polys) == 1:
        return {"type": "Polygon",
                "coordinates": [_ring_to_list(r) for r in polys[0]]}
    return {"type": "MultiPolygon",
            "coordinates": [[_ring_to_list(r) for r in p] for p in polys]}


def geojson_to_polygons(geometry: Dict[str, Any]) -> List[List[np.ndarray]]:
    """-> list of polygons, each list of rings."""
    if geometry is None:
        return []
    gtype = geometry.get("type")
    coords = geometry.get("coordinates", [])
    if gtype == "Polygon":
        return [[np.asarray(r, dtype=np.float64)[:, :2] for r in coords]]
    if gtype == "MultiPolygon":
        return [[np.asarray(r, dtype=np.float64)[:, :2] for r in p] for p in coords]
    if gtype == "GeometryCollection":
        out = []
        for g in geometry.get("geometries", []):
            out.extend(geojson_to_polygons(g))
        return out
    return []


def write_geojson(path: str, geometries: Sequence, properties: Optional[Sequence[Dict]] = None,
                  crs_epsg: Optional[int] = None) -> None:
    if properties is None:
        properties = [{} for _ in geometries]
    features = []
    for geom, props in zip(geometries, properties):
        gj = geometry_to_geojson(geom)
        if gj is None:
            continue
        features.append({"type": "Feature", "geometry": gj,
                         "properties": _jsonable(props)})
    fc: Dict[str, Any] = {"type": "FeatureCollection", "features": features}
    if crs_epsg:
        fc["crs"] = {"type": "name",
                     "properties": {"name": f"urn:ogc:def:crs:EPSG::{crs_epsg}"}}
    with open(path, "w") as fh:
        json.dump(fc, fh)


def read_geojson(path: str) -> Tuple[List[List[List[np.ndarray]]], List[Dict[str, Any]]]:
    with open(path) as fh:
        fc = json.load(fh)
    geoms, props = [], []
    for feat in fc.get("features", []):
        geoms.append(geojson_to_polygons(feat.get("geometry")))
        props.append(feat.get("properties") or {})
    return geoms, props


def _jsonable(props: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in props.items():
        if isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.bool_,)):
            out[k] = bool(v)
        else:
            out[k] = v
    return out

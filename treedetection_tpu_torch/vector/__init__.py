"""Vector geometry stack — numpy polygon math, rasterization, and geo-vector I/O.

Replaces the shapely/GEOS + geopandas/fiona layer of the reference
(``helpers.py:364,462-468,655-662,806-812``, ``postprocessing.py:891-894``)
with dependency-free implementations: vectorized numpy polygon ops on padded
arrays (the in-jit twins live in ``treedetection_tpu_torch.ops``), scanline
rasterization, a GeoPackage reader/writer over the stdlib ``sqlite3``, an ESRI
Shapefile reader, and GeoJSON helpers.
"""

from treedetection_tpu_torch.vector.polygon import (  # noqa: F401
    polygon_area, polygon_centroid, simplify_polygon, points_in_polygon,
    clip_polygon_box, polygon_bounds, polygons_bounds, polygon_iou,
    polygon_intersects, polygon_within, ensure_closed, PolygonSet,
)
from treedetection_tpu_torch.vector.rasterize import rasterize_polygon, rasterize_polygons  # noqa: F401
from treedetection_tpu_torch.vector.gpkg import read_gpkg, write_gpkg  # noqa: F401
from treedetection_tpu_torch.vector.shapefile import read_shapefile  # noqa: F401
from treedetection_tpu_torch.vector.geojson import read_geojson, write_geojson  # noqa: F401

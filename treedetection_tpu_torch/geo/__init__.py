"""Geo core: affine transforms and a first-party GeoTIFF codec (numpy + zlib,
with the LZW fast path in ``treedetection_tpu_torch.native``)."""

from treedetection_tpu_torch.geo.affine import Affine  # noqa: F401
from treedetection_tpu_torch.geo.tiff import GeoTiff, read_geotiff, write_geotiff  # noqa: F401

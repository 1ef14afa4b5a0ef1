"""2-D affine geo transforms with vectorized batch application.

Semantics match the rasterio/affine convention used throughout the reference:
``x = a*col + b*row + c`` ; ``y = d*col + e*row + f`` (reference
``utilities.py:30-76`` implements the same scalar/batch math with CuPy; here
batches are plain numpy — these run on host per-file).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np


class Affine(tuple):
    """Immutable affine transform ``(a, b, c, d, e, f)``.

    | x |   | a  b  c | | col |
    | y | = | d  e  f | | row |
    | 1 |   | 0  0  1 | |  1  |
    """

    __slots__ = ()

    def __new__(cls, a: float, b: float, c: float, d: float, e: float, f: float):
        return super().__new__(cls, (float(a), float(b), float(c),
                                     float(d), float(e), float(f)))

    # --- constructors -----------------------------------------------------
    @classmethod
    def identity(cls) -> "Affine":
        return cls(1, 0, 0, 0, 1, 0)

    @classmethod
    def from_origin(cls, west: float, north: float, xsize: float, ysize: float) -> "Affine":
        """North-up raster with top-left corner (west, north) and pixel sizes."""
        return cls(xsize, 0, west, 0, -ysize, north)

    @classmethod
    def from_gdal(cls, c: float, a: float, b: float, f: float, d: float, e: float) -> "Affine":
        return cls(a, b, c, d, e, f)

    # --- accessors --------------------------------------------------------
    a = property(lambda self: self[0])
    b = property(lambda self: self[1])
    c = property(lambda self: self[2])
    d = property(lambda self: self[3])
    e = property(lambda self: self[4])
    f = property(lambda self: self[5])

    def to_gdal(self) -> Tuple[float, float, float, float, float, float]:
        return (self.c, self.a, self.b, self.f, self.d, self.e)

    # --- algebra ----------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Affine):
            a, b, c, d, e, f = self
            a2, b2, c2, d2, e2, f2 = other
            return Affine(a * a2 + b * d2, a * b2 + b * e2, a * c2 + b * f2 + c,
                          d * a2 + e * d2, d * b2 + e * e2, d * c2 + e * f2 + f)
        if isinstance(other, (tuple, list)) and len(other) == 2:
            return self.apply(other[0], other[1])
        return NotImplemented

    def invert(self) -> "Affine":
        a, b, c, d, e, f = self
        det = a * e - b * d
        if det == 0:
            raise ValueError("Affine transform is not invertible")
        ia, ib = e / det, -b / det
        id_, ie = -d / det, a / det
        return Affine(ia, ib, -(ia * c + ib * f), id_, ie, -(id_ * c + ie * f))

    __invert__ = invert

    # --- application ------------------------------------------------------
    def apply(self, cols, rows):
        """Pixel (col, row) -> geo (x, y); accepts scalars or arrays."""
        a, b, c, d, e, f = self
        cols = np.asarray(cols, dtype=np.float64)
        rows = np.asarray(rows, dtype=np.float64)
        x = a * cols + b * rows + c
        y = d * cols + e * rows + f
        if x.ndim == 0:
            return float(x), float(y)
        return x, y

    def apply_inverse(self, xs, ys):
        """Geo (x, y) -> fractional pixel (col, row)."""
        return self.invert().apply(xs, ys)

    # --- raster helpers ---------------------------------------------------
    def bounds(self, width: int, height: int) -> Tuple[float, float, float, float]:
        """(minx, miny, maxx, maxy) of a width x height raster under this transform."""
        xs, ys = self.apply(np.array([0, width, 0, width]), np.array([0, 0, height, height]))
        return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())

    def window_transform(self, col_off: float, row_off: float) -> "Affine":
        """Transform of a window whose top-left pixel is (col_off, row_off)."""
        x, y = self.apply(col_off, row_off)
        return Affine(self.a, self.b, x, self.d, self.e, y)

    def window_for_bounds(self, minx: float, miny: float, maxx: float, maxy: float
                          ) -> Tuple[int, int, int, int]:
        """Integer pixel window (col_off, row_off, width, height) covering bounds.

        Matches rasterio ``geometry_window`` semantics used by the reference
        tiler (reference ``preprocessing.py:102-103``): outward-rounded to whole
        pixels.
        """
        # all four bbox corners: with a rotated transform (b/d nonzero) the
        # pixel-space extrema are NOT attained at (min,min)/(max,max) alone
        cols, rows = self.apply_inverse(np.array([minx, maxx, minx, maxx]),
                                        np.array([miny, maxy, maxy, miny]))
        c0, c1 = float(np.min(cols)), float(np.max(cols))
        r0, r1 = float(np.min(rows)), float(np.max(rows))
        col_off = int(np.floor(c0 + 1e-9))
        row_off = int(np.floor(r0 + 1e-9))
        width = int(np.ceil(c1 - 1e-9)) - col_off
        height = int(np.ceil(r1 - 1e-9)) - row_off
        return col_off, row_off, max(width, 0), max(height, 0)

    def __repr__(self) -> str:
        return ("Affine(a={:.6g}, b={:.6g}, c={:.6g}, d={:.6g}, e={:.6g}, f={:.6g})"
                .format(*self))


def transform_coords(affine: Sequence[float], cols, rows):
    """Batch pixel->geo on arbitrary arrays — the jnp-free twin of the
    reference's GPU ``xy_gpu`` (reference ``utilities.py:182-207``)."""
    aff = affine if isinstance(affine, Affine) else Affine(*affine[:6])
    return aff.apply(cols, rows)

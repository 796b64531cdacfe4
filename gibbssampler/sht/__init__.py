"""Spherical harmonic transforms (Gauss-Legendre, HEALPix, point sets)."""

from .grids import SphereGrid, gauss_legendre_grid
from .legendre import legendre_table, wigner_d_table, spin2_lambda_tables
from .transform import SHT, make_sht
from .points import PointSHT, group_points_by_ring

__all__ = [
    "SphereGrid", "gauss_legendre_grid",
    "legendre_table", "wigner_d_table", "spin2_lambda_tables",
    "SHT", "make_sht", "PointSHT", "group_points_by_ring",
]

"""Geodetic conversions for GPS pose priors (float64, host).

LLA -> ECEF on the WGS84 ellipsoid, matching the reference's use of GPS EXIF
for OpenMVG ``ViewPriors`` pose centers (``src/R3DProject.cpp:1196-1220``,
``src/threads/ImageInfoThread.cpp:236-328``).

Numpy copy of ``regard3d_tpu/ingest/geodesy.py`` (the port imports nothing
from the reference package).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

WGS84_A = 6378137.0
WGS84_B = 6356752.314245
WGS84_E2 = 1.0 - (WGS84_B * WGS84_B) / (WGS84_A * WGS84_A)


def lla_to_ecef(lat_deg: float, lon_deg: float, alt_m: float = 0.0
                ) -> Tuple[float, float, float]:
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg)
    sin_lat = math.sin(lat)
    n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    x = (n + alt_m) * math.cos(lat) * math.cos(lon)
    y = (n + alt_m) * math.cos(lat) * math.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt_m) * sin_lat
    return x, y, z


def ecef_to_lla(x: float, y: float, z: float) -> Tuple[float, float, float]:
    """Iterative inverse (Bowring's method, few iterations)."""
    lon = math.atan2(y, x)
    p = math.hypot(x, y)
    lat = math.atan2(z, p * (1.0 - WGS84_E2))
    for _ in range(5):
        sin_lat = math.sin(lat)
        n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
        alt = p / math.cos(lat) - n
        lat = math.atan2(z, p * (1.0 - WGS84_E2 * n / (n + alt)))
    sin_lat = math.sin(lat)
    n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    alt = p / math.cos(lat) - n
    return math.degrees(lat), math.degrees(lon), alt


def local_enu_frame(centers_ecef: np.ndarray):
    """Translate ECEF priors into a local East-North-Up frame around their
    centroid (keeps BA numerics in float32 range)."""
    c = np.asarray(centers_ecef, np.float64)
    origin = c.mean(0)
    lat, lon, _ = ecef_to_lla(*origin)
    lam = math.radians(lon)
    phi = math.radians(lat)
    east = np.array([-math.sin(lam), math.cos(lam), 0.0])
    north = np.array([-math.sin(phi) * math.cos(lam),
                      -math.sin(phi) * math.sin(lam), math.cos(phi)])
    up = np.array([math.cos(phi) * math.cos(lam),
                   math.cos(phi) * math.sin(lam), math.sin(phi)])
    R = np.stack([east, north, up])
    return (c - origin) @ R.T, origin, R

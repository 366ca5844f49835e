"""Pixel -> geographic coordinates for nadir and oblique drone imagery, on the host.

Counterpart of `drone_yolo_tpu/apps/geo.py` (the same arithmetic): the ground sample
distance of a nadir camera, WGS84 <-> UTM by the Krüger series (no pyproj), and
`GeoConverter` from pixels to local metres, UTM and latitude/longitude with the
camera's yaw and pitch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# WGS84 ellipsoid
_A = 6378137.0
_F = 1 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2 - _F)


def gsd_meters_per_pixel(sensor_width_mm: float, focal_length_mm: float, altitude_m: float, image_width_px: int) -> float:
    """Ground sample distance (m/px) for a nadir camera (mix6.py GSD model)."""
    return (sensor_width_mm * altitude_m) / (focal_length_mm * image_width_px)


def latlon_to_utm(lat: float, lon: float):
    """WGS84 -> UTM (zone auto). Returns (easting, northing, zone, hemisphere)."""
    zone = int((lon + 180) // 6) + 1
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)
    phi = math.radians(lat)
    lam = math.radians(lon) - lon0

    n = _A / math.sqrt(1 - _E2 * math.sin(phi) ** 2)
    t = math.tan(phi) ** 2
    c = _E2 / (1 - _E2) * math.cos(phi) ** 2
    a = math.cos(phi) * lam

    # meridian arc
    e4, e6 = _E2**2, _E2**3
    m = _A * (
        (1 - _E2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * phi
        - (3 * _E2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * math.sin(2 * phi)
        + (15 * e4 / 256 + 45 * e6 / 1024) * math.sin(4 * phi)
        - (35 * e6 / 3072) * math.sin(6 * phi)
    )
    easting = _K0 * n * (a + (1 - t + c) * a**3 / 6 + (5 - 18 * t + t**2 + 72 * c - 58 * _E2 / (1 - _E2)) * a**5 / 120) + 500000
    northing = _K0 * (m + n * math.tan(phi) * (a**2 / 2 + (5 - t + 9 * c + 4 * c**2) * a**4 / 24 + (61 - 58 * t + t**2 + 600 * c - 330 * _E2 / (1 - _E2)) * a**6 / 720))
    if lat < 0:
        northing += 10000000
    return easting, northing, zone, "N" if lat >= 0 else "S"


def utm_to_latlon(easting: float, northing: float, zone: int, hemisphere: str = "N"):
    """UTM -> WGS84 lat/lon."""
    x = easting - 500000
    y = northing - (10000000 if hemisphere == "S" else 0)
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)

    m = y / _K0
    mu = m / (_A * (1 - _E2 / 4 - 3 * _E2**2 / 64 - 5 * _E2**3 / 256))
    e1 = (1 - math.sqrt(1 - _E2)) / (1 + math.sqrt(1 - _E2))
    phi1 = (
        mu
        + (3 * e1 / 2 - 27 * e1**3 / 32) * math.sin(2 * mu)
        + (21 * e1**2 / 16 - 55 * e1**4 / 32) * math.sin(4 * mu)
        + (151 * e1**3 / 96) * math.sin(6 * mu)
    )
    n1 = _A / math.sqrt(1 - _E2 * math.sin(phi1) ** 2)
    t1 = math.tan(phi1) ** 2
    c1 = _E2 / (1 - _E2) * math.cos(phi1) ** 2
    r1 = _A * (1 - _E2) / (1 - _E2 * math.sin(phi1) ** 2) ** 1.5
    d = x / (n1 * _K0)

    phi = phi1 - (n1 * math.tan(phi1) / r1) * (
        d**2 / 2
        - (5 + 3 * t1 + 10 * c1 - 4 * c1**2 - 9 * _E2 / (1 - _E2)) * d**4 / 24
        + (61 + 90 * t1 + 298 * c1 + 45 * t1**2 - 252 * _E2 / (1 - _E2) - 3 * c1**2) * d**6 / 720
    )
    lam = (d - (1 + 2 * t1 + c1) * d**3 / 6 + (5 - 2 * c1 + 28 * t1 - 3 * c1**2 + 8 * _E2 / (1 - _E2) + 24 * t1**2) * d**5 / 120) / math.cos(phi1)
    return math.degrees(phi), math.degrees(lam + lon0)


@dataclass
class GeoConverter:
    """Pixel -> world coordinates for a drone camera.

    Parameters mirror the reference GeoConverter: camera lat/lon/altitude, yaw
    (deg, clockwise from north), pitch (deg, 90 = nadir), sensor/focal specs.
    """

    lat: float
    lon: float
    altitude_m: float
    yaw_deg: float = 0.0
    pitch_deg: float = 90.0
    sensor_width_mm: float = 13.2
    focal_length_mm: float = 8.8
    image_width_px: int = 3840
    image_height_px: int = 2160

    def __post_init__(self):
        self.e0, self.n0, self.zone, self.hemi = latlon_to_utm(self.lat, self.lon)
        self.gsd = gsd_meters_per_pixel(self.sensor_width_mm, self.focal_length_mm, self.altitude_m, self.image_width_px)

    def pixel_to_local(self, u, v):
        """Pixel -> local ground meters (x east-ish, y north-ish before yaw)."""
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        cx, cy = self.image_width_px / 2, self.image_height_px / 2
        dx = (u - cx) * self.gsd
        # oblique pitch: vertical pixel scale stretched by 1/sin(pitch)
        pitch = math.radians(self.pitch_deg)
        dy = (cy - v) * self.gsd / max(math.sin(pitch), 1e-6)
        # rotate by yaw (camera up = heading)
        yaw = math.radians(self.yaw_deg)
        east = dx * math.cos(yaw) + dy * math.sin(yaw)
        north = -dx * math.sin(yaw) + dy * math.cos(yaw)
        return east, north

    def pixel_to_utm(self, u, v):
        east, north = self.pixel_to_local(u, v)
        return self.e0 + east, self.n0 + north

    def pixel_to_latlon(self, u, v):
        e, n = self.pixel_to_utm(u, v)
        if np.ndim(e) == 0:
            return utm_to_latlon(float(e), float(n), self.zone, self.hemi)
        return np.array([utm_to_latlon(float(ei), float(ni), self.zone, self.hemi) for ei, ni in zip(np.ravel(e), np.ravel(n))])

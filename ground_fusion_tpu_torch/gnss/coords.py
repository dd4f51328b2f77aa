"""Geodetic/ECEF/ENU coordinate transforms + satellite geometry.

The surface of the external ``gnss_comm`` library the reference leans on
(``estimator.h:65-67``: ``ecef2geo``, ``geo2ecef``, ``ecef2rotation``,
``sat_azel``) and of ``global_fusion``'s GeographicLib LocalCartesian
(``globalOpt.cpp:31-41``). Pure numpy — this is low-rate host-side geometry.
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
LIGHT_SPEED = 299792458.0
EARTH_OMG = 7.2921151467e-5        # rad/s (GPS value)
GM_EARTH = 3.986005e14             # WGS84 mu
F_RELATIVITY = -4.442807633e-10    # s/m^0.5


def geo2ecef(lla: np.ndarray) -> np.ndarray:
    """[lat(rad), lon(rad), h] → ECEF xyz."""
    lat, lon, h = lla[0], lla[1], lla[2]
    sl, cl = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    return np.array([
        (n + h) * cl * np.cos(lon),
        (n + h) * cl * np.sin(lon),
        (n * (1.0 - WGS84_E2) + h) * sl,
    ])


def ecef2geo(xyz: np.ndarray) -> np.ndarray:
    """ECEF → [lat, lon, h] (iterative)."""
    x, y, z = xyz
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    h = 0.0
    for _ in range(5):
        sl = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    return np.array([lat, lon, h])


def ecef2rotation(ref_ecef: np.ndarray) -> np.ndarray:
    """R such that v_ecef = R @ v_enu at the reference point
    (gnss_comm ``ecef2rotation``)."""
    lat, lon, _ = ecef2geo(ref_ecef)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    # columns: E, N, U expressed in ECEF
    return np.array([
        [-so, -sl * co, cl * co],
        [co, -sl * so, cl * so],
        [0.0, cl, sl],
    ])


def ecef2enu(ref_ecef: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    return ecef2rotation(ref_ecef).T @ (np.asarray(xyz) - np.asarray(ref_ecef))


def enu2ecef(ref_ecef: np.ndarray, enu: np.ndarray) -> np.ndarray:
    return np.asarray(ref_ecef) + ecef2rotation(ref_ecef) @ np.asarray(enu)


def sat_azel(rcv_ecef: np.ndarray, sat_ecef: np.ndarray):
    """(azimuth, elevation) of a satellite from a receiver (gnss_comm
    ``sat_azel``)."""
    enu = ecef2enu(rcv_ecef, sat_ecef)
    rng = np.linalg.norm(enu)
    az = np.arctan2(enu[0], enu[1])
    el = np.arcsin(enu[2] / max(rng, 1e-9))
    return az, el

"""Geodesy + attitude helpers for GNSS fusion: WGS-84 cartesian <->
geodetic, ECEF->ENU rotation (used by the GPS factors), yaw-pitch-roll.
numpy only; a copy of the JAX package's `utils/geodesy.py`."""

from __future__ import annotations

import math

import numpy as np

WGS84_A = 6378137.0
WGS84_E2 = 6.69437999014e-3


def geod2cart(lat, lon, h):
    """Geodetic (rad, rad, m) -> ECEF."""
    s, c = math.sin(lat), math.cos(lat)
    N = WGS84_A / math.sqrt(1 - WGS84_E2 * s * s)
    return np.array([(N + h) * c * math.cos(lon),
                     (N + h) * c * math.sin(lon),
                     (N * (1 - WGS84_E2) + h) * s])


def cart2geod(xyz):
    """ECEF -> geodetic (lat, lon, h), Bowring's iteration."""
    x, y, z = xyz
    lon = math.atan2(y, x)
    p = math.hypot(x, y)
    lat = math.atan2(z, p * (1 - WGS84_E2))
    for _ in range(5):
        s = math.sin(lat)
        N = WGS84_A / math.sqrt(1 - WGS84_E2 * s * s)
        h = p / math.cos(lat) - N
        lat = math.atan2(z, p * (1 - WGS84_E2 * N / (N + h)))
    s = math.sin(lat)
    N = WGS84_A / math.sqrt(1 - WGS84_E2 * s * s)
    h = p / math.cos(lat) - N
    return np.array([lat, lon, h])


def Cen(ecef_ref):
    """ECEF -> ENU rotation at the reference point (trans.py Cen)."""
    lat, lon, _ = cart2geod(np.asarray(ecef_ref))
    sl, cl = math.sin(lat), math.cos(lat)
    so, co = math.sin(lon), math.cos(lon)
    return np.array([[-so, co, 0],
                     [-sl * co, -sl * so, cl],
                     [cl * co, cl * so, sl]])


def ecef_to_enu(p_ecef, ref_ecef):
    return Cen(ref_ecef) @ (np.asarray(p_ecef) - np.asarray(ref_ecef))


def R2ypr(R):
    """Rotation -> yaw/pitch/roll degrees (trans.py R2ypr)."""
    yaw = math.atan2(R[1, 0], R[0, 0])
    pitch = math.asin(-max(-1.0, min(1.0, R[2, 0])))
    roll = math.atan2(R[2, 1], R[2, 2])
    return np.degrees([yaw, pitch, roll])


def ypr2R(ypr_deg):
    y, p, r = np.radians(np.asarray(ypr_deg, np.float64))
    cy, sy = math.cos(y), math.sin(y)
    cp, sp = math.cos(p), math.sin(p)
    cr, sr = math.cos(r), math.sin(r)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def from_two_vectors(a, b):
    """Shortest-arc rotation taking unit a to unit b."""
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K / max(1 + c, 1e-12)

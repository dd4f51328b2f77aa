"""Broadcast-ephemeris satellite position/velocity/clock + atmosphere models.

The surface of ``gnss_comm``'s ephemeris module used by the reference
(``eph2pos``/``eph2vel``/``eph2svdt`` for GPS/Galileo/BeiDou Kepler
ephemerides, ``geph2pos``/``geph2vel``/``geph2svdt`` for GLONASS state-vector
ephemerides, Klobuchar ionosphere and Saastamoinen troposphere, as consumed by
``gnss_psr_dopp_factor.cpp:10-48,80-85``). Host-side numpy: ephemeris
evaluation is scalar-heavy and runs at epoch rate, not solver rate (SURVEY §7
stage 6 keeps it off-device by design).

Ephemerides are plain dicts with RINEX-standard field names.
"""

from __future__ import annotations

import numpy as np

from .coords import EARTH_OMG, GM_EARTH, LIGHT_SPEED, F_RELATIVITY

GM_GAL = 3.986004418e14
GM_BDS = 3.986004418e14
OMG_GAL = 7.2921151467e-5
OMG_BDS = 7.292115e-5


def eph2svdt(t_sv: float, eph: dict) -> float:
    """Satellite clock bias (s) from the broadcast polynomial at sv time
    ``t_sv`` (seconds relative to toc)."""
    dt = t_sv - eph["toc"]
    for _ in range(2):
        dt = (t_sv - eph["toc"]) - (eph["af0"] + eph["af1"] * dt + eph["af2"] * dt * dt)
    return eph["af0"] + eph["af1"] * dt + eph["af2"] * dt * dt


def eph2pos(t: float, eph: dict):
    """Kepler broadcast ephemeris → (sat ECEF pos [3], clock bias incl.
    relativity). ``t`` is seconds-of-week in the satellite system time."""
    sys = eph.get("sys", "GPS")
    mu = {"GPS": GM_EARTH, "GAL": GM_GAL, "BDS": GM_BDS}.get(sys, GM_EARTH)
    omge = {"GPS": EARTH_OMG, "GAL": OMG_GAL, "BDS": OMG_BDS}.get(sys, EARTH_OMG)

    A = eph["sqrtA"] ** 2
    n0 = np.sqrt(mu / A**3)
    tk = t - eph["toe"]
    n = n0 + eph["deln"]
    M = eph["M0"] + n * tk
    # Kepler solve
    E = M
    for _ in range(30):
        Enew = E - (E - eph["e"] * np.sin(E) - M) / (1.0 - eph["e"] * np.cos(E))
        if abs(Enew - E) < 1e-13:
            E = Enew
            break
        E = Enew
    sinE, cosE = np.sin(E), np.cos(E)
    nu = np.arctan2(np.sqrt(1.0 - eph["e"] ** 2) * sinE, cosE - eph["e"])
    phi = nu + eph["omg"]
    s2p, c2p = np.sin(2 * phi), np.cos(2 * phi)
    du = eph["cus"] * s2p + eph["cuc"] * c2p
    dr = eph["crs"] * s2p + eph["crc"] * c2p
    di = eph["cis"] * s2p + eph["cic"] * c2p
    u = phi + du
    r = A * (1.0 - eph["e"] * cosE) + dr
    i = eph["i0"] + eph["idot"] * tk + di
    x_op = r * np.cos(u)
    y_op = r * np.sin(u)
    si, ci = np.sin(i), np.cos(i)
    if sys == "BDS" and eph.get("geo", False):
        # BeiDou GEO satellites broadcast in a frame rotated −5° about x and
        # without the earth-rotation rate folded into Ω (RTKLIB eph2pos /
        # gnss_comm: compute in the inertial-ish frame, then apply
        # Rz(ω_e·tk)·Rx(−5°))
        OMG = eph["OMG0"] + eph["OMGd"] * tk - omge * eph["toe"]
        sO, cO = np.sin(OMG), np.cos(OMG)
        xg = x_op * cO - y_op * ci * sO
        yg = x_op * sO + y_op * ci * cO
        zg = y_op * si
        so, co = np.sin(omge * tk), np.cos(omge * tk)
        s5, c5 = np.sin(np.deg2rad(-5.0)), np.cos(np.deg2rad(-5.0))
        pos = np.array([
            xg * co + yg * so * c5 + zg * so * s5,
            -xg * so + yg * co * c5 + zg * co * s5,
            -yg * s5 + zg * c5,
        ])
    else:
        OMG = eph["OMG0"] + (eph["OMGd"] - omge) * tk - omge * eph["toe"]
        sO, cO = np.sin(OMG), np.cos(OMG)
        pos = np.array([
            x_op * cO - y_op * ci * sO,
            x_op * sO + y_op * ci * cO,
            y_op * si,
        ])
    # clock with relativistic correction
    dts = eph2svdt(t, eph) + F_RELATIVITY * eph["e"] * eph["sqrtA"] * sinE
    return pos, dts


def eph2vel(t: float, eph: dict, h: float = 1e-3):
    """Satellite ECEF velocity + clock drift by central difference (matches
    gnss_comm's analytic derivative to ~1e-6 m/s at 1 ms step)."""
    p1, c1 = eph2pos(t - h, eph)
    p2, c2 = eph2pos(t + h, eph)
    return (p2 - p1) / (2 * h), (c2 - c1) / (2 * h)


def _glo_deriv(x: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """GLONASS ECEF orbital derivative with J2 (gnss_comm ``deq``)."""
    J2 = 1.0826257e-3
    GM = 3.9860044e14
    RE = 6378136.0
    OMG = 7.292115e-5
    r2 = np.dot(x[0:3], x[0:3])
    r = np.sqrt(r2)
    a = GM / (r2 * r)
    b = 1.5 * J2 * GM * RE * RE / (r2 * r2 * r)
    c = x[2] * x[2] / r2
    dx = np.zeros(6)
    dx[0:3] = x[3:6]
    dx[3] = -(a + b * (1 - 5 * c)) * x[0] + OMG * OMG * x[0] + 2 * OMG * x[4] + acc[0]
    dx[4] = -(a + b * (1 - 5 * c)) * x[1] + OMG * OMG * x[1] - 2 * OMG * x[3] + acc[1]
    dx[5] = -(a + b * (3 - 5 * c)) * x[2] + acc[2]
    return dx


def geph2pos(t: float, geph: dict):
    """GLONASS state-vector ephemeris: RK4 integration from toe
    (gnss_comm ``geph2pos``). Returns (pos [3], clock bias)."""
    x = np.concatenate([np.asarray(geph["pos"]), np.asarray(geph["vel"])]).astype(float)
    acc = np.asarray(geph["acc"], float)
    tk = t - geph["toe"]
    h = 60.0 if tk >= 0 else -60.0
    while abs(tk) > 1e-9:
        if abs(tk) < abs(h):
            h = tk
        k1 = _glo_deriv(x, acc)
        k2 = _glo_deriv(x + k1 * h / 2, acc)
        k3 = _glo_deriv(x + k2 * h / 2, acc)
        k4 = _glo_deriv(x + k3 * h, acc)
        x = x + (k1 + 2 * k2 + 2 * k3 + k4) * h / 6.0
        tk -= h
    dts = -geph["tau_n"] + geph["gamma"] * (t - geph["toe"])
    return x[0:3], dts


def geph2vel(t: float, geph: dict, h: float = 1e-3):
    p1, _ = geph2pos(t - h, geph)
    p2, _ = geph2pos(t + h, geph)
    dts_dot = geph["gamma"]
    return (p2 - p1) / (2 * h), dts_dot


def klobuchar_iono(tow: float, iono_paras, lla: np.ndarray, az: float, el: float) -> float:
    """Klobuchar L1 ionospheric delay in meters (gnss_comm
    ``calculate_ion_delay``; RTKLIB ionmodel)."""
    if iono_paras is None or len(iono_paras) < 8 or lla[2] < -1000:
        return 0.0
    a = np.asarray(iono_paras, float)
    if np.all(a == 0):
        return 0.0
    psi = 0.0137 / (el / np.pi + 0.11) - 0.022
    phi = lla[0] / np.pi + psi * np.cos(az)
    phi = np.clip(phi, -0.416, 0.416)
    lam = lla[1] / np.pi + psi * np.sin(az) / np.cos(phi * np.pi)
    phi += 0.064 * np.cos((lam - 1.617) * np.pi)
    tt = 43200.0 * lam + tow
    tt -= np.floor(tt / 86400.0) * 86400.0
    f = 1.0 + 16.0 * (0.53 - el / np.pi) ** 3
    amp = max(a[0] + phi * (a[1] + phi * (a[2] + phi * a[3])), 0.0)
    per = max(a[4] + phi * (a[5] + phi * (a[6] + phi * a[7])), 72000.0)
    x = 2.0 * np.pi * (tt - 50400.0) / per
    if abs(x) < 1.57:
        delay = LIGHT_SPEED * f * (5e-9 + amp * (1.0 + x * x * (-0.5 + x * x / 24.0)))
    else:
        delay = LIGHT_SPEED * f * 5e-9
    return float(delay)


def saastamoinen_tropo(lla: np.ndarray, el: float, humidity: float = 0.7) -> float:
    """Saastamoinen tropospheric delay in meters (gnss_comm
    ``calculate_trop_delay``; RTKLIB tropmodel)."""
    if lla[2] < -100 or lla[2] > 10000 or el <= 0:
        return 0.0
    hgt = max(lla[2], 0.0)
    pres = 1013.25 * (1.0 - 2.2557e-5 * hgt) ** 5.2568
    temp = 15.0 - 6.5e-3 * hgt + 273.16
    e = 6.108 * humidity * np.exp((17.15 * temp - 4684.0) / (temp - 38.45))
    z = np.pi / 2.0 - el
    trph = 0.0022768 * pres / (1.0 - 0.00266 * np.cos(2.0 * lla[0]) - 0.00028 * hgt / 1e3) / np.cos(z)
    trpw = 0.002277 * (1255.0 / temp + 0.05) * e / np.cos(z)
    return float(trph + trpw)

"""Single-point positioning (coarse ECEF fix) + Doppler velocity solve.

The surface of gnss_comm's ``psr_pos``/``dopp_vel`` used by the GNSS-VI
initializer (``initial/gnss_vi_initializer.cpp:16-56`` coarse SPP) — an
iterated least squares over pseudoranges with per-constellation receiver
clocks, and a linear LS over Dopplers for velocity + clock drift. Host-side
numpy (runs once per epoch at initialization)."""

from __future__ import annotations

import numpy as np

from .coords import EARTH_OMG, LIGHT_SPEED, ecef2geo, sat_azel
from .ephemeris import klobuchar_iono, saastamoinen_tropo

SYS_IDX = {"GPS": 0, "GLO": 1, "GAL": 2, "BDS": 3}


def spp_solve(obs_list, x0=None, iono_paras=None, iters: int = 10, apply_atmo: bool = True):
    """Iterated-LS SPP.

    ``obs_list``: list of dicts with keys ``sat_pos`` [3], ``psr``, ``svdt``
    (s), ``sys`` (0..3), optional ``tgd`` (s). Returns (rcv_ecef [3],
    rcv_dt [4] m, ok)."""
    if len(obs_list) < 4:
        return np.zeros(3), np.zeros(4), False
    x = np.zeros(7) if x0 is None else np.concatenate([x0, np.zeros(4)])
    systems = sorted({o["sys"] for o in obs_list})
    sys_col = {s: 3 + i for i, s in enumerate(systems)}
    n_par = 3 + len(systems)
    x = x[:n_par]

    for it in range(iters):
        A = np.zeros((len(obs_list), n_par))
        r = np.zeros(len(obs_list))
        for k, o in enumerate(obs_list):
            sp = np.asarray(o["sat_pos"], float)
            rng_vec = sp - x[0:3]
            rng = np.linalg.norm(rng_vec)
            los = rng_vec / max(rng, 1e-6)
            sagnac = EARTH_OMG * (sp[0] * x[1] - sp[1] * x[0]) / LIGHT_SPEED
            atm = 0.0
            if apply_atmo and np.linalg.norm(x[0:3]) > 1e6:
                az, el = sat_azel(x[0:3], sp)
                lla = ecef2geo(x[0:3])
                atm = saastamoinen_tropo(lla, el)
                if iono_paras is not None:
                    atm += klobuchar_iono(o.get("tow", 0.0), iono_paras, lla, az, el)
            est = rng + sagnac + x[sys_col[o["sys"]]] - o["svdt"] * LIGHT_SPEED \
                + o.get("tgd", 0.0) * LIGHT_SPEED + atm
            r[k] = o["psr"] - est
            A[k, 0:3] = -los
            A[k, sys_col[o["sys"]]] = 1.0
        dx, *_ = np.linalg.lstsq(A, r, rcond=None)
        x = x + dx
        if np.linalg.norm(dx) < 1e-4:
            break
    rcv_dt = np.zeros(4)
    for s, c in sys_col.items():
        rcv_dt[s] = x[c]
    ok = np.linalg.norm(dx) < 1.0
    return x[0:3], rcv_dt, ok


def dopp_vel_solve(obs_list, rcv_ecef):
    """Linear LS for receiver ECEF velocity + clock drift from Dopplers.

    obs entries additionally need ``sat_vel`` [3], ``dopp`` (m/s, positive =
    approaching convention as used by the reference: dopp*wavelength added),
    ``svddt`` (s/s). Returns (vel [3], ddt, ok)."""
    if len(obs_list) < 4:
        return np.zeros(3), 0.0, False
    A = np.zeros((len(obs_list), 4))
    r = np.zeros(len(obs_list))
    for k, o in enumerate(obs_list):
        sp = np.asarray(o["sat_pos"], float)
        sv = np.asarray(o["sat_vel"], float)
        los = (sp - rcv_ecef) / np.linalg.norm(sp - rcv_ecef)
        # measured range-rate (reference convention: -dopp*wavelength);
        # "dopp" here is doppler×wavelength in m/s — fall back to the
        # factor-table key when a caller only carries dopp_wl
        rate = -o.get("dopp", o.get("dopp_wl", 0.0))
        r[k] = rate - (np.dot(sv, los) - o["svddt"] * LIGHT_SPEED)
        A[k, 0:3] = -los
        A[k, 3] = 1.0
    x, *_ = np.linalg.lstsq(A, r, rcond=None)
    return x[0:3], float(x[3]), True

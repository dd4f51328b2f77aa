"""Synthetic GNSS observations from a known receiver trajectory.

A sky of satellites on a 22 000 km shell above an anchor, and for each epoch
the raw float64 pseudoranges and Dopplers a receiver at a given ECEF position
and velocity would report: geometric range, Sagnac term, receiver clock per
constellation, Saastamoinen troposphere, clock drift and the Sagnac rate in
the Doppler. The rows of ``gnss.csv`` (:mod:`..io.dataset`) and the reduced
window table of :mod:`..gnss.factors` are built from these. Host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gnss.coords import EARTH_OMG, LIGHT_SPEED, ecef2geo, ecef2rotation, enu2ecef, sat_azel
from ..gnss.ephemeris import saastamoinen_tropo
from ..gnss.factors import SLOT_SCALARS, SLOT_VECTORS, GnssObsWindow
from ..gnss.ingest import reduce_obs

SHELL_M = 2.2e7


def sky(anc_ecef: np.ndarray, n: int, rng: np.random.Generator, el_deg=(25.0, 85.0)) -> np.ndarray:
    """``n`` satellite ECEF positions at uniform azimuths and elevations in
    ``el_deg`` as seen from ``anc_ecef`` (one azimuth then one elevation draw
    per satellite from ``rng``)."""
    sats = []
    for _ in range(n):
        az = rng.uniform(0, 2 * np.pi)
        el = rng.uniform(np.deg2rad(el_deg[0]), np.deg2rad(el_deg[1]))
        sats.append(enu2ecef(anc_ecef, SHELL_M * np.array(
            [np.cos(el) * np.sin(az), np.cos(el) * np.cos(az), np.sin(el)])))
    return np.stack(sats)


def observe(P: np.ndarray, V: np.ndarray, sats: np.ndarray, sat_vel: np.ndarray,
            dt_sys: np.ndarray, ddt: float, tropo: bool = True, psr_std: float = 0.1,
            dopp_std: float = 0.1, ura: float = 2.0) -> list[dict]:
    """One epoch seen by a receiver at ECEF ``P`` moving at ``V``: satellite
    j is of constellation ``(j % 2) * 3`` (GPS, BeiDou), with receiver clock
    ``dt_sys[sys]`` m and drift ``ddt`` m/s; no satellite clock, TGD or
    ionosphere. ``tropo`` adds the Saastamoinen delay the factor subtracts."""
    obs = []
    for j, (sp, sv) in enumerate(zip(sats, sat_vel)):
        rng_vec = sp - P
        rngn = np.linalg.norm(rng_vec)
        unit = rng_vec / rngn
        sagnac = EARTH_OMG * (sp[0] * P[1] - sp[1] * P[0]) / LIGHT_SPEED
        sys = (j % 2) * 3
        atm = saastamoinen_tropo(ecef2geo(P), sat_azel(P, sp)[1]) if tropo else 0.0
        d_sagnac = EARTH_OMG / LIGHT_SPEED * (
            sv[0] * P[1] + sp[0] * V[1] - sv[1] * P[0] - sp[1] * V[0])
        dopp_est = np.dot(sv - V, unit) + d_sagnac + ddt
        obs.append(dict(
            sat=j, sys=sys, sat_pos=sp, sat_vel=sv,
            psr=rngn + sagnac + dt_sys[sys] + atm, dopp_wl=-dopp_est,
            dopp=-dopp_est, svdt=0.0, svddt=0.0, tgd=0.0,
            psr_std=psr_std, dopp_std=dopp_std, ura=ura,
        ))
    return obs


def csv_rows(t: float, epoch: list[dict]) -> np.ndarray:
    """The ``gnss.csv`` rows of one epoch: t, sat, sys, psr, dopp×wavelength,
    psr_std, dopp_std, sat_pos[3], sat_vel[3], svdt, svddt, tgd, ura."""
    return np.stack([np.concatenate([
        [t, o["sat"], o["sys"], o["psr"], o["dopp_wl"], o["psr_std"], o["dopp_std"]],
        o["sat_pos"], o["sat_vel"], [o["svdt"], o["svddt"], o["tgd"], o["ura"]]])
        for o in epoch])


def window_obs_at_truth(anc: np.ndarray, yaw_enu: float, positions: np.ndarray,
                        vels: np.ndarray, dt_vals: np.ndarray, ddt_vals: np.ndarray,
                        n_sats: int = 8, dtype=torch.float64, device=None) -> GnssObsWindow:
    """A window table consistent with a known state: an epoch at each frame
    k < F-1 (ratio 1) seen from ``anc + R(anc)·R_z(yaw_enu)·positions[k]``,
    raw float64 ranges reduced against ``anc`` on the host as ingest does,
    unit weights, no atmosphere. Satellites from seed 3, their velocities
    from seed 4."""
    f, s = positions.shape[0], n_sats
    R_el = ecef2rotation(anc)
    cy, sy = np.cos(yaw_enu), np.sin(yaw_enu)
    R = R_el @ np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    sats = sky(anc, s, np.random.default_rng(3))
    sat_vel = np.random.default_rng(4).normal(0, 2500, (s, 3))
    tbl = {k: np.zeros((f, s)) for k in SLOT_SCALARS}
    vec = {k: np.zeros((f, s, 3)) for k in SLOT_VECTORS}
    sysm = np.zeros((f, s), np.int64)
    valid = np.zeros((f, s), bool)
    for k in range(f - 1):
        P = R @ positions[k] + anc
        epoch = observe(P, R @ vels[k], sats, sat_vel, dt_vals[k], ddt_vals[k], tropo=False)
        for j, raw in enumerate(epoch):
            red = reduce_obs(anc, R_el, raw, atm=0.0)
            for key in ("rng0", "psr_red", "dopp_red"):
                tbl[key][k, j] = red[key]
            for key in SLOT_VECTORS:
                vec[key][k, j] = red[key]
            sysm[k, j] = raw["sys"]
            valid[k, j] = True
    for key in ("pr_weight", "dp_weight", "ratio"):
        tbl[key][:] = valid
    kw = dict(dtype=dtype, device=device)
    return GnssObsWindow(
        **{k: torch.as_tensor(v, **kw) for k, v in {**tbl, **vec}.items()},
        sys=torch.as_tensor(sysm, device=device), valid=torch.as_tensor(valid, device=device))

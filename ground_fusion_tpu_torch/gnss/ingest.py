"""Host-side GNSS ingest: quality gates, track-count filter, window table
construction, alignment bookkeeping.

The counterpart of ``Estimator::processGNSS`` (``estimator.cpp:1455-1535``:
psr/dopp std gates, per-satellite track-epoch counter, elevation mask once
aligned) and of the per-solve factor preparation (``estimator.cpp:3178-3207``)
that here fills the padded :class:`~..gnss.factors.GnssObsWindow` device
table. Observations arrive as plain dicts (the gnss_comm ObsPtr surface):

    {sat: int, sys: 0..3, sat_pos: [3], sat_vel: [3], psr: float,
     dopp_wl: float, psr_std: float, dopp_std: float, svdt: float,
     svddt: float, tgd: float, ura: float, tow: float}
"""

from __future__ import annotations

import numpy as np

from .coords import EARTH_OMG, LIGHT_SPEED, ecef2geo, ecef2rotation, sat_azel
from .ephemeris import klobuchar_iono, saastamoinen_tropo
from .factors import PSR_TO_DOPP_RATIO, RELATIVE_SQRT_INFO


def reduce_obs(anc0: np.ndarray, R0: np.ndarray, o: dict,
               atm: float) -> dict:
    """Reduce one raw observation against the float64 expansion anchor
    (see :class:`..gnss.factors.GnssObsWindow`): all catastrophic
    cancellations (psr − range, sat − receiver) happen HERE in float64; the
    device sees only small, f32-stable quantities."""
    sp = np.asarray(o["sat_pos"], np.float64)
    sv = np.asarray(o.get("sat_vel", np.zeros(3)), np.float64)
    anc0 = np.asarray(anc0, np.float64)
    rvec = sp - anc0
    rng0 = float(np.linalg.norm(rvec))
    sagnac0 = EARTH_OMG / LIGHT_SPEED * (sp[0] * anc0[1] - sp[1] * anc0[0])
    zxs = np.array([-sp[1], sp[0], 0.0])        # ẑ_ecef × sat_pos
    zxv = np.array([-sv[1], sv[0], 0.0])        # ẑ_ecef × sv_vel
    return dict(
        rvec0=R0.T @ rvec,
        rng0=rng0,
        psr_red=(float(o["psr"]) - rng0 - sagnac0
                 + float(o.get("svdt", 0.0)) * LIGHT_SPEED
                 - float(atm) - float(o.get("tgd", 0.0)) * LIGHT_SPEED),
        dopp_red=(float(o["dopp_wl"])
                  - float(o.get("svddt", 0.0)) * LIGHT_SPEED
                  + EARTH_OMG / LIGHT_SPEED
                  * (sv[0] * anc0[1] - sv[1] * anc0[0])),
        sv_vel=R0.T @ sv,
        sagnac_vec=EARTH_OMG / LIGHT_SPEED * (R0.T @ zxs),
        dsag_vec=EARTH_OMG / LIGHT_SPEED * (R0.T @ zxv),
    )


class GnssIngest:
    def __init__(self, cfg, iono_paras=None):
        self.cfg = cfg.gnss
        self.iono_paras = iono_paras
        self.track_count: dict[int, int] = {}
        self.epochs: list[list[dict]] = []        # per-frame filtered epochs
        # float64 expansion anchor installed at GNSS-VI alignment; every
        # window-table slot is reduced against it (reduce_obs)
        self.anc0: np.ndarray | None = None
        self.R0: np.ndarray | None = None

    def set_anchor(self, anc_ecef: np.ndarray) -> None:
        self.anc0 = np.asarray(anc_ecef, np.float64).copy()
        self.R0 = np.asarray(ecef2rotation(self.anc0), np.float64)

    def anchor_ecef(self, danc_enu) -> np.ndarray:
        """Absolute ECEF anchor from the state's ENU delta column."""
        return self.anc0 + self.R0 @ np.asarray(danc_enu, np.float64)

    def process_epoch(self, obs_list, aligned: bool, anc_ecef=None) -> list[dict]:
        """Apply the reference's gates; returns the accepted observations and
        appends them as this frame's epoch."""
        valid = []
        for o in obs_list:
            if o.get("psr_std", 0.0) > self.cfg.psr_std_thresh or \
               o.get("dopp_std", 0.0) > self.cfg.dopp_std_thresh:
                self.track_count[o["sat"]] = 0
                continue
            self.track_count[o["sat"]] = self.track_count.get(o["sat"], 0) + 1
            if self.track_count[o["sat"]] < self.cfg.track_num_thresh:
                continue
            if aligned and anc_ecef is not None:
                _, el = sat_azel(anc_ecef, np.asarray(o["sat_pos"]))
                if el < np.deg2rad(self.cfg.elevation_mask_deg):
                    continue
            valid.append(o)
        self.epochs.append(valid)
        return valid

    def pop_frame_epochs(self, n_keep: int):
        if len(self.epochs) > n_keep:
            self.epochs = self.epochs[-n_keep:]

    def build_slot(self, obs_list, anc_ecef, p_local_ecef=None):
        """One window-table slot from an epoch in REDUCED-OBSERVABLE form:
        weights from elevation + URA (gnss_psr_dopp_factor.cpp:22-48, 86-89),
        atmosphere precomputed at the current position estimate (:80-85), and
        every absolute-geometry cancellation done in float64 against the
        alignment anchor (:func:`reduce_obs`). Requires :meth:`set_anchor`
        to have run (pre-alignment epochs are kept raw on the host and
        installed at alignment — ``pipeline._install_window_epochs``)."""
        assert self.anc0 is not None, "build_slot before GNSS-VI alignment"
        s_max = self.cfg.max_sats
        out = {k: np.zeros(s_max) for k in
               ("rng0", "psr_red", "dopp_red", "pr_weight", "dp_weight",
                "ratio")}
        vec = {k: np.zeros((s_max, 3)) for k in
               ("rvec0", "sv_vel", "sagnac_vec", "dsag_vec")}
        sysm = np.zeros(s_max, np.int32)
        valid = np.zeros(s_max, bool)
        pos = np.asarray(p_local_ecef if p_local_ecef is not None else anc_ecef)
        has_pos = np.linalg.norm(pos) > 1e6
        lla = ecef2geo(pos) if has_pos else np.zeros(3)
        for i, o in enumerate(obs_list[:s_max]):
            sp = np.asarray(o["sat_pos"])
            az, el = sat_azel(pos, sp) if has_pos else (0.0, np.pi / 2.0)
            ura = max(o.get("ura", 2.0), 1.1)
            pr_uura = (ura - 1.0) * (o.get("psr_std", 0.16) / 0.16)
            dp_uura = (ura - 1.0) * (o.get("dopp_std", 0.256) / 0.256)
            sin_el2 = np.sin(el) ** 2
            out["pr_weight"][i] = sin_el2 / max(pr_uura, 1e-3) * RELATIVE_SQRT_INFO
            out["dp_weight"][i] = (sin_el2 / max(dp_uura, 1e-3)
                                   * RELATIVE_SQRT_INFO * PSR_TO_DOPP_RATIO)
            atm = saastamoinen_tropo(lla, el) if has_pos else 0.0
            if has_pos and self.iono_paras is not None:
                atm += klobuchar_iono(o.get("tow", 0.0), self.iono_paras, lla, az, el)
            red = reduce_obs(self.anc0, self.R0, o, atm)
            for k in ("rng0", "psr_red", "dopp_red"):
                out[k][i] = red[k]
            for k in ("rvec0", "sv_vel", "sagnac_vec", "dsag_vec"):
                vec[k][i] = red[k]
            out["ratio"][i] = o.get("ratio", 1.0)
            sysm[i] = o["sys"]
            valid[i] = True
        return dict(sys=sysm, valid=valid, **vec, **out)

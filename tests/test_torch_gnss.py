"""PyTorch port vs JAX package: the GNSS modules, the anchor factors, the
old-frame marginalization with GNSS rows and the GPS/VIO global fusion.

The same numpy-seeded inputs go through both packages: the host modules
(coordinates, ephemerides, atmosphere, SPP, Doppler velocity, GNSS-VI
alignment, ingest gates and slot building, epoch attachment) agree within
1e-12; the psr/Doppler and clock-chain rows within 1e-10 at a random float64
state with F = 5 and S = 16; marginalization and global fusion within 1e-8.
The float32 residual at ground truth is held to 5 mm on the port alone.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.estimator import assembly as jasm
from ground_fusion_tpu.estimator import factors as jfac
from ground_fusion_tpu.estimator import marginalization as jmarg
from ground_fusion_tpu.estimator.layout import StateLayout as JLayout
from ground_fusion_tpu.estimator.window import empty_state as jempty_state
from ground_fusion_tpu.gnss import align as jalign
from ground_fusion_tpu.gnss import coords as jcoords
from ground_fusion_tpu.gnss import ephemeris as jeph
from ground_fusion_tpu.gnss import factors as jgf
from ground_fusion_tpu.gnss import ingest as jingest
from ground_fusion_tpu.gnss import spp as jspp
from ground_fusion_tpu.global_layers.global_fusion import GlobalFusion as JGlobalFusion
from ground_fusion_tpu.pipeline import Estimator as JEstimator
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.estimator import assembly as tasm
from ground_fusion_tpu_torch.estimator import factors as tfac
from ground_fusion_tpu_torch.estimator import marginalization as tmarg
from ground_fusion_tpu_torch.estimator.layout import StateLayout as TLayout
from ground_fusion_tpu_torch.estimator.window import empty_state as tempty_state
from ground_fusion_tpu_torch.global_layers.global_fusion import GlobalFusion as TGlobalFusion
from ground_fusion_tpu_torch.gnss import align as talign
from ground_fusion_tpu_torch.gnss import coords as tcoords
from ground_fusion_tpu_torch.gnss import ephemeris as teph
from ground_fusion_tpu_torch.gnss import factors as tgf
from ground_fusion_tpu_torch.gnss import ingest as tingest
from ground_fusion_tpu_torch.gnss import spp as tspp
from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
from ground_fusion_tpu_torch.sim import gnss as tsim_gnss
from ground_fusion_tpu_torch.utils import convert
from test_gnss import _gps_eph, _make_sats, _window_gnss_obs

JD, TD = jnp.float64, torch.float64
HOST_TOL = 1e-12
ROW_TOL = 1e-10
ANC = jcoords.geo2ecef(np.array([np.deg2rad(31.0), np.deg2rad(121.4), 15.0]))


def _close(a, b, tol, scale=1.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(scale, np.abs(a).max(initial=0.0)), \
        np.abs(a - b).max()


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


# ------------------------------------------------------------- host modules


def test_coords_match():
    lla = np.array([np.deg2rad(31.0), np.deg2rad(121.4), 25.0])
    x = jcoords.geo2ecef(lla)
    _close(tcoords.geo2ecef(lla), x, HOST_TOL)
    _close(tcoords.ecef2geo(x), jcoords.ecef2geo(x), HOST_TOL)
    _close(tcoords.ecef2rotation(x), jcoords.ecef2rotation(x), HOST_TOL)
    sat = jcoords.enu2ecef(x, np.array([1e7, 5e6, 2e7]))
    _close(tcoords.enu2ecef(x, [3.0, -2.0, 1.0]), jcoords.enu2ecef(x, [3.0, -2.0, 1.0]), HOST_TOL)
    _close(tcoords.ecef2enu(x, sat), jcoords.ecef2enu(x, sat), HOST_TOL)
    _close(tcoords.sat_azel(x, sat), jcoords.sat_azel(x, sat), HOST_TOL)
    # the differentiable twin, on a float64 tensor
    _close(tgf.ecef2rotation_j(_t(x)).numpy(), np.asarray(jgf.ecef2rotation_j(jnp.asarray(x))),
           HOST_TOL)


def _bds_geo_eph():
    return dict(_gps_eph(), sys="BDS", geo=True, sqrtA=np.sqrt(42164000.0), i0=np.deg2rad(1.0))


def _glo_eph():
    return dict(pos=[1.2e7, -1.5e7, 1.6e7], vel=[2500.0, 1800.0, -600.0], acc=[1e-6, -2e-6, 0.0],
                toe=7200.0, tau_n=2e-5, gamma=1e-12)


@pytest.mark.parametrize("case", ["gps", "bds_geo", "glonass", "svdt"])
def test_ephemerides_match(case):
    t = 7500.0
    if case == "glonass":
        g = _glo_eph()
        for fn in ("geph2pos", "geph2vel"):
            a, b = getattr(teph, fn)(t, g), getattr(jeph, fn)(t, g)
            _close(a[0], b[0], HOST_TOL)
            _close(a[1], b[1], HOST_TOL)
        return
    eph = _gps_eph() if case != "bds_geo" else _bds_geo_eph()
    if case == "svdt":
        _close(teph.eph2svdt(t, eph), jeph.eph2svdt(t, eph), HOST_TOL)
        return
    for fn in ("eph2pos", "eph2vel"):
        a, b = getattr(teph, fn)(t, eph), getattr(jeph, fn)(t, eph)
        _close(a[0], b[0], HOST_TOL)
        _close(a[1], b[1], HOST_TOL)


def test_atmosphere_matches():
    lla = np.array([np.deg2rad(31.0), np.deg2rad(121.4), 25.0])
    iono = [1.1e-8, 1.5e-8, -6e-8, -6e-8, 9e4, 1.1e5, -1.3e5, -3.9e5]
    for az, el in ((0.3, 0.4), (2.0, 1.2), (-1.0, 0.1)):
        _close(teph.klobuchar_iono(3600.0 * 30, iono, lla, az, el),
               jeph.klobuchar_iono(3600.0 * 30, iono, lla, az, el), HOST_TOL)
        _close(teph.saastamoinen_tropo(lla, el), jeph.saastamoinen_tropo(lla, el), HOST_TOL)


def _spp_epoch(rcv, seed, with_atm=False):
    sats = _make_sats(rcv, n=9, seed=seed)
    rng = np.random.default_rng(seed + 1)
    obs = []
    for k, sp in enumerate(sats):
        sys = 0 if k % 2 == 0 else 3
        sv = rng.normal(0, 2500, 3)
        los = (sp - rcv) / np.linalg.norm(sp - rcv)
        sagnac = jcoords.EARTH_OMG * (sp[0] * rcv[1] - sp[1] * rcv[0]) / jcoords.LIGHT_SPEED
        obs.append(dict(sat_pos=sp, sat_vel=sv, sys=sys, svdt=2e-5, svddt=1e-11, tow=1000.0,
                        psr=np.linalg.norm(sp - rcv) + sagnac + (12.5 if sys == 0 else 14.0)
                        - 2e-5 * jcoords.LIGHT_SPEED + rng.normal(0, 0.5),
                        dopp=-(np.dot(sv - [1.2, -0.4, 0.1], los) + 3.0)))
    return obs


@pytest.mark.parametrize("atmo", [False, True], ids=["plain", "atmosphere"])
def test_spp_and_doppler_velocity_match(atmo):
    rcv = jcoords.geo2ecef(np.array([np.deg2rad(31.0), np.deg2rad(121.4), 20.0]))
    obs = _spp_epoch(rcv, 0)
    iono = [1.1e-8, 1.5e-8, -6e-8, -6e-8, 9e4, 1.1e5, -1.3e5, -3.9e5] if atmo else None
    a = tspp.spp_solve(obs, iono_paras=iono, apply_atmo=atmo)
    b = jspp.spp_solve(obs, iono_paras=iono, apply_atmo=atmo)
    for x, y in zip(a, b):
        _close(x, y, HOST_TOL, scale=1.0)
    assert a[2]
    for x, y in zip(tspp.dopp_vel_solve(obs, rcv), jspp.dopp_vel_solve(obs, rcv)):
        _close(x, y, HOST_TOL)


def _align_epochs(yaw_true=0.42, seed=9, n_ep=8):
    """The synthetic alignment case of tests/test_gnss.py."""
    anc_true = jcoords.geo2ecef(np.array([np.deg2rad(31.0), np.deg2rad(121.4), 18.0]))
    cy, sy = np.cos(yaw_true), np.sin(yaw_true)
    R = jcoords.ecef2rotation(anc_true) @ np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    local_pos = np.cumsum(rng.normal(0, 1.0, (n_ep, 3)), axis=0)
    local_vels = rng.normal(0, 1.0, (n_ep, 3))
    local_vels[:, 2] *= 0.1
    sats = _make_sats(anc_true, n=8, seed=12)
    sat_vel = rng.normal(0, 2500, (8, 3))
    epochs = []
    for k in range(n_ep):
        P, V = anc_true + R @ local_pos[k], R @ local_vels[k]
        ep = []
        for sp, sv in zip(sats, sat_vel):
            los = (sp - P) / np.linalg.norm(sp - P)
            sagnac = jcoords.EARTH_OMG * (sp[0] * P[1] - sp[1] * P[0]) / jcoords.LIGHT_SPEED
            ep.append(dict(sat_pos=sp, sat_vel=sv, sys=0, svdt=0.0, svddt=0.0,
                           psr=np.linalg.norm(sp - P) + sagnac + 8.0,
                           dopp=-(np.dot(sv - V, los) + 2.0)))
        epochs.append(ep)
    return local_pos, local_vels, epochs


def test_gnss_vi_align_matches():
    pos, vel, epochs = _align_epochs()
    a = talign.gnss_vi_align(pos, vel, epochs)
    b = jalign.gnss_vi_align(pos, vel, epochs)
    assert a[3] and b[3]
    for x, y in zip(a, b):
        _close(x, y, HOST_TOL)
    # and the motion gate: standing still, no alignment in either
    assert talign.gnss_vi_align(pos, 0.01 * vel, epochs)[3] is False
    assert jalign.gnss_vi_align(pos, 0.01 * vel, epochs)[3] is False


def _ingest_epochs():
    """Three epochs at one receiver with a bad-std satellite, a low
    satellite and the rest good, through GnssIngest with track_num_thresh 2."""
    sats = np.concatenate([_make_sats(ANC, n=7, seed=2),
                           [jcoords.enu2ecef(ANC, 2.2e7 * np.array([0.0, np.cos(0.2), np.sin(0.2)]))]])
    rng = np.random.default_rng(6)
    eps = []
    for k in range(3):
        ep = []
        for j, sp in enumerate(sats):
            ep.append(dict(sat=j, sys=(j % 2) * 3, sat_pos=sp, sat_vel=rng.normal(0, 2500, 3),
                           psr=np.linalg.norm(sp - ANC) + rng.normal(0, 3.0), dopp_wl=rng.normal(),
                           psr_std=5.0 if (j == 1 and k == 1) else 0.2, dopp_std=0.3,
                           svdt=1e-5, svddt=1e-11, tgd=1e-9, ura=3.0, tow=5000.0 + k))
        eps.append(ep)
    return eps


def test_ingest_gates_and_slots_match():
    cfg_j = JConfig()
    cfg_j = dataclasses.replace(cfg_j, gnss=dataclasses.replace(cfg_j.gnss, track_num_thresh=2))
    cfg_t = TConfig()
    cfg_t = dataclasses.replace(cfg_t, gnss=dataclasses.replace(cfg_t.gnss, track_num_thresh=2))
    iono = [1.1e-8, 1.5e-8, -6e-8, -6e-8, 9e4, 1.1e5, -1.3e5, -3.9e5]
    gj, gt = jingest.GnssIngest(cfg_j, iono), tingest.GnssIngest(cfg_t, iono)
    for g in (gj, gt):
        g.set_anchor(ANC)
    _close(gt.R0, gj.R0, HOST_TOL)
    _close(gt.anchor_ecef([1.0, -2.0, 0.5]), gj.anchor_ecef([1.0, -2.0, 0.5]), HOST_TOL)
    for k, ep in enumerate(_ingest_epochs()):
        aligned = k == 2
        vj = gj.process_epoch(copy.deepcopy(ep), aligned, ANC if aligned else None)
        vt = gt.process_epoch(copy.deepcopy(ep), aligned, ANC if aligned else None)
        assert [o["sat"] for o in vj] == [o["sat"] for o in vt]
        assert gj.track_count == gt.track_count
        if vj:
            for pos in (ANC, ANC + np.array([30.0, -20.0, 5.0])):
                sj, st = gj.build_slot(vj, ANC, pos), gt.build_slot(vt, ANC, pos)
                assert sorted(sj) == sorted(st)
                for key in sj:
                    _close(st[key], sj[key], HOST_TOL)
    assert [len(e) for e in gt.epochs] == [len(e) for e in gj.epochs] == [0, 7, 5]
    red_t = tingest.reduce_obs(ANC, gt.R0, _ingest_epochs()[0][0], 2.5)
    red_j = jingest.reduce_obs(ANC, gj.R0, _ingest_epochs()[0][0], 2.5)
    for key in red_j:
        _close(red_t[key], red_j[key], HOST_TOL)


def test_epoch_attachment_and_ts_ratio_match():
    """The mid-interval epoch of tests/test_gnss.py lands at its lower
    bracketing slot with ts_ratio 0.4, slot values equal, in both pumps."""
    def gnss_cfg(cls):
        cfg = cls()
        return dataclasses.replace(cfg, gnss=dataclasses.replace(cfg.gnss, enabled=True,
                                                                 track_num_thresh=1))

    je = JEstimator(gnss_cfg(JConfig), dtype=jnp.float64)
    te = TEstimator(gnss_cfg(TConfig), dtype=torch.float64, device="cpu")
    f = je.f
    sat = ANC + jcoords.ecef2rotation(ANC) @ np.array([0.4e7, 0.5e7, 2.0e7])
    obs = dict(sat=3, sys=0, sat_pos=sat, sat_vel=np.zeros(3), psr=1.0e7, dopp_wl=0.0,
               psr_std=0.1, dopp_std=0.1, svdt=0.0, svddt=0.0, tgd=0.0, ura=2.0)
    for e in (je, te):
        e.ts = [0.1 * k for k in range(f)]
        e.gnss.set_anchor(ANC)
        e.gnss_aligned = True
        e.input_gnss(0.86, [dict(obs)])
        e._attach_gnss_epoch()
    tg = te.core.gnss_obs
    assert bool(tg.valid[8, 0]) and int(tg.valid.sum()) == 1
    np.testing.assert_allclose(float(tg.ratio[8, 0]), 0.4, atol=1e-9)
    for name in tgf.GnssObsWindow._fields:
        _close(getattr(tg, name).numpy(), np.asarray(getattr(je.core.gnss_obs, name)), HOST_TOL)


# ------------------------------------------------------------- GNSS factors

F_SMALL, S_SMALL = 5, 16


def _random_gnss(seed=0, dtype=np.float64):
    """A random float64 window state with GNSS columns and a GNSS table of
    F = 5 frames by S = 16 slots (some invalid, mixed constellations,
    random weights and ratios), in both packages."""
    f, s = F_SMALL, S_SMALL
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 2.0, (f, 3))
    vel = rng.normal(0, 0.5, (f, 3))
    dt_vals = np.tile([20.0, 0.0, 0.0, 35.0], (f, 1)) + rng.normal(0, 1.0, (f, 4))
    ddt_vals = 5.0 + rng.normal(0, 0.3, f)
    yaw = 0.3
    obs = tsim_gnss.window_obs_at_truth(ANC, yaw, pos, vel, dt_vals, ddt_vals, n_sats=s)
    tbl = {k: getattr(obs, k).numpy().copy() for k in tgf.GnssObsWindow._fields}
    tbl["pr_weight"] = rng.uniform(0.5, 3.0, (f, s)) * tbl["valid"]
    tbl["dp_weight"] = rng.uniform(2.0, 15.0, (f, s)) * tbl["valid"]
    tbl["ratio"] = rng.uniform(0.0, 1.0, (f, s))
    tbl["valid"] = tbl["valid"] & (rng.uniform(size=(f, s)) > 0.25)
    tbl["sys"] = np.where(tbl["valid"], rng.integers(0, 4, (f, s)), 0)
    # state off the truth, so residuals and clock rows are non-zero
    st = dict(
        poses=np.concatenate([pos + rng.normal(0, 0.3, (f, 3)), np.tile([1.0, 0, 0, 0], (f, 1))], 1),
        sbs=np.concatenate([vel + rng.normal(0, 0.1, (f, 3)), np.zeros((f, 6))], 1),
        rcv_dt=dt_vals + rng.normal(0, 0.5, (f, 4)), rcv_ddt=ddt_vals + rng.normal(0, 0.2, f),
        yaw_enu=np.asarray(yaw + 0.01), anc_ecef=rng.normal(0, 0.5, 3))
    js = jempty_state(f, JD)._replace(**{k: jnp.asarray(v, JD) for k, v in st.items()})
    ts = tempty_state(f, TD)._replace(**{k: torch.as_tensor(v) for k, v in st.items()})
    jobs = jgf.GnssObsWindow(**{k: jnp.asarray(v.astype(np.int32) if k == "sys" else v)
                                for k, v in tbl.items()})
    tobs = tgf.GnssObsWindow(**{k: torch.as_tensor(v) for k, v in tbl.items()})
    frame_dts = np.concatenate([[0.0], rng.uniform(0.05, 0.15, f - 1)])
    return js, ts, jobs, tobs, frame_dts


@pytest.fixture(scope="module")
def gnss_case():
    return _random_gnss()


_J_LAYOUT = JLayout(F_SMALL, 8)
# one compiled program each: the gate and the filter are traced arguments
# (the port's unfiltered call is held against the JAX package's all-true filter)
_j_psr = jax.jit(lambda s, o, ready, filt: jgf.linearize_gnss_psr_dopp(
    s, o, ready, _J_LAYOUT, slot_filter=filt))
_j_clock = jax.jit(lambda s, dts, ready, w, filt: jgf.linearize_clock_chain(
    s, dts, ready, w, _J_LAYOUT, pair_filter=filt))


def _filters(which):
    if which is None:
        return jnp.ones(F_SMALL, bool), None
    return jnp.arange(F_SMALL) == which, torch.arange(F_SMALL) == which


@pytest.mark.parametrize("ready", [True, False], ids=["ready", "not_ready"])
@pytest.mark.parametrize("slot_filter", [None, 0, 2], ids=["all", "slot0", "slot2"])
def test_psr_dopp_rows_match(gnss_case, ready, slot_filter):
    js, ts, jobs, tobs, _ = gnss_case
    jf, tf = _filters(slot_filter)
    Jj, rj = _j_psr(js, jobs, jnp.asarray(ready), jf)
    Jt, rt = tgf.linearize_gnss_psr_dopp(ts, tobs, torch.tensor(ready), TLayout(F_SMALL, 8),
                                         slot_filter=tf)
    _close(Jt.numpy(), np.asarray(Jj), ROW_TOL)
    _close(rt.numpy(), np.asarray(rj), ROW_TOL)
    assert (np.abs(rt.numpy()).max() > 1.0) == ready       # the rows are live when ready
    r_only = tgf.gnss_psr_dopp_residuals(ts, tobs, torch.tensor(ready), slot_filter=tf)
    _close(r_only.numpy(), rt.numpy(), ROW_TOL)


@pytest.mark.parametrize("ready", [True, False], ids=["ready", "not_ready"])
@pytest.mark.parametrize("pair_filter", [None, 1, 3], ids=["all", "pair1", "pair3"])
def test_clock_chain_rows_match(gnss_case, ready, pair_filter):
    js, ts, _, _, frame_dts = gnss_case
    jf, tf = _filters(pair_filter)
    Jj, rj = _j_clock(js, jnp.asarray(frame_dts), jnp.asarray(ready), jnp.asarray(10.0, JD), jf)
    Jt, rt = tgf.linearize_clock_chain(ts, torch.as_tensor(frame_dts), torch.tensor(ready),
                                       torch.tensor(10.0, dtype=TD), TLayout(F_SMALL, 8),
                                       pair_filter=tf)
    _close(Jt.numpy(), np.asarray(Jj), ROW_TOL)
    _close(rt.numpy(), np.asarray(rj), ROW_TOL)
    r_only = tgf.clock_chain_residuals(ts, torch.as_tensor(frame_dts), torch.tensor(ready),
                                       torch.tensor(10.0, dtype=TD), pair_filter=tf)
    _close(r_only.numpy(), rt.numpy(), ROW_TOL)


def _gt_window(f, dtype, seed=5):
    """The ground-truth case of tests/test_gnss.py (F frames, 8 satellites)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 2.0, (f, 3))
    vel = rng.normal(0, 0.5, (f, 3))
    dt_vals = np.tile([20.0, 0.0, 0.0, 35.0], (f, 1)) + np.arange(f)[:, None] * 0.5
    ddt_vals = np.full(f, 5.0)
    st = tempty_state(f, dtype)
    st = st._replace(
        poses=torch.cat([torch.as_tensor(pos, dtype=dtype), st.poses[:, 3:]], 1),
        sbs=torch.cat([torch.as_tensor(vel, dtype=dtype), st.sbs[:, 3:]], 1),
        rcv_dt=torch.as_tensor(dt_vals, dtype=dtype), rcv_ddt=torch.as_tensor(ddt_vals, dtype=dtype),
        yaw_enu=torch.tensor(0.3, dtype=dtype))
    return st, (pos, vel, dt_vals, ddt_vals)


def test_window_obs_generator_matches_the_jax_tests():
    """``sim.gnss.window_obs_at_truth`` is the generator of tests/test_gnss.py."""
    cfg = JConfig()
    f = cfg.num_frames
    _, (pos, vel, dt_vals, ddt_vals) = _gt_window(f, TD)
    want = _window_gnss_obs(cfg, ANC, 0.3, np.concatenate([pos, np.zeros((f, 4))], 1), vel,
                            dt_vals, ddt_vals)
    got = tsim_gnss.window_obs_at_truth(ANC, 0.3, pos, vel, dt_vals, ddt_vals)
    for name in tgf.GnssObsWindow._fields:
        _close(getattr(got, name).numpy(), np.asarray(getattr(want, name)), HOST_TOL)


def test_psr_dopp_float32_at_ground_truth_below_5mm():
    """The reduced-observable form is float32-viable in the port: at ground
    truth the float32 rows stay below 5 mm (tests/test_gnss.py's case), and
    the float64 rows vanish; the clock chain is zero on the ramp."""
    cfg = TConfig()
    f = cfg.num_frames
    layout = TLayout(f, cfg.solver.max_landmarks)
    for dtype, tol in ((torch.float32, 5e-3), (torch.float64, 1e-5)):
        st, (pos, vel, dt_vals, ddt_vals) = _gt_window(f, dtype)
        obs = tsim_gnss.window_obs_at_truth(ANC, 0.3, pos, vel, dt_vals, ddt_vals, dtype=dtype)
        _, r = tgf.linearize_gnss_psr_dopp(st, obs, torch.tensor(True), layout)
        assert r.dtype == dtype and float(r.abs().max()) < tol, float(r.abs().max())
        _, r2 = tgf.linearize_gnss_psr_dopp(st._replace(yaw_enu=st.yaw_enu + 0.01), obs,
                                            torch.tensor(True), layout)
        assert float(r2.abs().max()) > 1e-2                  # yaw is observable
    st, _ = _gt_window(f, torch.float64)
    _, rc = tgf.linearize_clock_chain(st, torch.full((f,), 0.1, dtype=TD), torch.tensor(True),
                                      torch.tensor(10.0, dtype=TD), layout)
    assert float(rc.abs().max()) < 1e-8


# ------------------------------------------------------------ anchor factors


def _rand_pose(rng):
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    return np.concatenate([rng.standard_normal(3), q])


@pytest.mark.parametrize("name", ["pose_anchor", "initial_pose", "initial_bias", "pos_vel",
                                  "motion", "dt_anchor", "huber_weight"])
def test_anchor_factors_match(name):
    rng = np.random.default_rng(["pose_anchor", "initial_pose", "initial_bias", "pos_vel",
                                 "motion", "dt_anchor", "huber_weight"].index(name))
    p1, p2 = _rand_pose(rng), _rand_pose(rng)
    s1, s2 = rng.standard_normal(9), rng.standard_normal(9)
    b1, b2 = rng.standard_normal(3), rng.standard_normal(3)
    args = {"pose_anchor": (p1, p2), "initial_pose": (p1, p2), "initial_bias": (s1, b1, b2),
            "pos_vel": (p1, p2, s1, s2, 0.37), "motion": (p1, p2, s1)}
    if name == "dt_anchor":
        got, want = tgf.dt_anchor_factor(torch.tensor(0.002, dtype=TD)), \
            jgf.dt_anchor_factor(jnp.asarray(0.002, JD))
    elif name == "huber_weight":
        sq = np.concatenate([rng.uniform(0, 4, 20), [0.0, 1.0]])
        got = (tfac.huber_weight(_t(sq), 1.0),)
        want = (jfac.huber_weight(jnp.asarray(sq), 1.0),)
    else:
        a = args[name]
        got = getattr(tfac, f"{name}_factor")(*[_t(x) if not isinstance(x, float) else x for x in a])
        want = getattr(jfac, f"{name}_factor")(*[jnp.asarray(x) if not isinstance(x, float) else x
                                                 for x in a])
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), HOST_TOL)


def test_linearize_pose_anchor_gating_matches():
    cfg = TConfig()
    lt, lj = TLayout(cfg.num_frames, cfg.solver.max_landmarks), \
        JLayout(cfg.num_frames, cfg.solver.max_landmarks)
    anchor = [0.1, -0.2, 0.05, 1.0, 0.0, 0.0, 0.0]
    for active in (True, False):
        Jt, rt = tasm.linearize_pose_anchor(tempty_state(cfg.num_frames, TD), _t(anchor),
                                            torch.tensor(active), lt)
        Jj, rj = jasm.linearize_pose_anchor(jempty_state(cfg.num_frames, JD), jnp.asarray(anchor),
                                            jnp.asarray(active), lj)
        _close(Jt.numpy(), np.asarray(Jj), HOST_TOL)
        _close(rt.numpy(), np.asarray(rj), HOST_TOL)
        assert (np.abs(Jt.numpy()[:, :6]).max() > 0) == active
        assert np.abs(Jt.numpy()[:, 6:]).max() == 0.0


# -------------------------------------------------------- marginalization


def _window_problem(f=5, ml=96, seed=1):
    """One synthetic window at F = ``f`` with ``ml`` landmark slots from the
    port's simulator (poses and velocities perturbed from the truth, exact
    IMU/wheel samples, projected landmarks with their depths), a GNSS table
    seen from near the truth, and GNSS clock columns — in both packages, the
    same values, through ``utils/convert.py``. The preintegrations are the
    port's, handed to both sides as inputs."""
    from ground_fusion_tpu.estimator.window import Tracks as JTracks
    from ground_fusion_tpu.preintegration.imu import ImuPreint as JImuPreint
    from ground_fusion_tpu.preintegration.wheel import WheelPreint as JWheelPreint
    from ground_fusion_tpu_torch.estimator import buffers as tbuf
    from ground_fusion_tpu_torch.estimator.window import Tracks as TTracks
    from ground_fusion_tpu_torch.preintegration.imu import noise_cov
    from ground_fusion_tpu_torch.preintegration.wheel import wheel_noise_cov
    from ground_fusion_tpu_torch.sim import synthetic as ts_

    cfg = dataclasses.replace(TConfig(), gnss=dataclasses.replace(TConfig().gnss, enabled=True))
    sp = ts_.SimParams()
    rng = np.random.default_rng(seed)
    t = np.arange(f) / sp.frame_rate
    gt = torch.stack([ts_.gt_pose7(x, sp) for x in t]).numpy()
    vel = torch.stack([ts_.gt_velocity(x, sp) for x in t]).numpy()
    ex = ts_.body_T_cam().numpy()
    poses = gt.copy()
    poses[:, 0:3] += rng.normal(0, 0.02, (f, 3))
    sbs = np.concatenate([vel + rng.normal(0, 0.02, (f, 3)), np.tile(sp.ba, (f, 1)),
                          np.tile(sp.bg, (f, 1))], 1)
    dt_vals = np.tile([20.0, 0.0, 0.0, 35.0], (f, 1)) + rng.normal(0, 0.5, (f, 4))
    ddt_vals = 5.0 + rng.normal(0, 0.2, f)
    state = dict(poses=poses, sbs=sbs, ex_cam=ex, rcv_dt=dt_vals, rcv_ddt=ddt_vals,
                 yaw_enu=np.asarray(0.2), anc_ecef=np.array([0.1, -0.2, 0.05]))
    tstate = tempty_state(f, TD)._replace(**{k: torch.as_tensor(v) for k, v in state.items()})

    pts_w = torch.as_tensor(ts_.make_landmarks(ml, sp, seed=1))
    uv, z, vis = (torch.stack(x, 1).numpy() for x in zip(
        *[ts_.project_landmarks(torch.as_tensor(p), torch.as_tensor(ex), pts_w) for p in gt]))
    uv = uv + rng.normal(0, 1e-3, uv.shape)
    active = vis.sum(1) >= 4
    start = np.argmax(vis, axis=1)
    tracks = dict(inv_depth=1.0 / np.maximum(z[np.arange(ml), start], 1e-3), active=active,
                  solve_ok=active, depth_fixed=np.zeros(ml, bool), start_frame=start,
                  obs=np.concatenate([uv, np.zeros((ml, f, 2)), z[..., None]], -1) * vis[..., None],
                  obs_valid=vis)

    def interval_buf(rate, cap, sample, names, extra=()):
        bufs = {n: [] for n in names}
        for k in range(f):
            s = np.arange(t[k - 1] + 1.0 / rate, t[k] + 1e-9, 1.0 / rate) if k else np.zeros(0)
            x0, w0 = (v.numpy() for v in sample(torch.as_tensor([t[max(k - 1, 0)]]), sp))
            xs, ws = (v.numpy() for v in sample(torch.as_tensor(s), sp)) if len(s) else \
                (np.zeros((0, 3)), np.zeros((0, 3)))
            pad = cap - len(s)
            bufs[names[0]].append(np.pad(np.diff(s, prepend=t[max(k - 1, 0)]), (0, pad)))
            bufs[names[1]].append(np.pad(xs, ((0, pad), (0, 0))))
            bufs[names[2]].append(np.pad(ws, ((0, pad), (0, 0))))
            bufs[names[3]].append(np.arange(cap) < len(s))
            bufs[names[4]].append(x0[0])
            bufs[names[5]].append(w0[0])
        return {n: np.stack(v) for n, v in bufs.items()} | dict(extra)

    imu = interval_buf(sp.imu_rate, cfg.solver.max_imu_per_interval, ts_.imu_samples,
                       ("dts", "acc", "gyr", "valid", "acc0", "gyr0"))
    wheel = interval_buf(sp.wheel_rate, cfg.solver.max_wheel_per_interval, ts_.wheel_samples,
                         ("dts", "vel", "gyr", "valid", "vel0", "gyr0"), [("bad", np.zeros(f, bool))])
    c = cfg
    timu_pre = tbuf.preintegrate_imu_window(
        convert.imu_buffer_from_numpy(imu, "cpu", TD), tstate.sbs,
        noise_cov(c.imu.acc_n, c.imu.gyr_n, c.imu.acc_w, c.imu.gyr_w, dtype=TD))
    twheel_pre = tbuf.preintegrate_wheel_window(
        convert.wheel_buffer_from_numpy(wheel, "cpu", TD), tstate.s_wheel, tstate.td_wheel,
        wheel_noise_cov(c.wheel.vel_n, c.wheel.gyr_n, dtype=TD))

    tobs = tsim_gnss.window_obs_at_truth(ANC, 0.2, gt[:, 0:3] + rng.normal(0, 0.2, (f, 3)), vel,
                                         dt_vals, ddt_vals, n_sats=8)
    tobs = tobs._replace(ratio=torch.as_tensor(rng.uniform(0.2, 1.0, tobs.ratio.shape)))
    tlayout = TLayout(f, ml)
    from ground_fusion_tpu_torch.estimator.step import base_free_mask

    free = base_free_mask(dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, window_size=f - 1, max_landmarks=ml)), tlayout)
    valid = np.arange(f) >= 1
    frame_dts = np.diff(t, prepend=t[0])
    g = np.array([0.0, 0.0, sp.g_norm])
    tinp = tasm.SolveInputs(
        imu_pre=timu_pre, imu_valid=torch.as_tensor(valid), wheel_pre=twheel_pre,
        wheel_valid=torch.as_tensor(valid), plane_valid=torch.ones(f, dtype=torch.bool),
        td_obs=torch.zeros(f, dtype=TD), prior=tasm.empty_prior(tlayout, f, TD),
        g=torch.as_tensor(g), free_mask=torch.as_tensor(free), gnss_obs=tobs,
        gnss_ready=torch.tensor(True), frame_dts=torch.as_tensor(frame_dts),
        ddt_weight=torch.tensor(10.0, dtype=TD))
    jlayout = JLayout(f, ml)
    jinp = jasm.SolveInputs(
        imu_pre=JImuPreint(**{k: jnp.asarray(v) for k, v in convert.to_numpy(timu_pre).items()}),
        imu_valid=jnp.asarray(valid),
        wheel_pre=JWheelPreint(**{k: jnp.asarray(v) for k, v in convert.to_numpy(twheel_pre).items()}),
        wheel_valid=jnp.asarray(valid), plane_valid=jnp.ones(f, bool), td_obs=jnp.zeros(f, JD),
        prior=jasm.empty_prior(jlayout, f, JD), g=jnp.asarray(g), free_mask=jnp.asarray(free),
        gnss_obs=jgf.GnssObsWindow(**{k: jnp.asarray(v.numpy().astype(np.int32) if k == "sys"
                                                     else v.numpy())
                                      for k, v in tobs._asdict().items()}),
        gnss_ready=jnp.asarray(True), frame_dts=jnp.asarray(frame_dts),
        ddt_weight=jnp.asarray(10.0, JD))
    jstate = jempty_state(f, JD)._replace(**{k: jnp.asarray(v, JD) for k, v in state.items()})
    jtracks = JTracks(**{k: jnp.asarray(v.astype(np.int32) if k == "start_frame" else v)
                         for k, v in tracks.items()})
    ttracks = convert.tracks_from_numpy(tracks, "cpu", TD)
    assert isinstance(ttracks, TTracks) and int(active.sum()) >= 4
    return (jstate, jtracks, jinp, jlayout), (tstate, ttracks, tinp, tlayout)


def test_marginalize_old_with_gnss_rows_matches():
    """marginalize_old on a window with a GNSS table, the clock chain and the
    GNSS columns free: prior quadratic form within 1e-8 of its scale, in both
    packages; and the port's residual probe equals its rows' residuals."""
    (jstate, jtracks, jinp, jlayout), (tstate, ttracks, tinp, tlayout) = _window_problem()
    scale, plane = 460.0 / 1.5, [100.0, 100.0, 20.0]
    jprior = jax.jit(lambda s, t, i: jmarg.marginalize_old(
        s, t, i, jlayout, jnp.asarray(scale, JD), jnp.asarray(1.0, JD), jnp.asarray(plane, JD)))(
        jstate, jtracks, jinp)
    targs = (torch.tensor(scale, dtype=TD), torch.tensor(1.0, dtype=TD), _t(plane))
    tprior = tmarg.marginalize_old(tstate, ttracks, tinp, tlayout, *targs)
    Hj = np.asarray(jprior.J0).T @ np.asarray(jprior.J0)
    bj = np.asarray(jprior.J0).T @ np.asarray(jprior.r0)
    Ht = (tprior.J0.T @ tprior.J0).numpy()
    bt = (tprior.J0.T @ tprior.r0).numpy()
    # the GNSS rows reached the prior: its clock and anchor columns are live
    assert np.abs(Ht[tlayout.gnss_dt : tlayout.nx, tlayout.gnss_dt : tlayout.nx]).max() > 1.0
    assert np.abs(Hj - Ht).max() <= 1e-8 * np.abs(Hj).max()
    assert np.abs(bj - bt).max() <= 1e-8 * max(1.0, np.abs(bj).max())
    assert np.abs(np.asarray(jprior.lin.rcv_dt) - tprior.lin.rcv_dt.numpy()).max() <= 1e-12

    _, rt = tasm.assemble_rows(tstate, ttracks, tinp, tlayout, *targs)
    _close(tasm.assemble_residuals(tstate, ttracks, tinp, tlayout, *targs).numpy(), rt.numpy(),
           1e-12)


# ----------------------------------------------------------- global fusion


def _drive_global_fusion(gf, ypr_to_mat, mat_to_quat):
    """The case of tests/test_global_layers.py: a straight path east whose
    VIO drifts in yaw, GPS every second step at 10 cm."""
    n = 40
    for k in range(n):
        yaw_d = 0.004 * k
        Rk = ypr_to_mat(np.array([yaw_d, 0.0, 0.0]))
        if k == 0:
            p = np.zeros(3)
        else:
            p = gf.vio_poses[-1][0:3] + np.array([np.cos(yaw_d), np.sin(yaw_d), 0.0])
        gf.input_odom(float(k), np.concatenate([p, mat_to_quat(Rk)]))
        if k % 2 == 0:
            lon = 121.4 + np.rad2deg(float(k) / (6378137.0 * np.cos(np.deg2rad(31.0))))
            gf.input_gps(float(k), 31.0, lon, 10.0, 0.1)
    gf.optimize(iters=8)
    return gf


def test_global_fusion_matches(tmp_path):
    from ground_fusion_tpu.geometry.so3 import mat_to_quat as jm2q, ypr_to_mat as jypr
    from ground_fusion_tpu_torch.geometry.so3 import mat_to_quat as tm2q, ypr_to_mat as typr

    gj = _drive_global_fusion(JGlobalFusion(), lambda y: np.asarray(jypr(jnp.asarray(y))),
                              lambda R: np.asarray(jm2q(jnp.asarray(R))))
    gt = _drive_global_fusion(TGlobalFusion(device="cpu"), lambda y: typr(_t(y)).numpy(),
                              lambda R: tm2q(_t(R)).numpy())
    _close(np.stack(gt.vio_poses), np.stack(gj.vio_poses), HOST_TOL)
    _close(np.stack(gt.global_poses), np.stack(gj.global_poses), 1e-8)
    _close(gt.wgps_T_wvio, gj.wgps_T_wvio, 1e-8)
    err = np.linalg.norm(gt.global_poses[-1][0:3] - np.array([39.0, 0.0, 0.0]))
    assert err < 0.35
    gt.write_tum(str(tmp_path / "t.txt"))
    gj.write_tum(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_alignment_clears_the_priors_hold_on_the_gnss_columns():
    """Before GNSS-VI alignment no factor touches the GNSS columns, so the
    prior's only hold on them is its factorization's ridge (about 1e3 in
    float32); alignment clears those columns, so the ridge cannot drag the
    installed clocks, yaw and anchor back to zero. The other columns keep
    their information."""
    cfg = TConfig()
    cfg = dataclasses.replace(cfg, gnss=dataclasses.replace(cfg.gnss, enabled=True))
    te = TEstimator(cfg, dtype=torch.float32, device="cpu")
    f, lay = te.f, te.layout
    pos, vel, epochs = _align_epochs(n_ep=f)
    te.gnss.epochs = epochs
    te.ts = [0.1 * k for k in range(f)]
    kw = dict(dtype=torch.float32)
    te.core = te.core._replace(
        state=te.core.state._replace(
            poses=torch.cat([torch.as_tensor(pos, **kw), te.core.state.poses[:, 3:]], 1),
            sbs=torch.cat([torch.as_tensor(vel, **kw), te.core.state.sbs[:, 3:]], 1)),
        prior=te.core.prior._replace(J0=30.0 * torch.eye(lay.nx, **kw),
                                     valid=torch.tensor(True)))
    te._try_gnss_align()
    assert te.gnss_aligned and te.gnss_aligned_at == te.ts[-1]
    J0 = te.core.prior.J0
    assert float(J0[:, lay.gnss_dt :].abs().max()) == 0.0
    assert torch.equal(J0[:, : lay.gnss_dt], 30.0 * torch.eye(lay.nx, **kw)[:, : lay.gnss_dt])
    # the installed values are the alignment's (from the window in float32)
    anc, yaw, dt, ok = talign.gnss_vi_align(pos, vel, epochs, min_speed=cfg.gnss.low_speed_yaw_fix)
    assert ok and abs(float(te.core.state.yaw_enu) - yaw) < 1e-5
    assert np.abs(te.core.state.rcv_dt.numpy() - dt[None, :]).max() < 1e-3
    assert np.abs(te.gnss.anc0 - anc).max() < 1e-3
    assert float(te.core.state.anc_ecef.abs().max()) == 0.0


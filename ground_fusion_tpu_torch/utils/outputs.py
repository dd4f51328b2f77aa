"""Output surfaces beyond TUM trajectories: calibration iterate dumps,
per-sensor dead-reckoning paths, statistics printing.

The reference's output inventory (SURVEY §2 #22, §5 observability):
extrinsic/td/intrinsic CSV dumps (``parameters.cpp:167-283``), ~30 live
topics including the pure IMU / pure wheel dead-reckoning diagnostic paths
(``visualization.cpp:58-68``), printStatistics per frame."""

from __future__ import annotations

import os

import numpy as np


class CalibrationDump:
    """Appends one row per solve of the online-calibrated quantities
    (EX_CALIB_RESULT_PATH / td CSV analogs)."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.paths = {
            "ex_cam": os.path.join(out_dir, "extrinsic_cam.csv"),
            "ex_wheel": os.path.join(out_dir, "extrinsic_wheel.csv"),
            "intrinsic_wheel": os.path.join(out_dir, "intrinsic_wheel.csv"),
            "td": os.path.join(out_dir, "td.csv"),
        }
        for p in self.paths.values():
            open(p, "w").close()

    def append(self, t: float, state) -> np.ndarray:
        """Append one row per file; returns the fetched wheel intrinsics
        ``(sx, sy, sw)`` so the caller needs no second fetch for them."""
        return self.append_rows([t], state)

    def append_rows(self, ts, state) -> np.ndarray:
        """Append one row per file for each time in ``ts``, all from the one
        ``state`` (a burst's frames drain against the post-chunk state), with
        one fetch; returns the wheel intrinsics as :meth:`append` does."""
        import torch

        # one packed device→host fetch instead of five small ones
        packed = torch.cat([state.ex_cam, state.ex_wheel, state.s_wheel,
                            state.td[None], state.td_wheel[None]]).cpu().numpy()
        ex, exw, s = packed[0:7], packed[7:14], packed[14:17]
        td, td_wheel = float(packed[17]), float(packed[18])
        rows = {"ex_cam": [], "ex_wheel": [], "intrinsic_wheel": [], "td": []}
        for t in ts:
            rows["ex_cam"].append(f"{t:.6f}," + ",".join(f"{v:.6f}" for v in ex) + "\n")
            rows["ex_wheel"].append(f"{t:.6f}," + ",".join(f"{v:.6f}" for v in exw) + "\n")
            rows["intrinsic_wheel"].append(f"{t:.6f},{s[0]:.6f},{s[1]:.6f},{s[2]:.6f}\n")
            rows["td"].append(f"{t:.6f},{td:.6f},{td_wheel:.6f}\n")
        for name, lines in rows.items():
            with open(self.paths[name], "a") as f:
                f.write("".join(lines))
        return s


class DeadReckoningPaths:
    """Pure-IMU and pure-wheel propagation tracks for debugging
    (``pure_imu_propagate`` / ``pure_wheel_propagate`` topics,
    fastPredictPureIMU / fastPredictWheel, estimator.cpp:4032-4093).

    Fed at SENSOR rate via :meth:`push_imu` / :meth:`push_wheel` (the
    ``inputIMU``/``inputWheel`` hook, visualization.cpp:58-68) — all math is
    host numpy (:mod:`.np_quat`), zero device dispatches per sample."""

    def __init__(self):
        self.imu_path: list[tuple[float, np.ndarray]] = []
        self.wheel_path: list[tuple[float, np.ndarray]] = []
        self._imu_state = None   # (p, q, v)
        self._wheel_state = None  # (p, q)
        self._imu_prev = None    # (t, acc, gyr)
        self._wheel_prev = None  # (t, vel, gyr)

    # ------------------------------------------------------ sensor-rate feed

    def push_imu(self, t, acc, gyr, ba=None, bg=None, g_norm=9.81,
                 seed_pose=None):
        """One raw IMU sample; midpoint-integrates from the previous one.
        ``seed_pose`` ([7] or (p,q,v)) initializes the track at the current
        odometry like the reference's first-sample latch
        (estimator.cpp:4042-4052)."""
        if self._imu_prev is None:
            if seed_pose is not None and self._imu_state is None:
                p0, q0, v0 = seed_pose
                self._imu_state = (np.asarray(p0, float).copy(),
                                   np.asarray(q0, float).copy(),
                                   np.asarray(v0, float).copy())
            self._imu_prev = (t, np.asarray(acc, float), np.asarray(gyr, float))
            return
        t0, acc0, gyr0 = self._imu_prev
        dt = t - t0
        self._imu_prev = (t, np.asarray(acc, float), np.asarray(gyr, float))
        if dt <= 0 or dt > 1.0:
            return
        self.propagate_imu(t, dt, acc0, gyr0, np.asarray(acc, float),
                           np.asarray(gyr, float),
                           np.zeros(3) if ba is None else np.asarray(ba, float),
                           np.zeros(3) if bg is None else np.asarray(bg, float),
                           g_norm)

    def push_wheel(self, t, vel, gyr, scales=(1.0, 1.0, 1.0)):
        """One raw wheel sample (body-frame velocity + gyro); ``scales`` =
        (sx, sy, sw) wheel intrinsics (fastPredictWheel,
        estimator.cpp:4079-4093)."""
        if self._wheel_prev is None:
            self._wheel_prev = (t, np.asarray(vel, float), np.asarray(gyr, float))
            return
        t0, vel0, gyr0 = self._wheel_prev
        dt = t - t0
        self._wheel_prev = (t, np.asarray(vel, float), np.asarray(gyr, float))
        if dt <= 0 or dt > 1.0:
            return
        self.propagate_wheel(t, dt, np.asarray(vel, float),
                             np.asarray(gyr, float), vel0, gyr0, scales)

    # ----------------------------------------------------------- integrators

    def propagate_imu(self, t, dt, acc0, gyr0, acc1, gyr1, ba, bg, g_norm):
        from .np_quat import quat_mul, quat_normalize, quat_to_mat

        if self._imu_state is None:
            self._imu_state = (np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3))
        p, q, v = self._imu_state
        g = np.array([0.0, 0.0, g_norm])
        un_acc0 = quat_to_mat(q) @ (acc0 - ba) - g
        un_gyr = 0.5 * (gyr0 + gyr1) - bg
        q = quat_normalize(quat_mul(q, np.concatenate([[1.0], 0.5 * un_gyr * dt])))
        un_acc1 = quat_to_mat(q) @ (acc1 - ba) - g
        un_acc = 0.5 * (un_acc0 + un_acc1)
        p = p + v * dt + 0.5 * un_acc * dt * dt
        v = v + un_acc * dt
        self._imu_state = (p, q, v)
        self.imu_path.append((t, np.concatenate([p, q])))

    def propagate_wheel(self, t, dt, vel, gyr, vel0=None, gyr0=None,
                        scales=(1.0, 1.0, 1.0)):
        """Midpoint wheel propagation with intrinsic scales (sx, sy, sw)
        (fastPredictWheel: un_gyr = ½·sw·(gyr0+gyr1); each BODY-frame
        velocity is diag(sx,sy,1)-scaled first, then rotated — R·(sv·v),
        estimator.cpp:4079-4093)."""
        from .np_quat import quat_mul, quat_normalize, quat_to_mat

        if self._wheel_state is None:
            self._wheel_state = (np.zeros(3), np.array([1.0, 0, 0, 0]))
        p, q = self._wheel_state
        sx, sy, sw = scales
        if vel0 is None:
            vel0 = vel
        if gyr0 is None:
            gyr0 = gyr
        sv = np.diag([sx, sy, 1.0])
        un_vel0 = quat_to_mat(q) @ (sv @ vel0)
        un_gyr = 0.5 * sw * (gyr0 + gyr)
        q = quat_normalize(quat_mul(q, np.concatenate([[1.0], 0.5 * un_gyr * dt])))
        v_mid = 0.5 * (quat_to_mat(q) @ (sv @ vel) + un_vel0)
        p = p + v_mid * dt
        self._wheel_state = (p, q)
        self.wheel_path.append((t, np.concatenate([p, q])))

    def write_tum(self, imu_path: str, wheel_path: str):
        for path, track in ((imu_path, self.imu_path), (wheel_path, self.wheel_path)):
            with open(path, "w") as fp:
                for t, p in track:
                    fp.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                             f"{p[4]:.6f} {p[5]:.6f} {p[6]:.6f} {p[3]:.6f}\n")


def print_statistics(t: float, state, cost: float, stats=None) -> str:
    """printStatistics equivalent (estimator.cpp:675 path)."""
    p = np.asarray(state.poses[-1, 0:3])
    v = np.asarray(state.sbs[-1, 0:3])
    ba = np.linalg.norm(np.asarray(state.sbs[-1, 3:6]))
    bg = np.linalg.norm(np.asarray(state.sbs[-1, 6:9]))
    line = (f"t={t:.2f} p=[{p[0]:.3f},{p[1]:.3f},{p[2]:.3f}] "
            f"|v|={np.linalg.norm(v):.2f} |ba|={ba:.3f} |bg|={bg:.4f} "
            f"cost={cost:.3f}")
    if stats is not None:
        line += f" solve_ms={stats.mean('solve'):.1f}"
    return line

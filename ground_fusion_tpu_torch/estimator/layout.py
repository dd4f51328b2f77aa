"""Static column layout of the sliding-window error state.

The reference packs Ceres parameter blocks per frame (``estimator.cpp
vector2double :2276-2353``); we lay the *error state* (tangent space) out as
one flat vector so the whole normal-equation system is a single dense matrix:

``[pose_0(6) sb_0(9) | pose_1(6) sb_1(9) | ... | EX_cam(6) td(1) EX_wheel(6)
  s_xyw(3) td_wheel(1) plane(4) | depth_0 ... depth_{ML-1}]``

Everything is computed from the static config. ``NX`` is the "camera block" (everything that is NOT a landmark depth);
landmarks live in the trailing ``ML`` columns and are Schur-eliminated or
solved jointly (they are 1-dim blocks either way).
"""

from __future__ import annotations

from dataclasses import dataclass


PER_FRAME = 15  # 6 pose + 9 speed-bias


@dataclass(frozen=True)
class StateLayout:
    num_frames: int        # window_size + 1
    max_landmarks: int
    max_lines: int = 0     # 4-dim orthonormal line blocks after the depths

    @property
    def ex_cam(self) -> int:
        return PER_FRAME * self.num_frames

    @property
    def td(self) -> int:
        return self.ex_cam + 6

    @property
    def ex_wheel(self) -> int:
        return self.td + 1

    @property
    def s_wheel(self) -> int:       # sx, sy, sw
        return self.ex_wheel + 6

    @property
    def td_wheel(self) -> int:
        return self.s_wheel + 3

    @property
    def plane(self) -> int:         # q_pw tangent (3) + z_pw (1)
        return self.td_wheel + 1

    @property
    def gnss_dt(self) -> int:       # receiver clock bias, 4 constellations × F
        return self.plane + 4

    @property
    def gnss_ddt(self) -> int:      # receiver clock drift × F
        return self.gnss_dt + 4 * self.num_frames

    @property
    def yaw_enu(self) -> int:       # ENU-local yaw offset (para_yaw_enu_local)
        return self.gnss_ddt + self.num_frames

    @property
    def anc_ecef(self) -> int:      # ECEF anchor (para_anc_ecef)
        return self.yaw_enu + 1

    @property
    def nx(self) -> int:
        """Camera-block size (columns before the landmark tail)."""
        return self.anc_ecef + 3

    def dt_col(self, k: int, sys: int) -> int:
        return self.gnss_dt + 4 * k + sys

    def ddt_col(self, k: int) -> int:
        return self.gnss_ddt + k

    @property
    def depth0(self) -> int:
        return self.nx

    @property
    def line0(self) -> int:
        """First line column (4 per line, after the landmark depths)."""
        return self.nx + self.max_landmarks

    @property
    def total(self) -> int:
        return self.nx + self.max_landmarks + 4 * self.max_lines

    def pose(self, k: int) -> int:
        return PER_FRAME * k

    def sb(self, k: int) -> int:
        return PER_FRAME * k + 6

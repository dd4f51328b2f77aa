"""File-driven dataset loading + replay harness.

The reference's benchmark harness is rosbag replay (``README.md:146-186``)
plus the file-driven KITTI runners (``src/KITTIOdomTest.cpp``,
``KITTIGPSTest.cpp`` — SURVEY §2 #26). Here sequences live in a plain
directory layout any bag can be converted to offline (see
``scripts/convert_bag.py``):

    seq/
      imu.csv     t, ax, ay, az, gx, gy, gz
      wheel.csv   t, vx, vy, vz, wx, wy, wz
      frames.csv  t, image_path[, depth_path[, right_image_path]]
      gnss.csv    (optional) t, sat, sys, psr, dopp_wl, psr_std, dopp_std,
                  sat_x, sat_y, sat_z, vel_x, vel_y, vel_z, svdt, svddt, tgd
                  [, ura, tow]   (trailing columns optional)
      iono.csv    (optional) 8 Klobuchar broadcast parameters, one line
      gt.csv      (optional) TUM format ground truth

Images are .npy or .png (loaded with matplotlib-free PNG reader for
grayscale; .npy preferred for speed).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np


def _read_png_gray(path: str) -> np.ndarray:
    """Minimal grayscale/RGB PNG reader (no OpenCV in this runtime)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bitdepth = ctype = None
    while pos < len(data):
        ln = struct.unpack(">I", data[pos : pos + 4])[0]
        typ = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + ln]
        if typ == b"IHDR":
            w, h, bitdepth, ctype = struct.unpack(">IIBB", chunk[:10])
        elif typ == b"IDAT":
            idat += chunk
        elif typ == b"IEND":
            break
        pos += 12 + ln
    raw = zlib.decompress(idat)
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = nch * (bitdepth // 8)
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for row in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if filt == 1:    # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif filt == 2:  # Up
            line = (line + prev) & 0xFF
        elif filt == 3:  # Average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((int(a) + int(prev[i])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pr) & 0xFF
        out[row] = line
        prev = line
    img = out.reshape(h, w, nch) if nch > 1 else out.reshape(h, w)
    if nch >= 3:
        img = img[..., :3].mean(-1)
    return img.astype(np.float32)


def load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".png"):
        return _read_png_gray(path)
    raise ValueError(f"unsupported image format: {path}")


def load_mask(path: str) -> np.ndarray:
    """Load a lens/ROI mask as uint8 (0 = cull zone). Accepts .npy, .png,
    or binary .pgm (the format the offline grid tool writes; the
    reference ships its fisheye mask as an image file, parameters.cpp:98)."""
    if path.endswith(".pgm"):
        with open(path, "rb") as fp:
            assert fp.readline().strip() == b"P5", "not a binary PGM"
            dims = fp.readline().split()
            while dims and dims[0].startswith(b"#"):
                dims = fp.readline().split()
            w, h = int(dims[0]), int(dims[1])
            fp.readline()
            return np.frombuffer(fp.read(w * h), np.uint8).reshape(h, w)
    return np.asarray(load_image(path)).astype(np.uint8)


@dataclass
class Sequence:
    root: str
    imu: np.ndarray                 # [N,7]
    wheel: Optional[np.ndarray]     # [M,7]
    frames: list[tuple[float, str, Optional[str]]]   # (t, img, depth[, right])
    gnss: Optional[np.ndarray]
    gt: Optional[np.ndarray]        # TUM [K,8]
    gps: Optional[np.ndarray] = None  # [K,5] t, lat, lon, alt, acc (NavSatFix)
    iono: Optional[np.ndarray] = None  # [8] Klobuchar broadcast parameters

    @staticmethod
    def load(root: str) -> "Sequence":
        def maybe(name):
            p = os.path.join(root, name)
            return np.loadtxt(p, delimiter=",", ndmin=2) if os.path.exists(p) else None

        imu = maybe("imu.csv")
        assert imu is not None, f"{root}/imu.csv required"
        frames = []
        with open(os.path.join(root, "frames.csv")) as f:
            for line in f:
                parts = [p.strip() for p in line.strip().split(",")]
                if not parts or not parts[0]:
                    continue
                t = float(parts[0])
                img = os.path.join(root, parts[1])
                dep = os.path.join(root, parts[2]) if len(parts) > 2 and parts[2] else None
                if len(parts) > 3 and parts[3]:
                    frames.append((t, img, dep, os.path.join(root, parts[3])))
                else:
                    frames.append((t, img, dep))
        gt_p = os.path.join(root, "gt.csv")
        gt = np.loadtxt(gt_p) if os.path.exists(gt_p) else None
        iono = maybe("iono.csv")
        return Sequence(root, imu, maybe("wheel.csv"), frames, maybe("gnss.csv"),
                        gt, gps=maybe("gps.csv"),
                        iono=iono.reshape(-1) if iono is not None else None)


def replay(seq: Sequence, estimator, tracker=None, max_frames: Optional[int] = None):
    """Feed a sequence through the estimator in time order — the KITTI-runner
    / rosbag-replay analog. ``tracker`` (frontend.tracker.FeatureTracker)
    converts images to feature maps; without one, ``frames.csv`` rows must
    point at precomputed feature .npz files."""
    imu_i = 0
    wheel_i = 0
    n = len(seq.frames) if max_frames is None else min(max_frames, len(seq.frames))
    for k in range(n):
        t, img_path, dep_path = seq.frames[k][0:3]
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= t:
            row = seq.imu[imu_i]
            estimator.input_imu(row[0], row[1:4], row[4:7])
            imu_i += 1
        if seq.wheel is not None:
            while wheel_i < len(seq.wheel) and seq.wheel[wheel_i, 0] <= t:
                row = seq.wheel[wheel_i]
                estimator.input_wheel(row[0], row[1:4], row[4:7])
                wheel_i += 1
        if tracker is not None:
            img = load_image(img_path)
            depth = load_image(dep_path) if dep_path else None
            feats = tracker.track(t, img, depth)
        else:
            data = np.load(img_path)
            from ..pipeline import FrameFeature

            feats = {
                int(i): FrameFeature(*data["feats"][j])
                for j, i in enumerate(data["ids"])
            }
        estimator.input_frame(t, feats)
    return estimator

"""Detector training data: synthetic rendered scenes.

The training domain of the shipped weights (``detector/weights.npz``) is
synthetic: low-frequency textured backgrounds with high-contrast "dynamic
objects" (the rendered stand-in for people/vehicles), which is exactly the
signal the culling path needs — boxes over image regions that look like
compact foreground objects. This module holds the scene renderer (NumPy),
which the tests and the smoke script use to hold the detector to its recall.
"""

from __future__ import annotations

import numpy as np

MAX_OBJ = 3


def render_scene(rng: np.random.Generator, h: int = 96, w: int = 96):
    """One synthetic frame: smooth background + up to MAX_OBJ textured
    rectangles. Returns (img [H,W,3] float 0..255, boxes [MAX_OBJ,4] xyxy px,
    n_obj)."""
    base = rng.normal(0, 1, (h // 8, w // 8, 3))
    img = np.kron(base, np.ones((8, 8, 1)))
    img = 128.0 + 40.0 * img / np.abs(img).max()
    n = rng.integers(1, MAX_OBJ + 1)
    boxes = np.zeros((MAX_OBJ, 4), np.float32)
    for k in range(n):
        bw = rng.integers(12, 36)
        bh = rng.integers(12, 36)
        x0 = rng.integers(0, w - bw)
        y0 = rng.integers(0, h - bh)
        # high-contrast checker texture — a compact foreground object
        yy, xx = np.mgrid[0:bh, 0:bw]
        checker = (((yy // 4) + (xx // 4)) % 2).astype(np.float32)
        tone = rng.uniform(0.0, 1.0)
        patch = 255.0 * (tone * checker + (1 - tone) * (1 - checker))
        img[y0 : y0 + bh, x0 : x0 + bw] = patch[..., None] * rng.uniform(0.6, 1.0, 3)
        boxes[k] = (x0, y0, x0 + bw, y0 + bh)
    return np.clip(img, 0, 255).astype(np.float32), boxes, n

"""Dynamic-object detector: a compact YOLO-style single-shot network.

Replaces the darknet_ros fork (``src/YoloObjectDetector.cpp`` + ``darknet/``
C/CUDA — the reference's only GPU component, SURVEY §2 #16) with a small
convnet: five conv/BN/leaky/max-pool blocks whose convolutions run in
bfloat16 (cuDNN on the GPU, ``torch.nn.functional.conv2d``), an anchor-grid
head in float32, and a fixed-shape NMS (a stable top-k and a 16-step
suppression loop over an IoU matrix, with no host read). Weights load from an
``.npz`` in the key scheme of the JAX package (``n_convs``,
``c{i}_{w,b,g,be,m,v}``, ``head_w``, ``head_b``; kernels HWIO on disk, OIHW
in memory), so either package loads a file that the other wrote.

Output boxes feed :func:`cull_features_in_boxes` — the dynamic-feature
rejection of ``trackImagebox`` (``feature_tracker.cpp:564-606``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .. import resolve_device

# person, car-ish classes are "dynamic" in the ground-robot setting
DEFAULT_DYNAMIC_CLASSES = (0, 1, 2, 3, 5, 7)   # COCO-ish ids
ANCHORS = np.array([[10, 14], [23, 27], [37, 58]], np.float32)
_BLOCK_KEYS = ("w", "b", "g", "be", "m", "v")


class DetectorParams(NamedTuple):
    convs: tuple            # ((w OIHW, b, gamma, beta, mean, var) per conv block)
    head_w: Tensor          # [A*(5+classes), C, 1, 1]
    head_b: Tensor


def init_params(generator: torch.Generator | None = None,
                channels=(16, 32, 64, 128, 256), n_classes: int = 8,
                dtype=torch.float32, device=None) -> DetectorParams:
    """Random init (for tests, or when no trained weights are found), drawn
    from ``generator`` on the CPU; production weights arrive via
    :func:`load_npz`. ``device=None`` means the GPU."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    convs = []
    cin = 3
    for cout in channels:
        w = torch.randn((cout, cin, 3, 3), generator=g, dtype=dtype) * math.sqrt(2.0 / (9 * cin))
        convs.append(tuple(t.to(device) for t in (
            w, torch.zeros(cout, dtype=dtype), torch.ones(cout, dtype=dtype),
            torch.zeros(cout, dtype=dtype), torch.zeros(cout, dtype=dtype),
            torch.ones(cout, dtype=dtype))))
        cin = cout
    n_out = ANCHORS.shape[0] * (5 + n_classes)
    head_w = (torch.randn((n_out, cin, 1, 1), generator=g, dtype=dtype) * 0.01).to(device)
    return DetectorParams(tuple(convs), head_w, torch.zeros(n_out, dtype=dtype, device=device))


def params_from_jax(convs, head_w, head_b, device=None) -> DetectorParams:
    """Carry weights across from the JAX package's ``DetectorParams``, given
    as arrays (``np.asarray`` of each leaf): kernels move from HWIO to OIHW,
    the rest is copied. ``device=None`` means the GPU."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, copy=True)).to(device)

    def kernel(a):
        return t(np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1)))

    blocks = tuple((kernel(blk[0]), *(t(v) for v in blk[1:])) for blk in convs)
    return DetectorParams(blocks, kernel(head_w), t(head_b))


def load_npz(path: str, device=None) -> DetectorParams:
    """Weights from an ``.npz`` in the JAX package's key scheme."""
    with np.load(path, allow_pickle=False) as data:
        n = int(data["n_convs"])
        convs = [[data[f"c{i}_{k}"] for k in _BLOCK_KEYS] for i in range(n)]
        return params_from_jax(convs, data["head_w"], data["head_b"], device=device)


def save_npz(path: str, params: DetectorParams):
    """Write ``params`` in the JAX package's key scheme (kernels as HWIO)."""
    def arr(t):
        return t.detach().cpu().numpy()

    out = {"n_convs": np.int32(len(params.convs))}
    for i, blk in enumerate(params.convs):
        for k, v in zip(_BLOCK_KEYS, blk):
            out[f"c{i}_{k}"] = arr(v).transpose(2, 3, 1, 0) if k == "w" else arr(v)
    out["head_w"] = arr(params.head_w).transpose(2, 3, 1, 0)
    out["head_b"] = arr(params.head_b)
    np.savez(path, **out)


def _leaky(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, 0.1 * x)


def _channel(v: Tensor) -> Tensor:
    return v[:, None, None]


def _backbone_nchw(params: DetectorParams, x: Tensor) -> Tensor:
    """[N,3,H,W] in [0,1] → [N,C,ceil(H/32),ceil(W/32)] float32. Casts where
    the JAX package casts: conv and bias in bfloat16, batch norm in float32,
    the leaky ReLU's output back to bfloat16, the max-pool in bfloat16."""
    x = x.to(torch.bfloat16)
    for w, b, gamma, beta, mean, var in params.convs:
        x = F.conv2d(x, w.to(torch.bfloat16), padding=1) + _channel(b.to(torch.bfloat16))
        x = x.to(torch.float32)
        x = _channel(gamma) * (x - _channel(mean)) / torch.sqrt(_channel(var) + 1e-5) + _channel(beta)
        x = _leaky(x).to(torch.bfloat16)
        # "SAME" 2×2/2 pooling pads the high side with -inf: ceil_mode
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
    return x.to(torch.float32)


def backbone(params: DetectorParams, img: Tensor) -> Tensor:
    """[N,H,W,3] in [0,1] → feature grid [N,H/32,W/32,C] (NHWC, as the JAX
    package lays it out); convs in bfloat16, statistics in float32."""
    return _backbone_nchw(params, img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _iou_matrix(b: Tensor) -> Tensor:
    x1 = torch.maximum(b[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(b[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(b[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-6)


def detect(params: DetectorParams, img: Tensor, n_classes: int = 8,
           conf_thresh: float = 0.5, iou_thresh: float = 0.45, max_det: int = 16):
    """Full forward + decode + fixed-shape NMS, on ``img``'s device.

    img [H,W,3] in [0,255]. Returns (boxes [max_det,4] xyxy px, scores
    [max_det], classes [max_det], valid [max_det])."""
    h, w = img.shape[0:2]
    feat = _backbone_nchw(params, (img / 255.0).permute(2, 0, 1)[None])
    gy, gx = feat.shape[2], feat.shape[3]
    a = ANCHORS.shape[0]
    raw = F.conv2d(feat, params.head_w) + _channel(params.head_b)
    raw = raw[0].permute(1, 2, 0).reshape(gy, gx, a, 5 + n_classes)

    anchors = torch.as_tensor(ANCHORS, device=img.device)
    col = torch.arange(gx, device=img.device, dtype=raw.dtype)[None, :, None]
    row = torch.arange(gy, device=img.device, dtype=raw.dtype)[:, None, None]
    xs = (torch.sigmoid(raw[..., 0]) + col) * (w / gx)
    ys = (torch.sigmoid(raw[..., 1]) + row) * (h / gy)
    ws = torch.exp(torch.clamp(raw[..., 2], -6, 6)) * anchors[None, None, :, 0]
    hs = torch.exp(torch.clamp(raw[..., 3], -6, 6)) * anchors[None, None, :, 1]
    obj = torch.sigmoid(raw[..., 4])
    score = obj[..., None] * torch.softmax(raw[..., 5:], dim=-1)
    best_score, best_cls = torch.max(score, dim=-1)

    boxes = torch.stack([xs - ws / 2, ys - hs / 2, xs + ws / 2, ys + hs / 2], -1).reshape(-1, 4)
    scores = best_score.reshape(-1)
    classes = best_cls.reshape(-1)

    # top-k with ties to the lowest index, as lax.top_k (which refuses a k
    # above the number of candidates, as this does)
    if scores.shape[0] < max_det:
        raise ValueError(f"{scores.shape[0]} candidate boxes on a {h}x{w} image, fewer than "
                         f"max_det={max_det}")
    s, idx = torch.sort(scores, descending=True, stable=True)
    s, idx = s[:max_det], idx[:max_det]
    b = boxes[idx]
    c = classes[idx]

    # fixed-shape greedy NMS over the top-k, on the device
    ious = _iou_matrix(b)
    later = torch.triu(torch.ones(max_det, max_det, dtype=torch.bool, device=img.device), 1)
    keep = torch.ones(max_det, dtype=torch.bool, device=img.device)
    for i in range(max_det):
        keep = keep & ~((ious[i] > iou_thresh) & later[i] & keep[i])
    valid = keep & (s > conf_thresh)
    return b, s, c, valid


def cull_features_in_boxes(pts_px: Tensor, boxes: Tensor, classes: Tensor,
                           box_valid: Tensor,
                           dynamic_classes=DEFAULT_DYNAMIC_CLASSES) -> Tensor:
    """Feature mask: False for features inside any dynamic-class box
    (trackImagebox culling, feature_tracker.cpp:564-606)."""
    dyn = torch.zeros_like(box_valid)
    for c in dynamic_classes:
        dyn = dyn | (classes == c)
    dyn = dyn & box_valid
    inside = (
        (pts_px[:, None, 0] >= boxes[None, :, 0])
        & (pts_px[:, None, 0] <= boxes[None, :, 2])
        & (pts_px[:, None, 1] >= boxes[None, :, 1])
        & (pts_px[:, None, 1] <= boxes[None, :, 3])
    )
    return ~torch.any(inside & dyn[None, :], dim=1)


class Detector(nn.Module):
    """The network as a module: the five conv blocks and the head as buffers
    (inference only), ``forward`` = :func:`detect`."""

    def __init__(self, params: DetectorParams):
        super().__init__()
        self.n_convs = len(params.convs)
        for i, blk in enumerate(params.convs):
            for k, v in zip(_BLOCK_KEYS, blk):
                self.register_buffer(f"c{i}_{k}", v)
        self.register_buffer("head_w", params.head_w)
        self.register_buffer("head_b", params.head_b)

    @property
    def params(self) -> DetectorParams:
        convs = tuple(tuple(getattr(self, f"c{i}_{k}") for k in _BLOCK_KEYS)
                      for i in range(self.n_convs))
        return DetectorParams(convs, self.head_w, self.head_b)

    def forward(self, img: Tensor, **kw):
        return detect(self.params, img, **kw)

"""Detector training: synthetic rendered scenes → YOLO-style loss → weights.

The training domain of the shipped weights (``detector/weights.npz``) is
synthetic: low-frequency textured backgrounds with high-contrast "dynamic
objects" (the rendered stand-in for people/vehicles), which is exactly the
signal the culling path needs — boxes over image regions that look like
compact foreground objects. This module holds the scene renderer (NumPy),
the batch maker, the anchor-grid targets, the loss and an Adam loop, as the
JAX package's ``detector/train.py`` has them; gradients flow through the
bfloat16 convolutions of :func:`.model.backbone` (cuDNN on the GPU) as they
flow through XLA's there. ``python -m
ground_fusion_tpu_torch.scripts.train_detector`` writes the trained
weights in the JAX package's npz key scheme.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .model import ANCHORS, DetectorParams, _backbone_nchw, _channel, init_params

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


def make_batch(rng, batch: int, h: int = 96, w: int = 96, device=None):
    """``batch`` scenes of :func:`render_scene`, drawn from ``rng`` in order:
    (imgs [B,H,W,3] float32, boxes [B,MAX_OBJ,4] float32, ns [B] int32) on
    ``device`` (``None``: the GPU)."""
    device = resolve_device(device)
    imgs = np.zeros((batch, h, w, 3), np.float32)
    boxes = np.zeros((batch, MAX_OBJ, 4), np.float32)
    ns = np.zeros(batch, np.int32)
    for i in range(batch):
        imgs[i], boxes[i], ns[i] = render_scene(rng, h, w)
    return tuple(torch.from_numpy(a).to(device) for a in (imgs, boxes, ns))


def _targets(boxes, n_obj, gy: int, gx: int, stride: float, n_classes: int = 8):
    """Anchor-grid assignment for a batch of images (``boxes`` [B,MAX_OBJ,4],
    ``n_obj`` [B]): every GT box trains the best wh-IoU anchor at its center
    cell. Returns t_obj [B,gy,gx,A], t_box [B,gy,gx,A,4], t_cls [B,gy,gx,A]
    (int64, all zero: the renderer draws class 0). The boxes of an image are
    taken in order, as the JAX package's scan takes them: where two fall on
    one cell and anchor, objectness keeps the max and the box the last
    write."""
    dev = boxes.device
    anch = torch.as_tensor(ANCHORS, device=dev)
    b_n, a = boxes.shape[0], ANCHORS.shape[0]
    t_obj = torch.zeros((b_n, gy, gx, a), device=dev)
    t_box = torch.zeros((b_n, gy, gx, a, 4), device=dev)
    t_cls = torch.zeros((b_n, gy, gx, a), dtype=torch.int64, device=dev)
    img = torch.arange(b_n, device=dev)
    for k in range(boxes.shape[1]):
        b = boxes[:, k]
        ok = k < n_obj
        cxp = (b[:, 0] + b[:, 2]) / 2.0
        cyp = (b[:, 1] + b[:, 3]) / 2.0
        bw = torch.clamp(b[:, 2] - b[:, 0], min=1.0)
        bh = torch.clamp(b[:, 3] - b[:, 1], min=1.0)
        ci = torch.clamp((cxp / stride).to(torch.int64), 0, gx - 1)
        cj = torch.clamp((cyp / stride).to(torch.int64), 0, gy - 1)
        inter = torch.minimum(bw[:, None], anch[:, 0]) * torch.minimum(bh[:, None], anch[:, 1])
        union = (bw * bh)[:, None] + anch[:, 0] * anch[:, 1] - inter
        ai = torch.argmax(inter / union, dim=1)
        tb = torch.stack([cxp / stride - ci, cyp / stride - cj,
                          torch.log(bw / anch[ai, 0]), torch.log(bh / anch[ai, 1])], dim=-1)
        cell = (img, cj, ci, ai)
        t_obj = t_obj.index_put(cell, torch.maximum(t_obj[cell], ok.to(t_obj.dtype)))
        t_box = t_box.index_put(cell, torch.where(ok[:, None], tb, t_box[cell]))
    return t_obj, t_box, t_cls


def loss_fn(params: DetectorParams, imgs, boxes, ns, n_classes: int = 8):
    """YOLO-style single-scale loss: obj BCE (no-obj weight 0.5), box
    regression and class CE at assigned anchors. ``imgs`` [B,H,W,3] in
    [0,255]; differentiable in every leaf of ``params``."""
    feat = _backbone_nchw(params, (imgs / 255.0).permute(0, 3, 1, 2))
    gy, gx = feat.shape[2], feat.shape[3]
    a = ANCHORS.shape[0]
    stride = imgs.shape[2] / gx
    raw = F.conv2d(feat, params.head_w) + _channel(params.head_b)
    raw = raw.permute(0, 2, 3, 1).reshape(imgs.shape[0], gy, gx, a, 5 + n_classes)

    t_obj, t_box, t_cls = _targets(boxes, ns, gy, gx, stride, n_classes)

    obj_logit = raw[..., 4]
    bce = torch.clamp(obj_logit, min=0) - obj_logit * t_obj + torch.log1p(
        torch.exp(-torch.abs(obj_logit)))
    w_obj = torch.where(t_obj > 0, 5.0, 0.5)
    l_obj = torch.mean(w_obj * bce)

    pred_xy = torch.sigmoid(raw[..., 0:2])
    pred_wh = raw[..., 2:4]
    n_pos = torch.clamp(torch.sum(t_obj), min=1.0)
    l_box = torch.sum(
        t_obj[..., None]
        * ((pred_xy - t_box[..., 0:2]) ** 2 + (pred_wh - t_box[..., 2:4]) ** 2)) / n_pos

    logp = torch.log_softmax(raw[..., 5:], dim=-1)
    l_cls = -torch.sum(t_obj * torch.take_along_dim(logp, t_cls[..., None], dim=-1)[..., 0]) / n_pos
    return l_obj + l_box + 0.2 * l_cls


def leaves(params: DetectorParams) -> list:
    """Every tensor of ``params`` in the JAX package's leaf order (each conv
    block's w, b, gamma, beta, mean, var, then the head): the JAX loop
    trains all of them, batch-norm statistics included."""
    return [t for blk in params.convs for t in blk] + [params.head_w, params.head_b]


def with_leaves(params: DetectorParams, new: list) -> DetectorParams:
    """``params`` with its leaves replaced by ``new`` (:func:`leaves` order)."""
    n = len(params.convs[0]) if params.convs else 0
    convs = tuple(tuple(new[i * n:(i + 1) * n]) for i in range(len(params.convs)))
    return DetectorParams(convs, new[-2], new[-1])


def adam(params: DetectorParams, lr: float = 1e-3) -> torch.optim.Adam:
    """``torch.optim.Adam`` over every leaf with ``optax.adam``'s defaults
    (b1 0.9, b2 0.999, eps 1e-8, no weight decay)."""
    return torch.optim.Adam(leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train(steps: int = 400, batch: int = 16, lr: float = 1e-3, seed: int = 0,
          log_every: int = 50, params: DetectorParams | None = None, device=None,
          losses: list | None = None):
    """Adam training on the synthetic renderer; returns trained params.

    The initial parameters come from ``init_params`` with a
    ``torch.Generator`` seeded by ``seed`` (unless ``params`` is given), the
    batches from ``np.random.default_rng(seed)``. ``device=None`` means the
    GPU. The loss of each step is appended to ``losses`` when given (one
    device→host read a step; otherwise only the logged steps are read)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if params is None:
        params = init_params(torch.Generator().manual_seed(seed), device=device)
    params = with_leaves(params, [t.detach().clone().requires_grad_(True) for t in leaves(params)])
    opt = adam(params, lr)
    for it in range(steps):
        imgs, boxes, ns = make_batch(rng, batch, device=device)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, imgs, boxes, ns)
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(float(loss.detach()))
        if log_every and it % log_every == 0:
            print(f"step {it:4d}  loss {float(loss.detach()):.4f}", flush=True)
    return with_leaves(params, [t.detach() for t in leaves(params)])

"""Anchor-free detection decode (yolo11/plugin/yololayer.cu:177-319
`CalDetection`): best class from the raw logits, box corners from the
DFL-decoded ltrb distances, ``x1 = (col + 0.5 - l) * stride`` and so on.
Like the JAX package, everything stays dense; selection is the exact top-k
of `ops/nms.py`. The pose and obb tails (`decode_pose`, `decode_obb`) are
yololayer.cu:231-283. Constants are Python scalars, so the decode holds no
host tensor and stays legal inside a captured CUDA graph.
"""

from __future__ import annotations

import math

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["make_anchor_grid", "decode_boxes_ltrb", "best_class", "decode_pose",
           "decode_obb"]


def make_anchor_grid(input_h: int, input_w: int,
                     strides: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Flattened per-cell (cx, cy) in grid units and the stride of each
    anchor point, level-major and row-major like the reference.
    Returns (points (N, 2) float32, strides_flat (N,) float32) as numpy
    constants."""
    pts, sts = [], []
    for s in strides:
        gh, gw = input_h // s, input_w // s
        ys, xs = np.meshgrid(np.arange(gh, dtype=np.float32),
                             np.arange(gw, dtype=np.float32), indexing="ij")
        pts.append(np.stack([xs + 0.5, ys + 0.5], axis=-1).reshape(-1, 2))
        sts.append(np.full((gh * gw,), float(s), np.float32))
    return np.concatenate(pts, 0), np.concatenate(sts, 0)


def decode_boxes_ltrb(ltrb: torch.Tensor, points: torch.Tensor,
                      strides_flat: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) DFL distances + anchor points → xyxy boxes in input pixels."""
    cx, cy = points[None, :, 0], points[None, :, 1]
    s = strides_flat[None, :]
    x1 = (cx - ltrb[..., 0]) * s
    y1 = (cy - ltrb[..., 1]) * s
    x2 = (cx + ltrb[..., 2]) * s
    y2 = (cy + ltrb[..., 3]) * s
    return torch.stack([x1, y1, x2, y2], dim=-1)


def best_class(cls_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., nc) raw class logits → (conf, cls_id), both float32.

    sigmoid is monotone, so max(sigmoid(x)) == sigmoid(max(x)) and the
    argmax is that of the logits. `torch.argmax` returns the first maximal
    index, the tie order of `jnp.argmax`."""
    conf = torch.sigmoid(cls_logits.amax(dim=-1).float())
    cls_id = cls_logits.argmax(dim=-1).float()
    return conf, cls_id


def decode_pose(kpt_raw: torch.Tensor, points: torch.Tensor, strides_flat: torch.Tensor,
                boxes_xyxy: torch.Tensor, conf_thresh: float) -> torch.Tensor:
    """(B, N, 3K) raw keypoints → decoded (B, N, 3K) with the reference's
    gating (yololayer.cu:231-256): kpt = (v·2 + cell)·stride, conf =
    sigmoid; x, y and conf become −1 where conf < conf_thresh or the
    keypoint lies outside its own box."""
    b, n, ck = kpt_raw.shape
    kr = kpt_raw.reshape(b, n, ck // 3, 3)
    cx, cy = points[None, :, None, 0], points[None, :, None, 1]
    s = strides_flat[None, :, None]
    x = (kr[..., 0] * 2.0 + (cx - 0.5)) * s
    y = (kr[..., 1] * 2.0 + (cy - 0.5)) * s
    conf = torch.sigmoid(kr[..., 2])
    bx = boxes_xyxy[..., None, :]
    inside = (x >= bx[..., 0]) & (x <= bx[..., 2]) & (y >= bx[..., 1]) & (y <= bx[..., 3])
    ok = (conf >= conf_thresh) & inside
    out = torch.stack([x, y, conf], dim=-1)
    return torch.where(ok[..., None], out, -1.0).reshape(b, n, ck)


def decode_obb(ltrb: torch.Tensor, angle_raw: torch.Tensor, points: torch.Tensor,
               strides_flat: torch.Tensor):
    """OBB decode (yololayer.cu:258-283): angle = (sigmoid(a) − 0.25)·π, the
    centre offset rotated by it. Returns (cx, cy, w, h, angle), each (B, N)."""
    ang = (torch.sigmoid(angle_raw) - 0.25) * math.pi
    xf = (ltrb[..., 2] - ltrb[..., 0]) * 0.5
    yf = (ltrb[..., 3] - ltrb[..., 1]) * 0.5
    c, s_ = torch.cos(ang), torch.sin(ang)
    xr = xf * c - yf * s_
    yr = xf * s_ + yf * c
    st = strides_flat[None, :]
    cx = (points[None, :, 0] + xr) * st
    cy = (points[None, :, 1] + yr) * st
    w = (ltrb[..., 0] + ltrb[..., 2]) * st
    h = (ltrb[..., 1] + ltrb[..., 3]) * st
    return cx, cy, w, h, ang

"""Letterbox preprocessing — the reference's warp-affine kernel
(yolo11/src/preprocess.cu:7-117) in torch ops.

Semantics of the JAX package's `letterbox` (tensorrtx_tpu/ops/preprocess.py:
28-101): scale = min(dst_h/src_h, dst_w/src_w), centred; bilinear sampling
at ``src = (dst - dst/2)/s + src/2 + 0.5``; taps outside the image take the
border value 128; optional BGR→RGB; then ``* scale + offset``. Frames share
one static bucket (H, W); each image's true (h, w) arrives as data and the
image sits in the top-left corner of its frame.
"""

from __future__ import annotations

import torch

__all__ = ["letterbox", "letterbox_batch", "scale_boxes_back"]


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    # a true division: `float / tensor` runs as reciprocal-then-multiply,
    # which can differ from the JAX package's quotient in the last bit
    return torch.full_like(den, float(num)) / den


def letterbox_batch(imgs: torch.Tensor, src_hw, dst_h: int, dst_w: int,
                    border_value: float = 128.0, bgr_to_rgb: bool = False,
                    scale: float = 1.0 / 255.0, offset: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) uint8 + (B, 2) [h, w] → (B, dst_h, dst_w, C) float32.
    src_hw on imgs' device makes no host copy, so the call can be captured
    into a CUDA graph."""
    b, hh, ww, _ = imgs.shape
    dev = imgs.device
    src_hw = torch.as_tensor(src_hw, device=dev)
    src_h = src_hw[:, 0:1].float()                       # (B, 1)
    src_w = src_hw[:, 1:2].float()
    s = torch.minimum(_div(dst_h, src_h), _div(dst_w, src_w))

    dx = torch.arange(dst_w, dtype=torch.float32, device=dev)
    dy = torch.arange(dst_h, dtype=torch.float32, device=dev)
    src_x = (dx - dst_w * 0.5) / s + src_w * 0.5 + 0.5  # (B, dst_w)
    src_y = (dy - dst_h * 0.5) / s + src_h * 0.5 + 0.5  # (B, dst_h)
    oob_x = (src_x <= -1.0) | (src_x >= src_w)
    oob_y = (src_y <= -1.0) | (src_y >= src_h)

    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    lx = src_x - x0
    ly = src_y - y0
    x0i = x0.long()
    y0i = y0.long()
    w_lim = src_w.long()
    h_lim = src_h.long()
    bi = torch.arange(b, device=dev)[:, None, None]
    bv = float(border_value)   # a Python scalar: no host-to-device copy per call

    def tap(xi, yi):
        vx = (xi >= 0) & (xi < w_lim)
        vy = (yi >= 0) & (yi < h_lim)
        valid = (vy[:, :, None] & vx[:, None, :])[..., None]
        xc = xi.clamp(0, ww - 1)
        yc = yi.clamp(0, hh - 1)
        v = imgs[bi, yc[:, :, None], xc[:, None, :]].float()  # (B, dh, dw, C)
        return torch.where(valid, v, bv)

    v00 = tap(x0i, y0i)
    v01 = tap(x0i + 1, y0i)
    v10 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)
    wx = lx[:, None, :, None]
    wy = ly[:, :, None, None]
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    oob = (oob_x[:, None, :] | oob_y[:, :, None])[..., None]
    out = torch.where(oob, bv, out)
    if bgr_to_rgb:
        out = out.flip(-1)
    return out * scale + offset


def letterbox(img: torch.Tensor, src_h: int, src_w: int, dst_h: int,
              dst_w: int, **kw) -> torch.Tensor:
    """uint8 (H, W, C) → float32 (dst_h, dst_w, C), letterboxed and
    normalised; the image is the top-left (src_h, src_w) corner of img."""
    return letterbox_batch(img[None], [[src_h, src_w]], dst_h, dst_w, **kw)[0]


def scale_boxes_back(boxes: torch.Tensor, src_h, src_w, dst_h: int,
                     dst_w: int) -> torch.Tensor:
    """Map xyxy boxes from letterboxed input space back to original image
    coords (inverse of the affine; reference get_rect,
    postprocess.cpp:4-40)."""
    src_h = torch.as_tensor(src_h, dtype=torch.float32, device=boxes.device)
    src_w = torch.as_tensor(src_w, dtype=torch.float32, device=boxes.device)
    s = torch.minimum(_div(dst_h, src_h), _div(dst_w, src_w))
    pad_x = (dst_w - s * src_w) * 0.5
    pad_y = (dst_h - s * src_h) * 0.5

    def clip(v, hi):
        return torch.minimum(v.clamp_min(0.0), hi)

    x1 = clip((boxes[..., 0] - pad_x) / s, src_w)
    y1 = clip((boxes[..., 1] - pad_y) / s, src_h)
    x2 = clip((boxes[..., 2] - pad_x) / s, src_w)
    y2 = clip((boxes[..., 3] - pad_y) / s, src_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)

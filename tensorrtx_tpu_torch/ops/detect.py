"""Anchor-free detection decode (yolo11/plugin/yololayer.cu:177-319
`CalDetection`): best class from the raw logits, box corners from the
DFL-decoded ltrb distances, ``x1 = (col + 0.5 - l) * stride`` and so on.
Like the JAX package, everything stays dense; selection is the exact top-k
of `ops/nms.py`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["make_anchor_grid", "decode_boxes_ltrb", "best_class"]


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

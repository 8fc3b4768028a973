"""Fixed-size deterministic NMS, batched.

One-pass keep-flag semantics of the reference's GPU kernel
(yolo11/src/postprocess.cu:89-111): box i is suppressed if ANY valid
same-class box j with higher priority (score_j > score_i, or equal score and
j before i) overlaps it with IoU > thresh, whether or not j itself survives.
`select_and_nms` runs the keep mask through the hand-written CUDA kernel
(`ops/cuda/nms_mask.py`) on the card; `nms_mask` below is the plain version
the kernel is held against.

Rotated boxes (obb) are suppressed by their probabilistic IoU
(`probiou_matrix`) and the one-pass mask in torch ops: the JAX package
sends obb past its Pallas kernel too, so neither package has a kernel for
it. `select_topk` is the NMS-free selection of the one2one heads.

All outputs are fixed-size: (max_det) slots + a count, the reference's
count-plus-buffer contract (kMaxNumOutputBbox).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["Detections", "topk_exact", "box_iou_matrix", "probiou_matrix", "nms_mask",
           "select_and_nms", "select_topk"]


class Detections(NamedTuple):
    """Fixed-size detection buffer (the analog of [count, Detection...])."""
    boxes: torch.Tensor    # (B, max_det, 4) xyxy float32 (obb: cx, cy, w, h)
    scores: torch.Tensor   # (B, max_det) float32, 0 in empty slots
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor    # (B, max_det) bool
    count: torch.Tensor    # (B,) int32
    extras: Optional[torch.Tensor] = None  # (B, max_det, E) mask coeffs / kpts / angle

    def as_dict(self):
        d = self._asdict()
        if d["extras"] is None:
            del d["extras"]
        return d


def topk_exact(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties broken by the lower index — the
    order of `lax.top_k` and the JAX package's `topk_hier`. `torch.topk`
    leaves the order of ties unspecified, so this takes the head of a
    stable descending sort."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) xyxy → (..., N, N) IoU (reference box_iou,
    postprocess.cu:74-88): degenerate boxes clamp to area 0, and no
    intersection gives IoU 0."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    il = torch.maximum(x1[..., :, None], x1[..., None, :])
    it = torch.maximum(y1[..., :, None], y1[..., None, :])
    ir = torch.minimum(x2[..., :, None], x2[..., None, :])
    ib = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ir - il).clamp_min(0.0) * (ib - it).clamp_min(0.0)
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(inter > 0.0, inter / union, torch.zeros_like(inter))


def _cov(w, h, r):
    a = w * w / 12.0
    b = h * h / 12.0
    c, s = torch.cos(r), torch.sin(r)
    return a * c * c + b * s * s, a * s * s + b * c * c, (a - b) * s * c


def probiou_matrix(obb: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(..., N, 5) [cx, cy, w, h, angle] → (..., N, N) probabilistic IoU of
    rotated boxes (postprocess.cu:113-142, arXiv:2106.06072), in the JAX
    package's operation order."""
    cx, cy, w, h, r = obb.unbind(-1)
    a, b, c = _cov(w, h, r)
    a12 = a[..., :, None] + a[..., None, :]
    b12 = b[..., :, None] + b[..., None, :]
    c12 = c[..., :, None] + c[..., None, :]
    dx = cx[..., :, None] - cx[..., None, :]
    dy = cy[..., :, None] - cy[..., None, :]
    denom = a12 * b12 - c12 * c12 + eps
    t1 = (a12 * dy * dy + b12 * dx * dx) / denom
    t2 = (c12 * (-dx) * dy) / denom
    det1 = (a * b - c * c).clamp_min(0.0)
    t3 = torch.log((a12 * b12 - c12 * c12)
                   / (4.0 * torch.sqrt(det1[..., :, None] * det1[..., None, :] + eps * eps)
                      + eps) + eps)
    bd = (0.25 * t1 + 0.5 * t2 + 0.5 * t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1.0 - hd


def nms_mask(iou: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
             iou_thresh: float, valid: torch.Tensor) -> torch.Tensor:
    """One-pass keep mask over (..., N) candidates, given their (..., N, N)
    IoU matrix."""
    n = scores.shape[-1]
    same_cls = classes[..., :, None] == classes[..., None, :]
    higher = scores[..., None, :] > scores[..., :, None]
    idx = torch.arange(n, device=scores.device)
    tie = (scores[..., None, :] == scores[..., :, None]) & (idx[None, :] < idx[:, None])
    dominates = (higher | tie) & same_cls & valid[..., None, :]
    killed = (dominates & (iou > iou_thresh)).any(dim=-1)
    return valid & ~killed


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows at idx (B, K) → (B, K, ...)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def select_and_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, conf_thresh: float,
                   iou_thresh: float, max_det: int,
                   extras: Optional[torch.Tensor] = None, obb: bool = False) -> Detections:
    """Candidate selection + NMS + compaction, batched.

    boxes (B, N, 4) xyxy (obb: cx, cy, w, h, with the angle in
    extras[..., 0]), scores (B, N) best-class confidence, classes (B, N),
    extras (B, N, E) or None. Mask by conf_thresh, exact top-k to max_det
    slots, one-pass keep mask, then a stable keep-first compaction
    (survivors first, in score order); extras follow the top-k and the
    compaction. The keep mask of xyxy boxes is the `nms_mask` CUDA kernel
    on the card; obb's is `probiou_matrix` and the plain mask. Identical
    results to the JAX package's ``select_and_nms(impl="pallas")`` and its
    default XLA path.
    """
    from tensorrtx_tpu_torch.ops.cuda import nms_mask as nms_kernel

    cand = scores >= conf_thresh
    masked = torch.where(cand, scores, torch.full_like(scores, -1.0))
    k = min(max_det, scores.shape[-1])
    top_sc, top_i = topk_exact(masked, k)
    top_bx = _take(boxes, top_i)
    top_cl = _take(classes, top_i)
    top_ex = None if extras is None else _take(extras, top_i)
    valid = top_sc >= conf_thresh
    if obb:
        iou = probiou_matrix(torch.cat([top_bx, top_ex[..., :1]], dim=-1))
        keep = nms_mask(iou, top_sc, top_cl, iou_thresh, valid)
    else:
        keep = nms_kernel.keep_mask(
            top_bx.float().contiguous(),
            torch.where(valid, top_sc, torch.zeros_like(top_sc)).float().contiguous(),
            top_cl.float().contiguous(), iou_thresh)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    return Detections(
        boxes=_take(top_bx, order),
        scores=torch.gather(torch.where(keep, top_sc, torch.zeros_like(top_sc)), 1, order),
        classes=torch.gather(top_cl, 1, order).to(torch.int32),
        valid=torch.gather(keep, 1, order),
        count=keep.sum(dim=-1, dtype=torch.int32),
        extras=None if top_ex is None else _take(top_ex, order),
    )


def select_topk(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                conf_thresh: float, max_det: int,
                extras: Optional[torch.Tensor] = None) -> Detections:
    """NMS-free selection (the one2one heads' contract,
    yolov10/plugin/yololayer.cu:157): confidence gate + exact top-k, no
    suppression."""
    masked = torch.where(scores >= conf_thresh, scores, torch.full_like(scores, -1.0))
    top_sc, top_i = topk_exact(masked, min(max_det, scores.shape[-1]))
    valid = top_sc >= conf_thresh
    return Detections(
        boxes=_take(boxes, top_i),
        scores=torch.where(valid, top_sc, torch.zeros_like(top_sc)),
        classes=torch.gather(classes, 1, top_i).to(torch.int32),
        valid=valid,
        count=valid.sum(dim=-1, dtype=torch.int32),
        extras=None if extras is None else _take(extras, top_i),
    )

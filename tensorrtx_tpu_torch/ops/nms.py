"""Fixed-size deterministic NMS, batched.

One-pass keep-flag semantics of the reference's GPU kernel
(yolo11/src/postprocess.cu:89-111): box i is suppressed if ANY valid
same-class box j with higher priority (score_j > score_i, or equal score and
j before i) overlaps it with IoU > thresh, whether or not j itself survives.
`select_and_nms` runs the keep mask through the hand-written CUDA kernel
(`ops/cuda/nms_mask.py`) on the card; `nms_mask` below is the plain version
the kernel is held against.

All outputs are fixed-size: (max_det) slots + a count, the reference's
count-plus-buffer contract (kMaxNumOutputBbox).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["Detections", "topk_exact", "box_iou_matrix", "nms_mask",
           "select_and_nms"]


class Detections(NamedTuple):
    """Fixed-size detection buffer (the analog of [count, Detection...])."""
    boxes: torch.Tensor    # (B, max_det, 4) xyxy float32
    scores: torch.Tensor   # (B, max_det) float32, 0 in empty slots
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor    # (B, max_det) bool
    count: torch.Tensor    # (B,) int32

    def as_dict(self):
        return self._asdict()


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


def select_and_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, conf_thresh: float,
                   iou_thresh: float, max_det: int) -> Detections:
    """Candidate selection + NMS + compaction, batched.

    boxes (B, N, 4) xyxy, scores (B, N) best-class confidence, classes
    (B, N). Mask by conf_thresh, exact top-k to max_det slots, one-pass
    keep mask, then a stable keep-first compaction (survivors first, in
    score order). Identical results to the JAX package's
    ``select_and_nms(impl="pallas")`` and its default XLA path.
    """
    from tensorrtx_tpu_torch.ops.cuda import nms_mask as nms_kernel

    cand = scores >= conf_thresh
    masked = torch.where(cand, scores, torch.full_like(scores, -1.0))
    k = min(max_det, scores.shape[-1])
    top_sc, top_i = topk_exact(masked, k)
    top_bx = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    top_cl = torch.gather(classes, 1, top_i)
    valid = top_sc >= conf_thresh
    keep = nms_kernel.keep_mask(
        top_bx.float().contiguous(),
        torch.where(valid, top_sc, torch.zeros_like(top_sc)).float().contiguous(),
        top_cl.float().contiguous(), iou_thresh)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    return Detections(
        boxes=torch.gather(top_bx, 1, order[..., None].expand(-1, -1, 4)),
        scores=torch.gather(torch.where(keep, top_sc, torch.zeros_like(top_sc)),
                            1, order),
        classes=torch.gather(top_cl, 1, order).to(torch.int32),
        valid=torch.gather(keep, 1, order),
        count=keep.sum(dim=-1, dtype=torch.int32),
    )

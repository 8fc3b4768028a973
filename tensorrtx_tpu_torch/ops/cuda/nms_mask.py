"""One-pass NMS keep mask: the CUDA kernel `csrc/nms_mask.cu` and its plain
PyTorch version.

Replaces the TPU kernel `tensorrtx_tpu/ops/pallas/nms_pallas.py::
nms_mask_pallas`, which the JAX package reaches through
``select_and_nms(impl="pallas")``. The semantics are those of
`ops.nms.nms_mask`:

    keep_i = score_i > 0 ∧ ¬∃j: class_j = class_i ∧ score_j > 0
             ∧ (score_j > score_i ∨ (score_j = score_i ∧ j < i))
             ∧ IoU_ij > thresh

`keep_mask` launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from tensorrtx_tpu_torch.ops.cuda import build
from tensorrtx_tpu_torch.ops.nms import box_iou_matrix, nms_mask

__all__ = ["keep_mask", "keep_mask_plain", "launches", "MAX_N"]

# Launches of the CUDA kernel in this process (not of the plain version).
# A launch captured into a CUDA graph counts once, when it is captured;
# the graph's replays launch it again without counting.
launches = 0

# The kernel stages 7 float planes of N candidates in shared memory (57 KB
# at 2048, with the kernel's opt-in above the 48 KB default).
MAX_N = 2048

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("nms_mask").nms_mask_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def keep_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                    classes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """The kernel's contract in plain torch ops (dense (B, N, N) matrices)."""
    return nms_mask(box_iou_matrix(boxes), scores, classes, iou_thresh,
                    scores > 0.0)


def _check(boxes, scores, classes):
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, N, 4), got {tuple(boxes.shape)}")
    bn = boxes.shape[:2]
    for name, t in (("scores", scores), ("classes", classes)):
        if t.shape != bn:
            raise ValueError(f"{name} must be {tuple(bn)}, got {tuple(t.shape)}")
    for name, t in (("boxes", boxes), ("scores", scores), ("classes", classes)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != boxes.device:
            raise ValueError(f"{name} is on {t.device}, boxes on {boxes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def keep_mask(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
              iou_thresh: float) -> torch.Tensor:
    """boxes (B, N, 4) xyxy float32 sorted by descending score; scores (B, N)
    float32 with invalid slots ≤ 0; classes (B, N) float32 → keep (B, N)
    bool."""
    global launches
    _check(boxes, scores, classes)
    if boxes.device.type == "cpu":
        return keep_mask_plain(boxes, scores, classes, iou_thresh)
    if boxes.device.type != "cuda":
        raise ValueError(f"no nms_mask kernel for device {boxes.device}")
    b, n = scores.shape
    if n > MAX_N:
        raise ValueError(f"nms_mask kernel takes N ≤ {MAX_N} candidates, got {n}")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_mask kernel reads boxes as float4: 16-byte alignment required")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(boxes.data_ptr(), scores.data_ptr(),
                          classes.data_ptr(), keep.data_ptr(), b, n,
                          float(iou_thresh), stream)
    if err != 0:
        raise RuntimeError(f"nms_mask kernel launch failed: cudaError {err}")
    launches += 1
    return keep

"""Core NN ops of the detection graph.

Feature maps are NCHW tensors kept in ``torch.channels_last`` memory, and
conv kernels are OIHW — PyTorch's own layouts, which cuDNN takes without a
relayout. The JAX package's counterparts (`tensorrtx_tpu/ops/nn.py`) take
NHWC/HWIO; the values are the same. These are plain torch ops: the JAX
package leaves them to XLA, so the port leaves them to cuDNN and torch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "conv_transpose2d", "silu", "max_pool", "upsample_nearest", "dfl",
           "linear", "global_avg_pool"]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NCHW conv with OIHW weights and symmetric padding (TensorRT's
    setPaddingNd). The group count follows from the weight: a depthwise
    kernel (C, 1, k, k) on C channels is C groups."""
    groups = x.shape[1] // w.shape[1]
    return F.conv2d(x, w, b, stride=stride, padding=padding, groups=groups)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     stride: int = 2) -> torch.Tensor:
    """NCHW transposed conv (torch ConvTranspose2d, groups 1, padding 0) with
    the weight in its (in, out, kh, kw) layout: the seg proto's 2×2 stride-2
    upsample (the JAX package's ``conv_transpose2d`` takes it as
    (kh, kw, out, in); `core.convert` moves it between the two)."""
    return F.conv_transpose2d(x, w, b, stride=stride)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) with w stored (in, out), as the JAX package stores it."""
    out = x @ w
    return out if b is None else out + b


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C): the mean over the spatial axes."""
    return x.mean(dim=(2, 3))


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def max_pool(x: torch.Tensor, k: int, stride: int, padding: int) -> torch.Tensor:
    # the padding never fills a whole window, so -inf padding gives the
    # JAX package's finfo.min-padded result
    return F.max_pool2d(x, k, stride, padding)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def dfl(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution Focal Loss decode (yolo11/src/block.cpp:138-158):
    (..., 4*reg_max) logits → softmax-weighted bin expectation (..., 4),
    in float32 whatever the input dtype."""
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max).float()
    p = torch.softmax(x, dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (p * bins).sum(-1)

"""Float direct convolutions on the planar (B, H, C, W) layout: the CUDA
kernels `csrc/conv_planar.cu` and their plain PyTorch versions.

Replace the TPU kernels `tensorrtx_tpu/ops/pallas/conv_planar.py::
conv3x3_planar` and `::conv1x1_planar`, with their contract:

    o = act(conv(x, w) + b)       3×3 stride-1 SAME, or 1×1; float32 sum
    o = o + residual              added AFTER the activation
    out = o in x's dtype, (B, H, Co, W)

x (B, H, C, W) float32 or bfloat16, contiguous (`to_planar` makes it from
NHWC); w HWIO, (3, 3, C, Co) or (1, 1, C, Co) / (C, Co), any float dtype
(summed in float32); b (Co,) or None; residual (B, H, Co, W) in x's dtype or
None; act "silu", "relu" or None. The JAX kernel's ``th`` (rows per grid
step, a TPU tiling choice) has no counterpart. No model of either package
calls these ops; they are ported as standalone ops.

The wrappers launch the kernel for CUDA tensors and raise if they cannot;
they take the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tensorrtx_tpu_torch.ops.cuda import build
from tensorrtx_tpu_torch.ops.cuda.qconv import act_f

__all__ = ["conv3x3_planar", "conv1x1_planar", "conv_planar_plain", "to_planar",
           "from_planar", "launches_3x3", "launches_1x1"]

# Launches of each CUDA kernel in this process (not of the plain version).
# A launch captured into a CUDA graph counts once, when it is captured;
# the graph's replays launch it again without counting.
launches_3x3 = 0
launches_1x1 = 0

_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "silu": 1, "relu": 2}

_fn = None


def to_planar(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H, C, W), contiguous."""
    return x.permute(0, 1, 3, 2).contiguous()


def from_planar(x: torch.Tensor) -> torch.Tensor:
    """(B, H, C, W) → (B, H, W, C), contiguous."""
    return x.permute(0, 1, 3, 2).contiguous()


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("conv_planar").conv_planar_launch
        # x, w, bias, res, out, then k, kind, act, B, H, C, W, Co, then stream
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _hwio(w: torch.Tensor, k: int) -> torch.Tensor:
    return w.reshape(k, k, w.shape[-2], w.shape[-1])


def conv_planar_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None, act: Optional[str] = "silu",
                      k: int = 3) -> torch.Tensor:
    """The kernels' contract in plain torch ops: a float32 convolution of
    the (B, C, H, W) view, bias, the JAX activation form, the residual."""
    w4 = _hwio(w, k).permute(3, 2, 0, 1).float()
    o = F.conv2d(x.permute(0, 2, 1, 3).float(), w4, None if b is None else b.float(),
                 padding=k // 2)
    o = act_f(o, act).permute(0, 2, 1, 3)
    if residual is not None:
        o = o + residual.float()
    return o.to(x.dtype).contiguous()


def _check(x, w, b, residual, act, k):
    if x.dim() != 4:
        raise ValueError(f"x must be planar (B, H, C, W), got {tuple(x.shape)}")
    bsz, h, c, wd = x.shape
    if (k == 3 and w.dim() != 4) or w.shape[-2] != c or w.numel() != k * k * c * w.shape[-1]:
        raise ValueError(f"w must be HWIO ({k}, {k}, {c}, Co), got {tuple(w.shape)}")
    co = w.shape[-1]
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.dtype not in _KINDS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not w.is_floating_point():
        raise TypeError(f"w must be floating point, got {w.dtype}")
    if b is not None and tuple(b.shape) != (co,):
        raise ValueError(f"b must be ({co},), got {tuple(b.shape)}")
    if residual is not None:
        if tuple(residual.shape) != (bsz, h, co, wd):
            raise ValueError(f"residual must be {(bsz, h, co, wd)}, got {tuple(residual.shape)}")
        if residual.dtype != x.dtype:
            raise TypeError(f"residual must be {x.dtype}, got {residual.dtype}")
    for name, t in (("w", w), ("b", b), ("residual", residual)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (to_planar makes x so)")
    return bsz, h, c, wd, co


def _conv(k, x, w, b, residual, act):
    global launches_3x3, launches_1x1
    bsz, h, c, wd, co = _check(x, w, b, residual, act, k)
    if x.device.type == "cpu":
        return conv_planar_plain(x, w, b, residual, act, k)
    if x.device.type != "cuda":
        raise ValueError(f"no conv_planar kernel for device {x.device}")
    wf = w.float().contiguous()
    bf = None if b is None else b.float().contiguous()
    out = torch.empty((bsz, h, co, wd), dtype=x.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x.data_ptr(), wf.data_ptr(), ptr(bf), ptr(residual),
                          out.data_ptr(), k, _KINDS[x.dtype], _ACTS[act], bsz, h, c,
                          wd, co, stream)
    if err != 0:
        raise RuntimeError(f"conv{k}x{k}_planar kernel launch failed: cudaError {err}")
    if k == 3:
        launches_3x3 += 1
    else:
        launches_1x1 += 1
    return out


def conv3x3_planar(x, w, b=None, residual=None, act: Optional[str] = "silu") -> torch.Tensor:
    """3×3 stride-1 SAME conv on planar x with fused bias, activation and
    residual (after the activation): x (B, H, C, W), w (3, 3, C, Co) →
    (B, H, Co, W) in x's dtype."""
    return _conv(3, x, w, b, residual, act)


def conv1x1_planar(x, w, b=None, residual=None, act: Optional[str] = "silu") -> torch.Tensor:
    """1×1 conv on planar x (a per-row (Co, C) × (C, W) product) with the
    same contract: w (1, 1, C, Co) or (C, Co)."""
    return _conv(1, x, w, b, residual, act)

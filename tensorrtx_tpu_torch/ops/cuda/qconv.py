"""Int8 convs of the chained int8 tier: the CUDA kernels `csrc/qconv.cu`
and their plain PyTorch versions.

Replace the TPU kernels `tensorrtx_tpu/ops/pallas/qconv.py::qconv3x3` and
`::qconv1x1`. The JAX package sends only the shapes its gate admits to
them and computes the other int8 convs of the chain with XLA's int8 conv;
PyTorch has no int8×int8→int32 convolution on CUDA, so here the two
kernels serve every int8 conv of the chain, 3×3 at stride 1 or 2 and 1×1,
at any channel count, both on the int8 tensor cores (``mma.sync``
m16n8k32): the 1×1 as the GEMM (B·H·W, C) × (C, Co), the 3×3 as the
implicit GEMM (B·Ho·Wo, 9·C) × (9·C, Co) over its taps. The contract is the JAX producer contract
(`ops/qchain.py` ``ChainCtx.conv``/``conv_add``/``conv_out``):

    o = float(Σ x·w) · scale + bias  (+ float(res) · res_scale)
    out = clip(round(act(o) / s_out), ±127) as int8, or act(o) as float

Layouts: activations int8 NHWC (B, H, W, C), contiguous; weights int8
OHWI (Co, k, k, C), contiguous; ``scale``/``bias`` float32 (Co,);
``s_out``/``res_scale`` 0-d float32 tensors (or Python floats).

The wrappers launch the kernel for CUDA tensors and raise if they cannot;
they take the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tensorrtx_tpu_torch.ops.cuda import build

__all__ = ["qconv3x3", "qconv1x1", "qconv_plain", "act_f", "requant",
           "launches_3x3", "launches_1x1"]

# Launches of each CUDA kernel in this process (not of the plain version).
launches_3x3 = 0
launches_1x1 = 0

_ACTS = {None: 0, "silu": 1, "relu": 2}
_OUT_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}

_fns = {}


def act_f(o: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The chain's activation in the JAX form: SiLU as ``o * sigmoid(o)``
    (not F.silu, which may round differently), ReLU as ``max(o, 0)``."""
    if act == "silu":
        return o * torch.sigmoid(o)
    if act == "relu":
        return torch.clamp_min(o, 0.0)
    if act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return o


def requant(o: torch.Tensor, s_out) -> torch.Tensor:
    """float → int8 at scale s_out: true division, round half to even,
    saturate to ±127."""
    return torch.clamp(torch.round(o / s_out), -127, 127).to(torch.int8)


def _scalar(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def qconv_plain(xq, wq, scale, bias, s_out, act="silu", residual=None,
                res_scale=None, out_float=False, out_dtype=torch.bfloat16,
                stride: int = 1) -> torch.Tensor:
    """The kernels' contract in plain torch ops. The int32 sum is a float64
    conv of the int8 values, exact (|acc| ≤ 127²·9·C < 2⁵³) and rounded to
    the integer it is; the epilogue runs in float32 in the kernel's order."""
    k = wq.shape[1]
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=k // 2)
    acc = torch.round(acc).to(torch.int32).to(torch.float32).permute(0, 2, 3, 1)
    o = acc * scale
    if bias is not None:
        o = o + bias
    if residual is not None:
        o = o + residual.to(torch.float32) * _scalar(res_scale, o.device)
    o = act_f(o, act)
    if out_float:
        return o.to(out_dtype).contiguous()
    return requant(o, _scalar(s_out, o.device)).contiguous()


def _launcher(k: int):
    fn = _fns.get(k)
    if fn is None:
        lib = build.load("qconv")
        if k == 3:
            fn = lib.qconv3x3_launch
            n_int = 8      # out_kind, act, B, H, W, C, Co, stride, then vec
        else:
            fn = lib.qconv1x1_launch
            n_int = 7
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * (n_int + 1)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[k] = fn
    return fn


def _check(xq, wq, scale, bias, residual, k, stride, out_float, out_dtype):
    if xq.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"xq must be (B, H, W, C) and wq (Co, k, k, C), got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    b, h, w, c = xq.shape
    co = wq.shape[0]
    if tuple(wq.shape[1:]) != (k, k, c):
        raise ValueError(f"wq must be ({co}, {k}, {k}, {c}) OHWI, got {tuple(wq.shape)}")
    if stride not in ((1, 2) if k == 3 else (1,)):
        raise ValueError(f"no {k}x{k} kernel for stride {stride}")
    for name, t, dt in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                        ("scale", scale, torch.float32), ("bias", bias, torch.float32),
                        ("residual", residual, torch.int8)):
        if t is None:
            continue
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (co,):
            raise ValueError(f"{name} must be ({co},), got {tuple(t.shape)}")
    p = k // 2
    ho, wo = (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1
    if residual is not None and tuple(residual.shape) != (b, ho, wo, co):
        raise ValueError(f"residual must be {(b, ho, wo, co)}, got {tuple(residual.shape)}")
    if out_float and out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"float exit must be float32 or bfloat16, got {out_dtype}")
    return b, h, w, c, co, ho, wo


def _qconv(k, xq, wq, scale, bias, s_out, act, residual, res_scale, out_float,
           out_dtype, stride):
    global launches_3x3, launches_1x1
    b, h, w, c, co, ho, wo = _check(xq, wq, scale, bias, residual, k, stride,
                                    out_float, out_dtype)
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if xq.device.type == "cpu":
        return qconv_plain(xq, wq, scale, bias, s_out, act, residual, res_scale,
                           out_float, out_dtype, stride)
    if xq.device.type != "cuda":
        raise ValueError(f"no qconv kernel for device {xq.device}")
    dev = xq.device
    odt = out_dtype if out_float else torch.int8
    out = torch.empty((b, ho, wo, co), dtype=odt, device=dev)
    so = None if out_float else _scalar(s_out, dev)
    rs = None if residual is None else _scalar(res_scale, dev)
    # vec: the 1×1 may copy 16-byte chunks; the 3×3 may copy words, and
    # picks 16- or 8-byte copies itself from C and the pointers; else byte by byte
    align = 4 if k == 3 else 16
    vec = int(c % align == 0 and xq.data_ptr() % align == 0 and wq.data_ptr() % align == 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = [ptr(xq), ptr(wq), ptr(scale), ptr(bias), ptr(so), ptr(residual),
            ptr(rs), out.data_ptr(), _OUT_KINDS[odt], _ACTS[act], b, h, w, c, co]
    if k == 3:
        args.append(stride)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(k)(*args, vec, stream)
    if err != 0:
        raise RuntimeError(f"qconv{k}x{k} kernel launch failed: cudaError {err}")
    if k == 3:
        launches_3x3 += 1
    else:
        launches_1x1 += 1
    return out


def qconv3x3(xq, wq, scale, bias, s_out, act="silu", residual=None,
             res_scale=None, out_float=False, out_dtype=torch.bfloat16,
             stride: int = 1) -> torch.Tensor:
    """3×3 SAME conv (padding 1, stride 1 or 2) on int8 NHWC with the fused
    epilogue. xq (B, H, W, C) int8; wq (Co, 3, 3, C) int8; scale (Co,)
    float32 = s_in·s_w; bias (Co,) float32 or None; s_out the requant
    scale (ignored when out_float). residual: optional int8 (B, Ho, Wo, Co)
    with scale res_scale, added before the activation. Returns int8
    (B, Ho, Wo, Co), or out_dtype when out_float."""
    return _qconv(3, xq, wq, scale, bias, s_out, act, residual, res_scale,
                  out_float, out_dtype, stride)


def qconv1x1(xq, wq, scale, bias, s_out, act="silu", residual=None,
             res_scale=None, out_float=False, out_dtype=torch.bfloat16) -> torch.Tensor:
    """1×1 conv on int8 NHWC with the same contract: wq (Co, 1, 1, C)."""
    return _qconv(1, xq, wq, scale, bias, s_out, act, residual, res_scale,
                  out_float, out_dtype, 1)

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

Layouts: activations NHWC (B, H, W, C) with the channels at stride 1 and
a pixel stride P = ``x.stride(2)`` ≥ C (rows W·P, images H·W·P apart), so
a channel slice of a wider NHWC map (or of a ``channels_last`` NCHW map,
viewed as NHWC) is read where it lies; weights int8 OHWI (Co, k, k, C),
contiguous; ``scale``/``bias`` float32 (Co,); ``s_out``/``res_scale``/``sx``
0-d float32 tensors (or Python floats).

The source is int8, or bfloat16 / float32 with its 0-d scale ``sx`` (the
float-resident tier), quantized by the division form ``clip(round(x /
sx), ±127)`` (`ops/cuda/quantize.py` ``quantize_int8(x, sx,
divide=True)``, with no division per element: `csrc/quant_math.cuh`),
bit-equal to quantizing first, and with no activation (the tier applies its
own): the 1×1 kernel quantizes while it stages each K slice; the 3×3 is
given the int8 map that ``quantize_int8`` makes of x (read where it lies, a
channel slice included), since its gather reads each pixel nine times.

The wrappers launch the kernel for CUDA tensors and raise if they cannot;
they take the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tensorrtx_tpu_torch.ops.cuda import build
from tensorrtx_tpu_torch.ops.cuda.quantize import _scalar, quantize_int8, quantize_int8_plain

__all__ = ["qconv3x3", "qconv1x1", "qconv_plain", "act_f", "requant",
           "launches_3x3", "launches_1x1", "launches_1x1_fq"]

# Launches of each CUDA kernel in this process (not of the plain version):
# from an int8 source, and (the 1×1) from a float source it quantizes itself.
# A float source's 3×3 counts one `quantize.launches` and one launches_3x3.
# A launch captured into a CUDA graph counts once, when it is captured;
# the graph's replays launch it again without counting.
launches_3x3 = 0
launches_1x1 = 0
launches_1x1_fq = 0

_ACTS = {None: 0, "silu": 1, "relu": 2}
_OUT_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_SRC_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

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
        fn = getattr(build.load("qconv"), f"qconv{k}x{k}_launch")
        # x, (1×1: sx,) w, scale, bias, s_out, res, res_scale, out; (1×1:
        # src_kind,) pixel_stride, out_kind, act, B, H, W, C, Co (3×3: stride); stream
        fn.argtypes = ([ctypes.c_void_p] * (8 if k == 3 else 9) + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[k] = fn
    return fn


def _pixel_stride(x) -> int:
    """P of an NHWC view whose pixels are P elements apart: channels at
    stride 1, rows W·P and images H·W·P apart (a dimension of size 1 may
    have any stride). Raises for any other layout: the kernels do not copy."""
    b, h, w, c = x.shape
    p = x.stride(2) if w > 1 else c
    if not ((c == 1 or x.stride(3) == 1) and p >= c and (h == 1 or x.stride(1) == w * p)
            and (b == 1 or x.stride(0) == h * w * p)):
        raise ValueError(f"x (B, H, W, C) = {tuple(x.shape)} with strides {x.stride()} is not "
                         "an NHWC map with the channels at stride 1 and one pixel stride")
    return p


def _check(x, wq, scale, bias, residual, k, stride, act, out_float, out_dtype, sx):
    if x.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C) and wq (Co, k, k, C), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    b, h, w, c = x.shape
    co = wq.shape[0]
    if tuple(wq.shape[1:]) != (k, k, c):
        raise ValueError(f"wq must be ({co}, {k}, {k}, {c}) OHWI, got {tuple(wq.shape)}")
    if stride not in ((1, 2) if k == 3 else (1,)):
        raise ValueError(f"no {k}x{k} kernel for stride {stride}")
    if x.dtype not in _SRC_KINDS:
        raise TypeError(f"x must be int8, bfloat16 or float32, got {x.dtype}")
    if (x.dtype == torch.int8) != (sx is None):
        raise TypeError("an int8 x takes no sx; a float x needs its scale sx"
                        f" (x {x.dtype}, sx {'None' if sx is None else 'given'})")
    if sx is not None and act is not None:
        raise ValueError(f"a float x (with sx) takes no activation, got {act!r}")
    for name, t, dt in (("wq", wq, torch.int8), ("scale", scale, torch.float32),
                        ("bias", bias, torch.float32), ("residual", residual, torch.int8)):
        if t is None:
            continue
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
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
    return b, h, w, c, co, ho, wo, _pixel_stride(x)


def _qconv(k, x, wq, scale, bias, s_out, act, residual, res_scale, out_float,
           out_dtype, stride, sx):
    global launches_3x3, launches_1x1, launches_1x1_fq
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    b, h, w, c, co, ho, wo, pix = _check(x, wq, scale, bias, residual, k, stride, act,
                                         out_float, out_dtype, sx)
    if x.device.type == "cpu":
        xq = x if sx is None else quantize_int8_plain(x, sx, divide=True)
        return qconv_plain(xq, wq, scale, bias, s_out, act, residual, res_scale,
                           out_float, out_dtype, stride)
    if x.device.type != "cuda":
        raise ValueError(f"no qconv kernel for device {x.device}")
    if k == 3 and sx is not None:   # the int8 map first, then the int8-source 3×3
        x, sx, pix = quantize_int8(x, sx, divide=True), None, c
    dev = x.device
    odt = out_dtype if out_float else torch.int8
    out = torch.empty((b, ho, wo, co), dtype=odt, device=dev)
    so = None if out_float else _scalar(s_out, dev)
    rs = None if residual is None else _scalar(res_scale, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    tail = [ptr(wq), ptr(scale), ptr(bias), ptr(so), ptr(residual), ptr(rs), out.data_ptr()]
    dims = [pix, _OUT_KINDS[odt], _ACTS[act], b, h, w, c, co]
    if k == 3:
        args = [ptr(x)] + tail + dims + [stride]
    else:
        sxd = None if sx is None else _scalar(sx, dev)
        args = [ptr(x), ptr(sxd)] + tail + [_SRC_KINDS[x.dtype]] + dims
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher(k)(*args, stream)
    if err != 0:
        raise RuntimeError(f"qconv{k}x{k} kernel launch failed: cudaError {err}")
    if k == 3:
        launches_3x3 += 1
    elif sx is None:
        launches_1x1 += 1
    else:
        launches_1x1_fq += 1
    return out


def qconv3x3(x, wq, scale, bias, s_out, act="silu", residual=None,
             res_scale=None, out_float=False, out_dtype=torch.bfloat16,
             stride: int = 1, sx=None) -> torch.Tensor:
    """3×3 SAME conv (padding 1, stride 1 or 2) on NHWC with the fused
    epilogue. x (B, H, W, C): int8, or bfloat16 / float32 quantized at the
    0-d scale ``sx`` (then required, and act None; see the module
    docstring), channels at stride 1 and one pixel stride; wq (Co, 3, 3, C)
    int8; scale (Co,) float32 = s_in·s_w; bias (Co,) float32 or None; s_out
    the requant scale (ignored when out_float). residual: optional int8
    (B, Ho, Wo, Co) with scale res_scale, added before the activation.
    Returns int8 (B, Ho, Wo, Co), or out_dtype when out_float."""
    return _qconv(3, x, wq, scale, bias, s_out, act, residual, res_scale,
                  out_float, out_dtype, stride, sx)


def qconv1x1(x, wq, scale, bias, s_out, act="silu", residual=None,
             res_scale=None, out_float=False, out_dtype=torch.bfloat16,
             sx=None) -> torch.Tensor:
    """1×1 conv on NHWC with the same contract: wq (Co, 1, 1, C)."""
    return _qconv(1, x, wq, scale, bias, s_out, act, residual, res_scale,
                  out_float, out_dtype, 1, sx)

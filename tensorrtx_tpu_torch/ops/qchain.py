"""Int8-resident chained quantization: activations cross device memory as
int8 between the convs of a chain.

The port of the JAX package's `tensorrtx_tpu/ops/qchain.py`. Every conv of
the chain is int8×int8→int32 with a fused dequant + bias + activation +
requant epilogue (the structure inside a TensorRT int8 engine), computed by
the CUDA kernels of `ops/cuda/qconv.py` for tensors on the card and by
their plain versions for tensors on the CPU.

A `ChainCtx` threads through a *chain mirror* of a model's forward (e.g.
`models/yolo11.apply_chain`). The same mirror runs in two modes, so the
scale and weight slots line up by construction:

  tap   float forward; records the |x|max of every produced activation, in
        slot order (the calibration pass), and every conv weight
  run   int8-resident forward on the pre-quantized weights and the
        calibrated scale table

Tensors stay in the JAX package's NHWC layout: a float tap-mode tensor is
(B, H, W, C) and so is the int8 payload of a `QTensor`, contiguous. That is
the memory of an NCHW ``channels_last`` tensor, so convs and float islands
see it through ``permute(0, 3, 1, 2)`` without a copy. Conv weights arrive
as the port's modules hold them (OIHW); the quantized ones are OHWI, the
kernels' layout. Activations use symmetric per-tensor scales, weights
per-output-channel scales. Max-pool, nearest upsample and channel split run
on the int8 payload and are exact; float islands dequantize in and
requantize out.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tensorrtx_tpu_torch.ops.cuda import qconv as _qc

__all__ = ["QTensor", "ChainCtx", "quantize_chain_weights", "upsample_nearest_nhwc"]

f32 = torch.float32


class QTensor(NamedTuple):
    """Symmetric-int8 activation: value ≈ q · s (zero point 0)."""
    q: torch.Tensor      # int8 payload, (B, H, W, C) contiguous
    s: torch.Tensor      # 0-d float32 scale, on q's device


def _rq(o: torch.Tensor, s_out) -> torch.Tensor:
    """float32 → int8 at scale s_out (round half to even, saturate)."""
    return _qc.requant(o, s_out).contiguous()


_act_f = _qc.act_f


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def upsample_nearest_nhwc(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest upsample of an NHWC tensor of any dtype (int8 included,
    which F.interpolate does not take)."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


class ChainCtx:
    """Mode-polymorphic op context for int8-resident chain mirrors.

    tap mode: call with float NHWC tensors; `taps` fills with the |x|max of
    every produced activation (in slot order, 0-d float32 tensors) and `ws`
    with every conv weight (OIHW, as given). run mode: call with
    `QTensor`s; consumes `scales` (float32 (S,) tensor on the device),
    `wq` (int8 OHWI, or the float OIHW weight of a depthwise conv) and `sw`
    (float32 (Co,) weight scales) in the same slot order. `dtype` is the
    float islands' type (the float-exit convs' output and the depthwise
    convs' compute type).

    The int8 convs go to `ops/cuda/qconv.py`: the CUDA kernels for tensors
    on the card, their plain versions for tensors on the CPU.
    """

    # The chain's entry point: "m3" leaves the large-map stem of the model
    # in float and starts the chain where the channel count grows (the JAX
    # package's default); "stem" (chain from the first conv) is not ported.
    DEFAULT_ENTER = "m3"

    def __init__(self, mode: str, scales=None, wq: Optional[List] = None,
                 sw: Optional[List] = None, dtype=torch.bfloat16,
                 enter: str = DEFAULT_ENTER):
        if mode not in ("tap", "run"):
            raise ValueError(f"mode must be 'tap' or 'run', got {mode!r}")
        if enter == "stem":
            raise NotImplementedError("enter='stem' is not ported; the chain "
                                      "enters at 'm3'")
        if enter != "m3":
            raise ValueError(f"unknown chain entry {enter!r}")
        self.mode = mode
        self.scales = scales
        self.wq = wq
        self.sw = sw
        self.enter = enter
        self.dtype = dtype
        self.taps: List[torch.Tensor] = []
        self.ws: List[torch.Tensor] = []
        self.w_is_dw: List[bool] = []   # tap mode: which ws are depthwise
        self._si = 0
        self._wi = 0

    # -- slot bookkeeping ---------------------------------------------------
    def _next_scale(self) -> torch.Tensor:
        i = self._si
        self._si += 1
        return self.scales[i]

    def _tap(self, x):
        self._si += 1
        self.taps.append(x.detach().to(f32).abs().amax())

    def _next_w(self):
        i = self._wi
        self._wi += 1
        return self.wq[i], self.sw[i]

    def _record_w(self, w, is_dw: bool):
        self.ws.append(w)
        self.w_is_dw.append(is_dw)
        self._wi += 1

    @property
    def n_scales(self) -> int:
        return self._si

    # -- tap-mode float conv ------------------------------------------------
    @staticmethod
    def _conv_f(x, w, b, stride=1, groups=1):
        """Float conv of an NHWC tensor with an OIHW weight, in x's dtype,
        then bias in float32 (the JAX tap pass: conv in x.dtype, then
        ``.astype(f32) + b``)."""
        o = F.conv2d(_nchw(x), w.to(x.dtype), stride=stride,
                     padding=w.shape[-1] // 2, groups=groups)
        o = _nhwc(o).to(f32)
        if b is not None:
            o = o + b.to(f32)
        return o

    # -- ops ----------------------------------------------------------------
    def quant_in(self, x):
        """Float activation → QTensor (one scale slot)."""
        if self.mode == "tap":
            self._tap(x)
            return x
        s = self._next_scale()
        return QTensor(_rq(x.to(f32), s), s)

    def _qconv(self, x: QTensor, wq, sw, b, s_out, act, stride=1, residual=None,
               out_float=False):
        k = wq.shape[1]
        scale = x.s * sw
        bias = None if b is None else b.to(f32).contiguous()
        kw = dict(act=act, out_float=out_float, out_dtype=self.dtype)
        if residual is not None:
            kw.update(residual=residual.q, res_scale=residual.s)
        if k == 3:
            return _qc.qconv3x3(x.q, wq, scale, bias, s_out, stride=stride, **kw)
        if k == 1 and stride == 1:
            return _qc.qconv1x1(x.q, wq, scale, bias, s_out, **kw)
        raise ValueError(f"no int8 kernel for a {k}x{k} conv at stride {stride}")

    def conv(self, x, w, b=None, act: Optional[str] = "silu", stride: int = 1):
        """conv + bias + act, requantized to this tensor's calibrated scale
        (padding k//2). w is the float OIHW weight (read in tap mode)."""
        if self.mode == "tap":
            self._record_w(w, False)
            o = _act_f(self._conv_f(x, w, b, stride), act)
            self._tap(o)
            return o.to(x.dtype)
        wq, sw = self._next_w()
        s_out = self._next_scale()
        return QTensor(self._qconv(x, wq, sw, b, s_out, act, stride), s_out)

    def conv_add(self, x, w, b, res, act: Optional[str] = "relu", stride: int = 1):
        """conv + bias + residual + act, requantized (one scale slot for the
        fused output); `res` is a chain tensor."""
        if self.mode == "tap":
            self._record_w(w, False)
            o = _act_f(self._conv_f(x, w, b, stride) + res.to(f32), act)
            self._tap(o)
            return o.to(x.dtype)
        wq, sw = self._next_w()
        s_out = self._next_scale()
        return QTensor(self._qconv(x, wq, sw, b, s_out, act, stride, residual=res),
                       s_out)

    def conv_out(self, x, w, b=None, act: Optional[str] = None):
        """Chain exit conv: int8 product, float output in `dtype` (no
        requant slot)."""
        if self.mode == "tap":
            self._record_w(w, False)
            return _act_f(self._conv_f(x, w, b), act).to(self.dtype)
        wq, sw = self._next_w()
        return self._qconv(x, wq, sw, b, None, act, out_float=True)

    def dwconv(self, x, w, b=None, act: Optional[str] = "silu", stride: int = 1):
        """Depthwise conv: float (int8 gains nothing there, the per-layer
        fallback TensorRT uses too), requantized out. The stored weight is
        the float OIHW (C, 1, k, k) one."""
        groups = w.shape[0]
        if self.mode == "tap":
            self._record_w(w, True)
            o = _act_f(self._conv_f(x, w, b, stride, groups), act)
            self._tap(o)
            return o.to(x.dtype)
        wd, _ = self._next_w()
        s_out = self._next_scale()
        xf = (x.q.to(f32) * x.s).to(self.dtype)
        o = F.conv2d(_nchw(xf), wd.to(self.dtype), stride=stride,
                     padding=wd.shape[-1] // 2, groups=groups)
        o = _nhwc(o).to(f32)
        if b is not None:
            o = o + b.to(f32)
        return QTensor(_rq(_act_f(o, act), s_out), s_out)

    def concat(self, xs: Sequence):
        """Channel concat; the segments requantize to one shared scale slot,
        each as round(q · (s / s_out)) with the ratio taken first."""
        if self.mode == "tap":
            o = torch.cat(list(xs), dim=-1)
            self._tap(o)
            return o
        s_out = self._next_scale()
        parts = [torch.clamp(torch.round(x.q.to(f32) * (x.s / s_out)), -127, 127
                             ).to(torch.int8) for x in xs]
        return QTensor(torch.cat(parts, dim=-1), s_out)

    def add(self, a, b):
        """Residual add (bottleneck shortcut); one scale slot."""
        if self.mode == "tap":
            o = a + b
            self._tap(o)
            return o
        s_out = self._next_scale()
        o = a.q.to(f32) * a.s + b.q.to(f32) * b.s
        return QTensor(_rq(o, s_out), s_out)

    def maxpool(self, x, k: int, stride: int = 1, pad: Optional[int] = None):
        """Max-pool; on the payload it is exact. The JAX package pads the
        int8 payload with −128; a float copy padded with −inf gives the same
        result, because every window holds a real element."""
        p = k // 2 if pad is None else pad
        if self.mode == "tap":
            return _nhwc(F.max_pool2d(_nchw(x), k, stride, p)).contiguous()
        o = F.max_pool2d(_nchw(x.q).to(f32), k, stride, p)
        return QTensor(_nhwc(o).to(torch.int8).contiguous(), x.s)

    def upsample(self, x, factor: int = 2):
        """Nearest upsample on the payload — exact."""
        if self.mode == "tap":
            return upsample_nearest_nhwc(x, factor)
        return QTensor(upsample_nearest_nhwc(x.q, factor), x.s)

    def avgpool2_s1(self, x):
        """k=2 s=1 average pool (the GELAN ADown/AConv prefix). Linear, so
        it runs on the payload: the int32 window sum is exact and the ÷4
        re-rounds onto the same scale, no new slot."""
        if self.mode == "tap":
            return _nhwc(F.avg_pool2d(_nchw(x), 2, 1)).contiguous()
        q = x.q.to(torch.int32)
        acc = q[:, :-1, :-1] + q[:, :-1, 1:] + q[:, 1:, :-1] + q[:, 1:, 1:]
        q = torch.clamp(torch.round(acc.to(f32) * 0.25), -127, 127).to(torch.int8)
        return QTensor(q.contiguous(), x.s)

    def add_n(self, xs: Sequence):
        """Sum of N chain tensors (CBFuse); one shared scale slot."""
        if self.mode == "tap":
            o = xs[0]
            for x in xs[1:]:
                o = o + x
            self._tap(o)
            return o
        s_out = self._next_scale()
        o = xs[0].q.to(f32) * xs[0].s
        for x in xs[1:]:
            o = o + x.q.to(f32) * x.s
        return QTensor(_rq(o, s_out), s_out)

    def split(self, x, sizes: Sequence[int]):
        """Static channel split — same scale. The parts are contiguous
        copies, the layout the int8 kernels take."""
        offs = np.cumsum([0] + list(sizes))
        if self.mode == "tap":
            return [x[..., offs[i]:offs[i + 1]] for i in range(len(sizes))]
        return [QTensor(x.q[..., offs[i]:offs[i + 1]].contiguous(), x.s)
                for i in range(len(sizes))]

    def map_q(self, x, fn):
        """Apply a pure reindexing to the payload."""
        if self.mode == "tap":
            return fn(x)
        return QTensor(fn(x.q).contiguous(), x.s)

    def to_float(self, x):
        """Dequantize (enter a float island or the decode tail)."""
        if self.mode == "tap":
            return x
        return (x.q.to(f32) * x.s).to(self.dtype)

    def from_float(self, x):
        """Re-enter the chain after a float island (one scale slot)."""
        return self.quant_in(x)


def quantize_chain_weights(ws: List[torch.Tensor], dw_flags: List[bool]):
    """Per-output-channel int8 weights and scales for a collected (OIHW)
    weight list: int8 OHWI, the kernels' layout, and float32 (Co,) scales
    ``max(|w|max / 127, 1e-8)``. Depthwise entries stay float (OIHW in
    bfloat16, as the JAX package keeps them); their scale is a placeholder
    of ones. Returns (wq, sw) as CPU tensors."""
    wq, sw = [], []
    for w, is_dw in zip(ws, dw_flags):
        w = w.detach().to("cpu", f32)
        if is_dw:
            wq.append(w.to(torch.bfloat16).contiguous())
            sw.append(torch.ones(w.shape[0], dtype=f32))
            continue
        wn = w.permute(0, 2, 3, 1).numpy()                    # OHWI
        s = np.maximum(np.abs(wn).max(axis=(1, 2, 3)) / np.float32(127.0),
                       np.float32(1e-8)).astype(np.float32)
        q = np.clip(np.round(wn / s[:, None, None, None]), -127, 127).astype(np.int8)
        wq.append(torch.from_numpy(np.ascontiguousarray(q)))
        sw.append(torch.from_numpy(s))
    return wq, sw

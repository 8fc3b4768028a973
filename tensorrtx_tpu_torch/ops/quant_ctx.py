"""Per-conv quantization slots of the float-resident int8 tier.

The port of the JAX package's `tensorrtx_tpu/ops/quant_ctx.py` and of the
quantization branch of its `ops/nn.conv2d` (`nn.py:75-114`). There a
module-global ``STATE`` threads through every `conv2d` call and each conv
takes its index by trace order. Here the state is explicit: each conv
module of an int8 engine's copy of the network holds a `ConvSlot` (its
index in the call order of one forward, see `core/quant.py`), and what a
slot does depends on what the engine put in it:

  taps   a `Taps` object, attached for one calibration forward: the conv
         records a statistic of its input (|x|max in float32, or a
         2048-bin histogram of |x|) under its index, then runs in float
  run    the int8 weight (OHWI), the float32 (Co,) scale sx·sw and the 0-d
         activation scale sx: the conv quantizes its input (x / sx, round
         half to even, ±127), runs the int8×int8→int32 conv and leaves it
         as ``acc·(sx·sw) + b`` in the input's dtype
  empty  the float conv

A depthwise conv has a slot too, so the indices line up with the JAX
package's scale table, but it stays in float in run mode (`nn.py:89-92`).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tensorrtx_tpu_torch.ops import nn as ops
from tensorrtx_tpu_torch.ops.cuda import qconv as _qc

__all__ = ["ConvSlot", "Taps", "abs_histogram", "quant_conv2d"]


def abs_histogram(xa: torch.Tensor, hi: float, bins: int) -> torch.Tensor:
    """``jnp.histogram(xa, bins, range=(0, hi))[0]`` for a float32 tensor of
    |x| values: float32 counts over edges ``linspace(0, hi, bins + 1)`` as
    JAX forms them in float32 (``hi · (i / bins)``, the last edge hi), each
    value in the bin ``searchsorted(edges, v, side="right")`` names, a value
    equal to the last edge counted in the last bin, values above hi
    dropped. (`torch.histc` bins by ``(v − lo)·n/(hi − lo)`` and can place
    a value that sits on an edge in the other bin.)"""
    dev = xa.device
    top = torch.tensor(hi, dtype=torch.float32, device=dev)
    steps = torch.arange(bins, dtype=torch.float32, device=dev) / bins
    edges = torch.cat([top * steps, top[None]])
    flat = xa.reshape(-1)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1].float()


class Taps:
    """The calibration statistics of one forward, by slot index: the
    input's |x|max (``hist_ranges`` None) or its ``bins``-bin histogram of
    |x| over [0, max(hist_ranges[i], 1e-8)]."""

    def __init__(self, n: int, hist_ranges, bins: int):
        self.values: List[Optional[torch.Tensor]] = [None] * n
        self.hist_ranges = hist_ranges
        self.bins = bins

    def record(self, i: int, x: torch.Tensor) -> None:
        xa = x.float().abs()
        if self.hist_ranges is None:
            self.values[i] = xa.amax()
        else:
            self.values[i] = abs_histogram(xa, max(float(self.hist_ranges[i]), 1e-8),
                                           self.bins)


def quant_conv2d(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, sx: torch.Tensor,
                 bias: torch.Tensor, stride: int) -> torch.Tensor:
    """The tier's int8 conv (`nn.py:97-114`) on an NCHW x: quantize x at sx
    by division, int8×int8→int32 conv with OHWI ``wq`` (padding k//2), then
    ``acc·scale + bias`` in float32 (scale = sx·sw), cast to x's dtype.
    x's NHWC view is read where it lies: a ``channels_last`` map, or a
    channel slice of one, with its pixel stride (no copy; any other layout
    raises). The 1×1 kernel quantizes it while it stages it; a 3×3 is
    given the int8 map that one `quantize_int8` launch makes of it.
    Returns the NCHW view of the kernels' NHWC output (``channels_last``
    memory, no copy)."""
    kw = dict(act=None, out_float=True, out_dtype=x.dtype, sx=sx)
    xh = x.permute(0, 2, 3, 1)
    if wq.shape[1] == 3:
        y = _qc.qconv3x3(xh, wq, scale, bias, None, stride=stride, **kw)
    else:
        y = _qc.qconv1x1(xh, wq, scale, bias, None, **kw)
    return y.permute(0, 3, 1, 2)


class ConvSlot:
    """One conv's place in the int8 tier: its index in the call order,
    whether it is depthwise, and what the engine attached (see the module
    docstring)."""

    def __init__(self, index: int, depthwise: bool):
        self.index = index
        self.depthwise = depthwise
        self.taps: Optional[Taps] = None
        self.wq = self.scale = self.sx = self.bias = None

    def set_run(self, wq: torch.Tensor, scale: torch.Tensor, sx: torch.Tensor,
                bias: torch.Tensor) -> None:
        """Install the int8 weight (Co, k, k, C), the float32 (Co,) scale
        sx·sw, the 0-d float32 sx and the float32 (Co,) bias."""
        self.wq, self.scale, self.sx, self.bias = wq, scale, sx, bias

    def conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
             pad: int) -> torch.Tensor:
        if self.taps is not None:
            self.taps.record(self.index, x)
        if self.wq is None:
            return ops.conv2d(x, w, b, stride=stride, padding=pad)
        return quant_conv2d(x, self.wq, self.scale, self.sx, self.bias, stride)

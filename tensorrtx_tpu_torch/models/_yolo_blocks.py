"""Shared YOLO block library (ultralytics family): numpy param builders and
the blocks as `nn.Module`s.

The builders (`*_p`) are the JAX package's (tensorrtx_tpu/models/
_yolo_blocks.py): BN folded into the conv at build time, HWIO numpy, names
of the ultralytics state_dict (``model.2.cv1.conv.weight``). The modules are
built from the same tree after `core.convert.params_from_jax` turned it into
OIHW tensors; each takes its structure from the tree, as the JAX apply
functions do, so module names mirror the tree's keys (``m.0.cv1.w``). The
reference blocks are yolo11/src/block.cpp: convBnSiLU:74, bottleneck:96,
SPPF:113, C3k:220, C3K2:239, Attention:293, PSABlock:357, C2PSA:380, and
yolov8/src/block.cpp's C2F (a C3K2 of plain bottlenecks) and YOLOv5's C3
(a C3k with 1×3 bottlenecks).

Only the plain graph is ported; the JAX package's TPU layout rewrites of it
(space-to-depth, row-phase, batch-fold) compute the same values.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tensorrtx_tpu_torch.ops import nn as ops

BN_EPS = 1e-3  # ultralytics BatchNorm2d eps (block.cpp:89 addBatchNorm2d 1e-3)


def get_width(x: int, gw: float, max_channels: int, divisor: int = 8) -> int:
    """Channel scaling (yolo11/src/model.cpp:9-13)."""
    ch = min(x, max_channels)
    return int(math.ceil(ch * gw / divisor)) * divisor


def get_depth(x: int, gd: float) -> int:
    """Depth scaling with round-half-to-even (yolo11/src/model.cpp:15-22)."""
    if x == 1:
        return 1
    return max(int(round(x * gd)), 1)


# ---------------------------------------------------------------------------
# param builders (numpy HWIO, byte-equal to the JAX package's)
# ---------------------------------------------------------------------------

def conv_p(wm, name: str, c1: int, c2: int, k: int = 1, groups: int = 1):
    return wm.conv_bn(f"{name}.conv", f"{name}.bn", c2, c1, (k, k),
                      groups=groups, eps=BN_EPS)


def bottleneck_p(wm, name, c1, c2, k1=3, k2=3, e=0.5):
    c_ = int(c2 * e)
    return {
        "cv1": conv_p(wm, f"{name}.cv1", c1, c_, k1),
        "cv2": conv_p(wm, f"{name}.cv2", c_, c2, k2),
    }


def c3k_p(wm, name, c1, c2, n=2, e=0.5):
    c_ = int(c2 * e)
    return {
        "cv1": conv_p(wm, f"{name}.cv1", c1, c_),
        "cv2": conv_p(wm, f"{name}.cv2", c1, c_),
        "cv3": conv_p(wm, f"{name}.cv3", 2 * c_, c2),
        "m": [bottleneck_p(wm, f"{name}.m.{i}", c_, c_, e=1.0) for i in range(n)],
    }


def c3_p(wm, name, c1, c2, n, e=0.5):
    """YOLOv5 C3: bottlenecks use k=(1,3), e=1.0 (ultralytics C3 default)."""
    c_ = int(c2 * e)
    return {
        "cv1": conv_p(wm, f"{name}.cv1", c1, c_),
        "cv2": conv_p(wm, f"{name}.cv2", c1, c_),
        "cv3": conv_p(wm, f"{name}.cv3", 2 * c_, c2),
        "m": [bottleneck_p(wm, f"{name}.m.{i}", c_, c_, k1=1, k2=3, e=1.0)
              for i in range(n)],
    }


def c3k2_p(wm, name, c1, c2, n, c3k: bool, e=0.5):
    c_ = int(c2 * e)
    blocks = []
    for i in range(n):
        if c3k:
            blocks.append(c3k_p(wm, f"{name}.m.{i}", c_, c_, n=2))
        else:
            blocks.append(bottleneck_p(wm, f"{name}.m.{i}", c_, c_, k1=3, k2=3, e=0.5))
    return {
        "cv1": conv_p(wm, f"{name}.cv1", c1, 2 * c_),
        "cv2": conv_p(wm, f"{name}.cv2", (2 + n) * c_, c2),
        "m": blocks,
    }


def c2f_p(wm, name, c1, c2, n, e=0.5):
    """YOLOv8 C2f (yolov8/src/block.cpp): the C3k2 split/append pattern
    with bottlenecks of k=(3,3), e=1.0."""
    c_ = int(c2 * e)
    return {
        "cv1": conv_p(wm, f"{name}.cv1", c1, 2 * c_),
        "cv2": conv_p(wm, f"{name}.cv2", (2 + n) * c_, c2),
        "m": [bottleneck_p(wm, f"{name}.m.{i}", c_, c_, k1=3, k2=3, e=1.0)
              for i in range(n)],
    }


def sppf_p(wm, name, c1, c2):
    c_ = c1 // 2
    return {
        "cv1": conv_p(wm, f"{name}.cv1", c1, c_),
        "cv2": conv_p(wm, f"{name}.cv2", c_ * 4, c2),
    }


def attention_p(wm, name, dim, num_heads, attn_ratio=0.5):
    head_dim = dim // num_heads
    key_dim = int(head_dim * attn_ratio)
    h = dim + key_dim * num_heads * 2
    return {
        "qkv": conv_p(wm, f"{name}.qkv", dim, h),
        "pe": conv_p(wm, f"{name}.pe", dim, dim, k=3, groups=dim),
        "proj": conv_p(wm, f"{name}.proj", dim, dim),
    }


def psablock_p(wm, name, dim, attn_ratio=0.5, num_heads=None):
    if num_heads is None:
        num_heads = dim // 64
    return {
        "attn": attention_p(wm, f"{name}.attn", dim, num_heads, attn_ratio),
        "ffn0": conv_p(wm, f"{name}.ffn.0", dim, dim * 2),
        "ffn1": conv_p(wm, f"{name}.ffn.1", dim * 2, dim),
    }


def c2psa_p(wm, name, c1, c2, n, e=0.5):
    c = int(c1 * e)
    return {
        "cv1": conv_p(wm, f"{name}.cv1", c1, 2 * c),
        "cv2": conv_p(wm, f"{name}.cv2", 2 * c, c2),
        "m": [psablock_p(wm, f"{name}.m.{i}", c) for i in range(n)],
    }


# ---------------------------------------------------------------------------
# modules (NCHW in channels_last memory, OIHW buffers)
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    """Conv with folded BN, then SiLU when ``act``. Padding ``pad``, by
    default k//2; a depthwise kernel makes it a depthwise conv (groups from
    the weight).

    ``slot`` is None on the float path. An int8 engine's copy of the
    network (`core/quant.py` `QuantizedEngine`, `calibrate`) gives every
    Conv an `ops.quant_ctx.ConvSlot` whose index is the Conv's place in the
    call order of one forward, the JAX package's trace order of
    ``nn.conv2d`` calls; the scale table and the weight list follow it, so
    each Conv must run once per forward. The slot then records calibration
    taps of the input or runs the int8 conv in place of the float one; the
    SiLU after it is the same."""

    def __init__(self, p, stride: int = 1, act: bool = True, pad: Optional[int] = None):
        super().__init__()
        self.register_buffer("w", p["w"])
        self.register_buffer("b", p["b"])
        self.stride = stride
        self.pad = p["w"].shape[2] // 2 if pad is None else pad
        self.act = act
        self.slot = None

    def forward(self, x):
        if self.slot is None:
            y = ops.conv2d(x, self.w, self.b, stride=self.stride, padding=self.pad)
        else:
            y = self.slot.conv(x, self.w, self.b, self.stride, self.pad)
        return ops.silu(y) if self.act else y


class Linear(nn.Module):
    """x @ w (+ b) with ``w`` stored (in, out), as the JAX tree keeps it
    (the cls head's ``m10_linear``)."""

    def __init__(self, p):
        super().__init__()
        self.register_buffer("w", p["w"])
        self.register_buffer("b", p["b"])

    def forward(self, x):
        return ops.linear(x, self.w, self.b)


class Bottleneck(nn.Module):
    def __init__(self, p, shortcut: bool = True):
        super().__init__()
        self.cv1 = Conv(p["cv1"])
        self.cv2 = Conv(p["cv2"])
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        # residual only when channels match (c1 == c2)
        return x + y if (self.shortcut and x.shape[1] == y.shape[1]) else y


class C3k(nn.Module):
    """C3k, and YOLOv5's C3 (`C3`): the bottlenecks' kernel sizes live in
    the weights. ``shortcut`` reaches every bottleneck."""

    def __init__(self, p, shortcut: bool = True):
        super().__init__()
        self.cv1 = Conv(p["cv1"])
        self.cv2 = Conv(p["cv2"])
        self.cv3 = Conv(p["cv3"])
        self.m = nn.ModuleList(Bottleneck(b, shortcut) for b in p["m"])

    def forward(self, x):
        y1 = self.cv1(x)
        y2 = self.cv2(x)
        for b in self.m:
            y1 = b(y1)
        return self.cv3(torch.cat([y1, y2], dim=1))


class C3k2(nn.Module):
    """C3k2: sub-blocks are C3k where the tree has a cv3 conv, plain
    bottlenecks otherwise; YOLOv8's C2f (`C2f`) is the plain-bottleneck
    case. ``shortcut`` reaches every bottleneck (the v8 and v10 necks run
    without it)."""

    def __init__(self, p, shortcut: bool = True):
        super().__init__()
        self.cv1 = Conv(p["cv1"])
        self.cv2 = Conv(p["cv2"])
        self.m = nn.ModuleList(C3k(b, shortcut) if "cv3" in b else Bottleneck(b, shortcut)
                               for b in p["m"])

    def forward(self, x):
        y = self.cv1(x)
        c_ = y.shape[1] // 2
        parts = [y[:, :c_], y[:, c_:]]
        cur = parts[1]
        for b in self.m:
            cur = b(cur)
            parts.append(cur)
        return self.cv2(torch.cat(parts, dim=1))


# the same dataflows, as the JAX package aliases them (c3_a = c3k_a)
C3 = C3k
C2f = C3k2


class SPPF(nn.Module):
    def __init__(self, p, k: int = 5):
        super().__init__()
        self.cv1 = Conv(p["cv1"])
        self.cv2 = Conv(p["cv2"])
        self.k = k

    def forward(self, x):
        y = self.cv1(x)
        k = self.k
        p1 = ops.max_pool(y, k, 1, k // 2)
        p2 = ops.max_pool(p1, k, 1, k // 2)
        p3 = ops.max_pool(p2, k, 1, k // 2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


class Attention(nn.Module):
    """Multi-head self-attention over the spatial grid (block.cpp:295-355).

    Head geometry follows the weights as in the JAX package: nh = dim//64
    heads (at least 1), attn_ratio 0.5, and the qkv conv's channels are
    per head [q | k | v]. Scores and softmax run in float32."""

    def __init__(self, p, attn_ratio: float = 0.5):
        super().__init__()
        self.qkv = Conv(p["qkv"], act=False)
        self.pe = Conv(p["pe"], act=False)
        self.proj = Conv(p["proj"], act=False)
        self.attn_ratio = attn_ratio

    def forward(self, x):
        b, dim, hgt, wid = x.shape
        nh = max(dim // 64, 1)
        hd = dim // nh
        kd = int(hd * self.attn_ratio)
        n = hgt * wid
        qkv = self.qkv(x).reshape(b, nh, 2 * kd + hd, n)
        q, k, v = qkv[:, :, :kd], qkv[:, :, kd:2 * kd], qkv[:, :, 2 * kd:]
        attn = torch.matmul(q.transpose(-1, -2).float(), k.float()) * kd ** -0.5
        attn = torch.softmax(attn, dim=-1).to(x.dtype)          # (b, nh, n, n)
        out = torch.matmul(v, attn.transpose(-1, -2))            # (b, nh, hd, n)
        cl = torch.channels_last
        out = out.reshape(b, nh * hd, hgt, wid).contiguous(memory_format=cl)
        v_sp = v.reshape(b, nh * hd, hgt, wid).contiguous(memory_format=cl)
        return self.proj(out + self.pe(v_sp))


class PSABlock(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.attn = Attention(p["attn"])
        self.ffn0 = Conv(p["ffn0"])
        self.ffn1 = Conv(p["ffn1"], act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn1(self.ffn0(x))


class C2PSA(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.cv1 = Conv(p["cv1"])
        self.cv2 = Conv(p["cv2"])
        self.m = nn.ModuleList(PSABlock(b) for b in p["m"])

    def forward(self, x):
        y = self.cv1(x)
        c = y.shape[1] // 2
        a, bpart = y[:, :c], y[:, c:]
        for blk in self.m:
            bpart = blk(bpart)
        return self.cv2(torch.cat([a, bpart], dim=1))


def branch3_m(p) -> nn.ModuleDict:
    """A head branch: Conv3x3, Conv3x3, then a plain 1×1 exit with bias
    (the box branch, yolov8's class branch, the cv4 task branches)."""
    return nn.ModuleDict({"a": Conv(p["a"]), "b": Conv(p["b"]), "c": Conv(p["c"], act=False)})


def branch3(q, f):
    return q["c"](q["b"](q["a"](f)))

"""YOLOv10 det: the NMS-free one2one head and the SCDown, PSA and C2fCIB
blocks.

Reference: yolov10/src/model.cpp:33-1280 (buildEngineYolov10Det{N,S,M,BL,X}),
yolov10/src/block.cpp (SCDown :279, PSA :360, RepVGGDW :388, CIB :405,
C2fCIB :433); the plugin's decode-only top-k (yololayer.cu:157) is
`ops.nms.select_topk`. The JAX counterpart is
tensorrtx_tpu/models/yolov10.py (`apply` → `_apply_from_x1`).

Per scale some C2f stages become C2fCIB (compact inverted block); n and s
use the large-kernel RepVGGDW inside their CIBs. Every conv the JAX
package runs through ``nn.conv2d`` is a `_yolo_blocks.Conv` here, called
once per forward in the JAX package's order (SCDown's depthwise stride-2
conv and both RepVGGDW convs included), so the int8 tier's slots line up
with JAX's scale table.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tensorrtx_tpu_torch.core.registry import ModelDef, register
from tensorrtx_tpu_torch.models import _yolo_blocks as B
from tensorrtx_tpu_torch.models.yolo11 import AnchorFreeDet
from tensorrtx_tpu_torch.ops import nn as ops

SCALES = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "b": (0.67, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}
# modules that are C2fCIB per scale; value = lk (RepVGGDW) flag
_CIB = {
    "n": {22: True},
    "s": {8: True, 22: True},
    "m": {8: False, 19: False, 22: False},
    "b": {8: False, 13: False, 19: False, 22: False},
    "l": {8: False, 13: False, 19: False, 22: False},
    "x": {6: False, 8: False, 13: False, 19: False, 22: False},
}
POSTPROCESS = ("topk", "raw")


@dataclasses.dataclass
class Yolov10Cfg:
    """The JAX package's Yolov10Cfg, field for field (it has no ``task``:
    det only), so an engine dir's meta.json loads in either package."""
    scale: str = "n"
    num_classes: int = 80
    input_h: int = 640
    input_w: int = 640
    reg_max: int = 16
    conf_thresh: float = 0.25
    max_det: int = 300
    postprocess: str = "topk"   # NMS-free (yololayer.cu:157) | "raw"


def _chans(cfg):
    gd, gw, maxc = SCALES[cfg.scale]
    return (lambda x: B.get_width(x, gw, maxc)), (lambda x: B.get_depth(x, gd))


# ---------------------------------------------------------------------------
# param tree (numpy HWIO; byte-equal to the JAX package's build_params)
# ---------------------------------------------------------------------------

def _scdown_p(wm, name, ci, co):
    """SCDown (block.cpp:279-295): 1×1 conv+bn+silu, then a depthwise 3×3
    stride-2 conv+bn."""
    return {"cv1": B.conv_p(wm, f"{name}.cv1", ci, co, 1),
            "cv2": wm.conv_bn(f"{name}.cv2.conv", f"{name}.cv2.bn", co, co,
                              (3, 3), groups=co, eps=1e-3)}


def _repvggdw_p(wm, name, ch):
    """RepVGGDW (block.cpp:388-404): depthwise 7×7 and 3×3 conv+bn, summed,
    then SiLU."""
    return {"conv": wm.conv_bn(f"{name}.conv.conv", f"{name}.conv.bn", ch,
                               ch, (7, 7), groups=ch, eps=1e-3),
            "conv1": wm.conv_bn(f"{name}.conv1.conv", f"{name}.conv1.bn", ch,
                                ch, (3, 3), groups=ch, eps=1e-3)}


def _cib_p(wm, name, c1, c2, lk, e=1.0):
    c_ = int(c2 * e)
    p = {"c0": B.conv_p(wm, f"{name}.cv1.0", c1, c1, 3, groups=c1),
         "c1": B.conv_p(wm, f"{name}.cv1.1", c1, 2 * c_, 1),
         "c3": B.conv_p(wm, f"{name}.cv1.3", 2 * c_, c2, 1),
         "c4": B.conv_p(wm, f"{name}.cv1.4", c2, c2, 3, groups=c2)}
    if lk:
        p["lk"] = _repvggdw_p(wm, f"{name}.cv1.2", 2 * c_)
    else:
        p["c2"] = B.conv_p(wm, f"{name}.cv1.2", 2 * c_, 2 * c_, 3, groups=2 * c_)
    return p


def _c2fcib_p(wm, name, c1, c2, n, lk, e=0.5):
    c_ = int(c2 * e)
    return {"cv1": B.conv_p(wm, f"{name}.cv1", c1, 2 * c_, 1),
            "cv2": B.conv_p(wm, f"{name}.cv2", (2 + n) * c_, c2, 1),
            "m": [_cib_p(wm, f"{name}.m.{i}", c_, c_, lk) for i in range(n)]}


def _psa_p(wm, name, ch):
    """PSA (block.cpp:360-386): split, attention + FFN on one half."""
    c = ch // 2
    return {"cv1": B.conv_p(wm, f"{name}.cv1", ch, ch, 1),
            "blk": B.psablock_p(wm, name, c),
            "cv2": B.conv_p(wm, f"{name}.cv2", ch, ch, 1)}


def _block_p(wm, cfg, idx, name, c1, c2, n):
    cib = _CIB[cfg.scale].get(idx)
    if cib is None:
        return B.c2f_p(wm, name, c1, c2, n)
    return _c2fcib_p(wm, name, c1, c2, n, cib)


def build_params(wm, cfg: Yolov10Cfg):
    w, d = _chans(cfg)
    p = {
        "m0": B.conv_p(wm, "model.0", 3, w(64), 3),
        "m1": B.conv_p(wm, "model.1", w(64), w(128), 3),
        "m2": _block_p(wm, cfg, 2, "model.2", w(128), w(128), d(3)),
        "m3": B.conv_p(wm, "model.3", w(128), w(256), 3),
        "m4": _block_p(wm, cfg, 4, "model.4", w(256), w(256), d(6)),
        "m5": _scdown_p(wm, "model.5", w(256), w(512)),
        "m6": _block_p(wm, cfg, 6, "model.6", w(512), w(512), d(6)),
        "m7": _scdown_p(wm, "model.7", w(512), w(1024)),
        "m8": _block_p(wm, cfg, 8, "model.8", w(1024), w(1024), d(3)),
        "m9": B.sppf_p(wm, "model.9", w(1024), w(1024)),
        "m10": _psa_p(wm, "model.10", w(1024)),
        "m13": _block_p(wm, cfg, 13, "model.13", w(1024) + w(512), w(512), d(3)),
        "m16": _block_p(wm, cfg, 16, "model.16", w(512) + w(256), w(256), d(3)),
        "m17": B.conv_p(wm, "model.17", w(256), w(256), 3),
        "m19": _block_p(wm, cfg, 19, "model.19", w(512) + w(256), w(512), d(3)),
        "m20": _scdown_p(wm, "model.20", w(512), w(512)),
        "m22": _block_p(wm, cfg, 22, "model.22", w(1024) + w(512), w(1024), d(3)),
    }
    ch = [w(256), w(512), w(1024)]
    nc = cfg.num_classes
    c2 = max(16, max(ch[0] // 4, 64))
    c3 = max(ch[0], min(nc, 100))
    head = {"cv2": [], "cv3": []}
    for i, ci in enumerate(ch):
        head["cv2"].append({
            "a": B.conv_p(wm, f"model.23.one2one_cv2.{i}.0", ci, c2, 3),
            "b": B.conv_p(wm, f"model.23.one2one_cv2.{i}.1", c2, c2, 3),
            "c": wm.conv2d(f"model.23.one2one_cv2.{i}.2", cfg.reg_max * 4, c2, (1, 1)),
        })
        head["cv3"].append({
            "a0": B.conv_p(wm, f"model.23.one2one_cv3.{i}.0.0", ci, ci, 3, groups=ci),
            "a1": B.conv_p(wm, f"model.23.one2one_cv3.{i}.0.1", ci, c3, 1),
            "b0": B.conv_p(wm, f"model.23.one2one_cv3.{i}.1.0", c3, c3, 3, groups=c3),
            "b1": B.conv_p(wm, f"model.23.one2one_cv3.{i}.1.1", c3, c3, 1),
            "c": wm.conv2d(f"model.23.one2one_cv3.{i}.2", nc, c3, (1, 1)),
        })
    p["head"] = head
    return p


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class SCDown(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.cv1 = B.Conv(p["cv1"])
        self.cv2 = B.Conv(p["cv2"], stride=2, act=False)     # depthwise

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.conv = B.Conv(p["conv"], act=False)     # depthwise 7×7
        self.conv1 = B.Conv(p["conv1"], act=False)   # depthwise 3×3

    def forward(self, x):
        y = self.conv(x)
        return ops.silu(y + self.conv1(x))


class CIB(nn.Module):
    """Compact inverted block: dw 3×3, 1×1, dw 3×3 (or RepVGGDW), 1×1,
    dw 3×3, and the residual (c1 == c2 in every C2fCIB)."""

    def __init__(self, p):
        super().__init__()
        self.c0 = B.Conv(p["c0"])
        self.c1 = B.Conv(p["c1"])
        if "lk" in p:
            self.lk = RepVGGDW(p["lk"])
        else:
            self.c2 = B.Conv(p["c2"])
        self.c3 = B.Conv(p["c3"])
        self.c4 = B.Conv(p["c4"])

    def forward(self, x):
        y = self.c1(self.c0(x))
        y = self.lk(y) if hasattr(self, "lk") else self.c2(y)
        return x + self.c4(self.c3(y))


class C2fCIB(B.C3k2):
    """C2f whose sub-blocks are CIBs (the C3k2 dataflow)."""

    def __init__(self, p):
        nn.Module.__init__(self)
        self.cv1 = B.Conv(p["cv1"])
        self.cv2 = B.Conv(p["cv2"])
        self.m = nn.ModuleList(CIB(b) for b in p["m"])


class PSA(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.cv1 = B.Conv(p["cv1"])
        self.blk = B.PSABlock(p["blk"])
        self.cv2 = B.Conv(p["cv2"])

    def forward(self, x):
        y = self.cv1(x)
        c = y.shape[1] // 2
        return self.cv2(torch.cat([y[:, :c], self.blk(y[:, c:])], dim=1))


def _stage(p, shortcut):
    if p["m"] and "c0" in p["m"][0]:
        return C2fCIB(p)
    return B.C2f(p, shortcut=shortcut)


class Yolov10(AnchorFreeDet):
    """YOLOv10 built from an OIHW tensor tree (`params_from_jax` of a
    `build_params` tree); submodule names mirror the tree's keys
    (``m22.m.0.lk.conv1``, ``m10.blk.attn.qkv``, ``head.cv3.0.a0``)."""

    def __init__(self, cfg: Yolov10Cfg, params):
        super().__init__()
        if cfg.postprocess not in POSTPROCESS:
            raise ValueError(f"yolov10 postprocess {cfg.postprocess!r}: one of {POSTPROCESS}")
        self.cfg = cfg
        p = params
        self.m0 = B.Conv(p["m0"], stride=2)
        self.m1 = B.Conv(p["m1"], stride=2)
        self.m2 = _stage(p["m2"], True)
        self.m3 = B.Conv(p["m3"], stride=2)
        self.m4 = _stage(p["m4"], True)
        self.m5 = SCDown(p["m5"])
        self.m6 = _stage(p["m6"], True)
        self.m7 = SCDown(p["m7"])
        self.m8 = _stage(p["m8"], True)
        self.m9 = B.SPPF(p["m9"])
        self.m10 = PSA(p["m10"])
        self.m13 = _stage(p["m13"], False)
        self.m16 = _stage(p["m16"], False)
        self.m17 = B.Conv(p["m17"], stride=2)
        self.m19 = _stage(p["m19"], False)
        self.m20 = SCDown(p["m20"])
        self.m22 = _stage(p["m22"], False)
        self.head = self._det_head_m(p["head"])
        self._init_tail(p)

    def forward(self, x):
        """x: (B, H, W, 3) NHWC frames in the module's dtype."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        c4 = self.m4(self.m3(self.m2(self.m1(self.m0(x)))))
        c6 = self.m6(self.m5(c4))
        c10 = self.m10(self.m9(self.m8(self.m7(c6))))
        c13 = self.m13(torch.cat([ops.upsample_nearest(c10), c6], dim=1))
        p3 = self.m16(torch.cat([ops.upsample_nearest(c13), c4], dim=1))
        p4 = self.m19(torch.cat([self.m17(p3), c13], dim=1))
        p5 = self.m22(torch.cat([self.m20(p4), c10], dim=1))
        feats = [p3, p4, p5]
        return self.decode(*self._head(feats), feats)


register(ModelDef(
    name="yolov10",
    build_params=build_params,
    module=Yolov10,
    default_cfg=Yolov10Cfg,
    input_shape=lambda cfg: (cfg.input_h, cfg.input_w, 3),
    doc="YOLOv10 det, NMS-free one2one head (reference: yolov10/)",
))

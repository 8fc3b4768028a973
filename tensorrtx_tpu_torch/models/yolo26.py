"""YOLO26 det, obb and cls: a yolo11-style backbone (C3k2, SPPF, C2PSA)
with an attention-C3k2 final stage and an NMS-free one2one head with
direct ltrb regression (reg_max = 1, no DFL).

Reference: yolo26/src/model.cpp:33-403 (buildEngineYolo26Det; Obb from
:414, Cls from :874), yolo26/src/block.cpp:273-330 (C3K2 with the `attn`
variant: each m.i is a bottleneck then a PSABlock), the decode at
model.cpp:230-330 (x1y1 = grid − lt, x2y2 = grid + rb, × stride; sigmoid
classes; top-k without NMS, the plugin's yololayer.cu:178-250 ≙
`ops.nms.select_topk`). The JAX counterpart is
tensorrtx_tpu/models/yolo26.py (`apply` → `_apply_from_x1` →
`_apply_from_m3`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tensorrtx_tpu_torch.core.registry import ModelDef, register
from tensorrtx_tpu_torch.models import _yolo_blocks as B
from tensorrtx_tpu_torch.models.yolo11 import SCALES, AnchorFreeDet
from tensorrtx_tpu_torch.ops import nn as ops

TASKS = ("det", "obb", "cls")
POSTPROCESS = ("topk", "raw")


@dataclasses.dataclass
class Yolo26Cfg:
    """The JAX package's Yolo26Cfg, field for field (no ``nms_thresh`` and
    no ``reg_max``: the head is NMS-free and regresses ltrb directly)."""
    scale: str = "n"
    task: str = "det"           # det | obb | cls
    num_classes: int = 80
    input_h: int = 640
    input_w: int = 640
    conf_thresh: float = 0.25
    max_det: int = 300
    postprocess: str = "topk"   # NMS-free head | "raw"

    @property
    def multipliers(self):
        return SCALES[self.scale]


def _chans(cfg):
    gd, gw, maxc = cfg.multipliers
    return (lambda x: B.get_width(x, gw, maxc)), (lambda x: B.get_depth(x, gd))


# ---------------------------------------------------------------------------
# param tree (numpy HWIO; byte-equal to the JAX package's build_params)
# ---------------------------------------------------------------------------

def _c3k2_attn_p(wm, name, c1, c2, n, e=0.5):
    """C3K2 attn variant (block.cpp:295-300): m.i = bottleneck → PSABlock."""
    c_ = int(c2 * e)
    return {
        "cv1": B.conv_p(wm, f"{name}.cv1", c1, 2 * c_),
        "cv2": B.conv_p(wm, f"{name}.cv2", (2 + n) * c_, c2),
        "m": [{"b": B.bottleneck_p(wm, f"{name}.m.{i}.0", c_, c_, e=0.5),
               "psa": B.psablock_p(wm, f"{name}.m.{i}.1", c_)}
              for i in range(n)],
    }


def _backbone_p(wm, cfg):
    w, d = _chans(cfg)
    c3k = cfg.scale in ("m", "l", "x")
    return {
        "m0": B.conv_p(wm, "model.0", 3, w(64), 3),
        "m1": B.conv_p(wm, "model.1", w(64), w(128), 3),
        "m2": B.c3k2_p(wm, "model.2", w(128), w(256), d(2), c3k, e=0.25),
        "m3": B.conv_p(wm, "model.3", w(256), w(256), 3),
        "m4": B.c3k2_p(wm, "model.4", w(256), w(512), d(2), c3k, e=0.25),
        "m5": B.conv_p(wm, "model.5", w(512), w(512), 3),
        "m6": B.c3k2_p(wm, "model.6", w(512), w(512), d(2), True, e=0.5),
        "m7": B.conv_p(wm, "model.7", w(512), w(1024), 3),
        "m8": B.c3k2_p(wm, "model.8", w(1024), w(1024), d(2), True, e=0.5),
    }


def _build_cls_params(wm, cfg):
    """buildEngineYolo26Cls (model.cpp:874-): backbone 0..8, C2PSA at
    model.9, Classify head model.10 (1×1 conv to 1280 → GAP → linear)."""
    w, d = _chans(cfg)
    p = _backbone_p(wm, cfg)
    p["m9"] = B.c2psa_p(wm, "model.9", w(1024), w(1024), d(2))
    p["m10_conv"] = B.conv_p(wm, "model.10.conv", w(1024), 1280, 1)
    p["m10_linear"] = wm.linear("model.10.linear", cfg.num_classes, 1280)
    return p


def build_params(wm, cfg: Yolo26Cfg):
    if cfg.task == "cls":
        return _build_cls_params(wm, cfg)
    w, d = _chans(cfg)
    p = _backbone_p(wm, cfg)
    p.update({
        "m9": B.sppf_p(wm, "model.9", w(1024), w(1024)),
        "m10": B.c2psa_p(wm, "model.10", w(1024), w(1024), d(2)),
        "m13": B.c3k2_p(wm, "model.13", w(1024) + w(512), w(512), d(2), True, e=0.5),
        "m16": B.c3k2_p(wm, "model.16", w(512) + w(512), w(256), d(2), True, e=0.5),
        "m17": B.conv_p(wm, "model.17", w(256), w(256), 3),
        "m19": B.c3k2_p(wm, "model.19", w(512) + w(256), w(512), d(2), True, e=0.5),
        "m20": B.conv_p(wm, "model.20", w(512), w(512), 3),
        # model.22: n fixed to 1, attention variant (model.cpp:139-143)
        "m22": _c3k2_attn_p(wm, "model.22", w(1024) + w(512), w(1024), 1),
    })
    nc = cfg.num_classes
    ch = [w(256), w(512), w(1024)]
    c2 = max(16, w(256), 64)
    c3 = max(w(256), min(nc, 100))
    head = {"cv2": [], "cv3": []}
    for i, ci in enumerate(ch):
        head["cv2"].append({
            "a": B.conv_p(wm, f"model.23.one2one_cv2.{i}.0", ci, c2 // 4, 3),
            "b": B.conv_p(wm, f"model.23.one2one_cv2.{i}.1", c2 // 4, c2 // 4, 3),
            "c": wm.conv2d(f"model.23.one2one_cv2.{i}.2", 4, c2 // 4, (1, 1)),
        })
        head["cv3"].append({
            "a0": B.conv_p(wm, f"model.23.one2one_cv3.{i}.0.0", ci, ci, 3, groups=ci),
            "a1": B.conv_p(wm, f"model.23.one2one_cv3.{i}.0.1", ci, c3, 1),
            "b0": B.conv_p(wm, f"model.23.one2one_cv3.{i}.1.0", c3, c3, 3, groups=c3),
            "b1": B.conv_p(wm, f"model.23.one2one_cv3.{i}.1.1", c3, c3, 1),
            "c": wm.conv2d(f"model.23.one2one_cv3.{i}.2", nc, c3, (1, 1)),
        })
    p["head"] = head
    if cfg.task == "obb":
        # one2one_cv4 angle branch (buildEngineYolo26Obb, model.cpp:414-)
        p["cv4"] = [{
            "a": B.conv_p(wm, f"model.23.one2one_cv4.{i}.0", ci, c2 // 4, 3),
            "b": B.conv_p(wm, f"model.23.one2one_cv4.{i}.1", c2 // 4, c2 // 4, 3),
            "c": wm.conv2d(f"model.23.one2one_cv4.{i}.2", 1, c2 // 4, (1, 1)),
        } for i, ci in enumerate(ch)]
    return p


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class C3k2Attn(nn.Module):
    """The C3k2 dataflow whose sub-block i is a bottleneck, then a
    PSABlock (both with their shortcuts)."""

    def __init__(self, p):
        super().__init__()
        self.cv1 = B.Conv(p["cv1"])
        self.cv2 = B.Conv(p["cv2"])
        self.m = nn.ModuleList(nn.ModuleDict({"b": B.Bottleneck(q["b"]),
                                              "psa": B.PSABlock(q["psa"])}) for q in p["m"])

    def forward(self, x):
        y = self.cv1(x)
        c_ = y.shape[1] // 2
        parts = [y[:, :c_], y[:, c_:]]
        cur = parts[1]
        for blk in self.m:
            cur = blk["psa"](blk["b"](cur))
            parts.append(cur)
        return self.cv2(torch.cat(parts, dim=1))


class Yolo26(AnchorFreeDet):
    """YOLO26 built from an OIHW tensor tree (`params_from_jax` of a
    `build_params` tree); submodule names mirror the tree's keys
    (``m22.m.0.psa.attn.qkv``, ``head.cv2.0.c``, ``cv4.0.a``,
    ``m10_linear``)."""

    def __init__(self, cfg: Yolo26Cfg, params):
        super().__init__()
        if cfg.task not in TASKS:
            raise ValueError(f"yolo26 task {cfg.task!r}: one of {TASKS}")
        if cfg.postprocess not in POSTPROCESS:
            raise ValueError(f"yolo26 postprocess {cfg.postprocess!r}: one of {POSTPROCESS}")
        self.cfg = cfg
        p = params
        for i in range(9):      # m0, m1, m3, m5, m7 stride-2 convs; C3k2 stages
            self.add_module(f"m{i}", B.C3k2(p[f"m{i}"]) if i in (2, 4, 6, 8)
                            else B.Conv(p[f"m{i}"], stride=2))
        if cfg.task == "cls":
            self.m9 = B.C2PSA(p["m9"])
            self.m10_conv = B.Conv(p["m10_conv"])
            self.m10_linear = B.Linear(p["m10_linear"])
            return
        self.m9 = B.SPPF(p["m9"])
        self.m10 = B.C2PSA(p["m10"])
        self.m13 = B.C3k2(p["m13"])
        self.m16 = B.C3k2(p["m16"])
        self.m17 = B.Conv(p["m17"], stride=2)
        self.m19 = B.C3k2(p["m19"])
        self.m20 = B.Conv(p["m20"], stride=2)
        self.m22 = C3k2Attn(p["m22"])
        self.head = self._det_head_m(p["head"])
        self._init_tail(p)

    def _ltrb(self, box_lv):
        """The raw 4-channel box exits, flattened level-major in float32
        (reg_max = 1: no DFL)."""
        b = box_lv[0].shape[0]
        return torch.cat([box.reshape(b, -1, 4) for box in box_lv], 1).float()

    def _backbone(self, x):
        c4 = self.m4(self.m3(self.m2(self.m1(self.m0(x)))))
        c6 = self.m6(self.m5(c4))
        return self.m8(self.m7(c6)), c4, c6

    def forward(self, x):
        """x: (B, H, W, 3) NHWC frames in the module's dtype."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x, c4, c6 = self._backbone(x)
        if self.cfg.task == "cls":
            y = self.m10_conv(self.m9(x))
            return self.m10_linear(ops.global_avg_pool(y))
        c10 = self.m10(self.m9(x))
        c13 = self.m13(torch.cat([ops.upsample_nearest(c10), c6], dim=1))
        p3 = self.m16(torch.cat([ops.upsample_nearest(c13), c4], dim=1))
        p4 = self.m19(torch.cat([self.m17(p3), c13], dim=1))
        p5 = self.m22(torch.cat([self.m20(p4), c10], dim=1))
        feats = [p3, p4, p5]
        return self.decode(*self._head(feats), feats)


register(ModelDef(
    name="yolo26",
    build_params=build_params,
    module=Yolo26,
    default_cfg=Yolo26Cfg,
    input_shape=lambda cfg: (cfg.input_h, cfg.input_w, 3),
    doc="YOLO26 det/obb/cls, NMS-free one2one head (reference: yolo26/)",
))

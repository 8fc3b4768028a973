"""YOLOv8 det, seg, pose, obb and cls, and the P2 and 5u det variants.

Reference: yolov8/src/model.cpp (buildEngineYolov8Det, the Seg, Pose and
Obb builders, buildEngineYolov8Cls:969, buildEngineYolov8DetP2:653,
buildEngineYolov8_5uDet:1904), yolov8/src/block.cpp (C2F), and
yolov8/plugin/yololayer.cu, whose anchor-free decode yolo11 shares. The
JAX counterpart is tensorrtx_tpu/models/yolov8.py (`apply` →
`_apply_main_from_x1` → `_apply_main_from_m3`, `_apply_p2`,
`_apply_5u_backbone`, `_apply_cls`).

The module takes NHWC frames and returns what `yolo11.Yolo11` returns
(`AnchorFreeDet.decode`: the fixed `Detections` buffer, seg's masks, or
with ``postprocess="raw"`` the per-anchor outputs); cls returns the
(B, num_classes) logits. Only the plain graph is ported: the JAX
package's space-to-depth stem, row-phase m4/m5 stage and batch fold are
TPU layout rewrites of the same values.

Scale multipliers: n .33/.25/1024, s .33/.50/1024, m .67/.75/768, l
1/1/512, x 1/1.25/512; cls caps the width at 1280, 5u does not cap it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from tensorrtx_tpu_torch.core.registry import ModelDef, register
from tensorrtx_tpu_torch.models import _yolo_blocks as B
from tensorrtx_tpu_torch.models import _yolo_qchain as Q
from tensorrtx_tpu_torch.models.yolo11 import AnchorFreeDet
from tensorrtx_tpu_torch.ops import nn as ops

SCALES = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

TASKS = ("det", "seg", "pose", "obb", "cls")
VARIANTS = ("", "p2", "5u")
POSTPROCESS = ("nms", "raw")


@dataclasses.dataclass
class Yolov8Cfg:
    """The JAX package's Yolov8Cfg, field for field, so an engine dir's
    meta.json loads in either package."""
    scale: str = "n"
    task: str = "det"            # det | seg | cls | pose | obb
    variant: str = ""            # "" | "p2" | "5u" (det)
    num_classes: int = 80
    input_h: int = 640
    input_w: int = 640
    conf_thresh: float = 0.5
    nms_thresh: float = 0.45
    max_det: int = 300
    kpt_conf_thresh: float = 0.5
    num_kpts: int = 17
    reg_max: int = 16
    postprocess: str = "nms"     # "nms" | "raw"


def _check_cfg(cfg: Yolov8Cfg):
    if cfg.task not in TASKS:
        raise ValueError(f"yolov8 task {cfg.task!r}: one of {TASKS}")
    if cfg.variant not in VARIANTS:
        raise ValueError(f"yolov8 variant {cfg.variant!r}: one of {VARIANTS}")
    if cfg.variant and cfg.task != "det":
        raise ValueError(f"the yolov8 {cfg.variant} variant is a det graph, not {cfg.task!r}")
    if cfg.postprocess not in POSTPROCESS:
        raise ValueError(f"yolov8 postprocess {cfg.postprocess!r}: one of {POSTPROCESS}")


def _chans(cfg: Yolov8Cfg):
    gd, gw, maxc = SCALES[cfg.scale]
    if cfg.task == "cls":
        maxc = 1280  # buildEngineYolov8Cls (model.cpp:973)
    if cfg.variant == "5u":
        maxc = 1 << 30  # get_width_5u: no max-channel cap (model.cpp:9-11)
    return (lambda x: B.get_width(x, gw, maxc)), (lambda x: B.get_depth(x, gd))


# ---------------------------------------------------------------------------
# param tree (numpy HWIO; byte-equal to the JAX package's build_params)
# ---------------------------------------------------------------------------

def _det_head_p(wm, cfg, name, chans, nc):
    """Detect head: per level a cv2 (box) and a cv3 (class) branch, each
    Conv3x3, Conv3x3 and a 1×1 exit."""
    c2 = max(16, chans[0] // 4, cfg.reg_max * 4)
    c3 = max(chans[0], min(nc, 100))
    head = {"cv2": [], "cv3": []}
    for i, ci in enumerate(chans):
        head["cv2"].append({
            "a": B.conv_p(wm, f"{name}.cv2.{i}.0", ci, c2, 3),
            "b": B.conv_p(wm, f"{name}.cv2.{i}.1", c2, c2, 3),
            "c": wm.conv2d(f"{name}.cv2.{i}.2", cfg.reg_max * 4, c2, (1, 1)),
        })
        head["cv3"].append({
            "a": B.conv_p(wm, f"{name}.cv3.{i}.0", ci, c3, 3),
            "b": B.conv_p(wm, f"{name}.cv3.{i}.1", c3, c3, 3),
            "c": wm.conv2d(f"{name}.cv3.{i}.2", nc, c3, (1, 1)),
        })
    return head


def _extra_branch_p(wm, name, chans, cmid, cout):
    return [{"a": B.conv_p(wm, f"{name}.{i}.0", ci, cmid, 3),
             "b": B.conv_p(wm, f"{name}.{i}.1", cmid, cmid, 3),
             "c": wm.conv2d(f"{name}.{i}.2", cout, cmid, (1, 1))}
            for i, ci in enumerate(chans)]


def _c2f_backbone_p(wm, cfg):
    """model.0-8: the stem convs and the C2f stages (det, seg, pose, obb,
    cls and P2)."""
    w, d = _chans(cfg)
    return {
        "m0": B.conv_p(wm, "model.0", 3, w(64), 3),
        "m1": B.conv_p(wm, "model.1", w(64), w(128), 3),
        "m2": B.c2f_p(wm, "model.2", w(128), w(128), d(3)),
        "m3": B.conv_p(wm, "model.3", w(128), w(256), 3),
        "m4": B.c2f_p(wm, "model.4", w(256), w(256), d(6)),
        "m5": B.conv_p(wm, "model.5", w(256), w(512), 3),
        "m6": B.c2f_p(wm, "model.6", w(512), w(512), d(6)),
        "m7": B.conv_p(wm, "model.7", w(512), w(1024), 3),
        "m8": B.c2f_p(wm, "model.8", w(1024), w(1024), d(3)),
    }


def _build_cls_params(wm, cfg):
    """buildEngineYolov8Cls (model.cpp:969-1056): backbone 0..8 (widths
    capped at 1280) → 1×1 conv to 1280 → global average pool → linear."""
    w, _ = _chans(cfg)
    p = _c2f_backbone_p(wm, cfg)
    p["m9_conv"] = B.conv_p(wm, "model.9.conv", w(1024), 1280, 1)
    p["m9_linear"] = wm.linear("model.9.linear", cfg.num_classes, 1280)
    return p


def _build_p2_params(wm, cfg):
    """buildEngineYolov8DetP2 (model.cpp:653-968): a 4-level P2..P5 head at
    model.28, strides (4, 8, 16, 32)."""
    w, d = _chans(cfg)
    p = _c2f_backbone_p(wm, cfg)
    p.update({
        "m9": B.sppf_p(wm, "model.9", w(1024), w(1024)),
        "m12": B.c2f_p(wm, "model.12", w(1024) + w(512), w(512), d(3)),
        "m15": B.c2f_p(wm, "model.15", w(512) + w(256), w(256), d(3)),
        "m18": B.c2f_p(wm, "model.18", w(256) + w(128), w(128), d(3)),
        "m19": B.conv_p(wm, "model.19", w(128), w(128), 3),
        "m21": B.c2f_p(wm, "model.21", w(256) + w(128), w(256), d(3)),
        "m22": B.conv_p(wm, "model.22", w(256), w(256), 3),
        "m24": B.c2f_p(wm, "model.24", w(512) + w(256), w(512), d(3)),
        "m25": B.conv_p(wm, "model.25", w(512), w(512), 3),
        "m27": B.c2f_p(wm, "model.27", w(1024) + w(512), w(1024), d(3)),
    })
    chans = [w(128), w(256), w(512), w(1024)]
    p["head"] = _det_head_p(wm, cfg, "model.28", chans, cfg.num_classes)
    return p


def _build_5u_params(wm, cfg):
    """buildEngineYolov8_5uDet (model.cpp:1904-2167): a YOLOv5 C3 backbone
    (6×6 stem) and the anchor-free v8 head at model.24."""
    w, d = _chans(cfg)
    p = {
        "m0": B.conv_p(wm, "model.0", 3, w(64), 6),
        "m1": B.conv_p(wm, "model.1", w(64), w(128), 3),
        "m2": B.c3_p(wm, "model.2", w(128), w(128), d(3)),
        "m3": B.conv_p(wm, "model.3", w(128), w(256), 3),
        "m4": B.c3_p(wm, "model.4", w(256), w(256), d(6)),
        "m5": B.conv_p(wm, "model.5", w(256), w(512), 3),
        "m6": B.c3_p(wm, "model.6", w(512), w(512), d(6)),
        "m7": B.conv_p(wm, "model.7", w(512), w(1024), 3),
        "m8": B.c3_p(wm, "model.8", w(1024), w(1024), d(3)),
        "m9": B.sppf_p(wm, "model.9", w(1024), w(1024)),
        "m10": B.conv_p(wm, "model.10", w(1024), w(512), 1),
        "m13": B.c3_p(wm, "model.13", w(512) + w(512), w(512), d(3)),
        "m14": B.conv_p(wm, "model.14", w(512), w(256), 1),
        "m17": B.c3_p(wm, "model.17", w(256) + w(256), w(256), d(3)),
        "m18": B.conv_p(wm, "model.18", w(256), w(256), 3),
        "m20": B.c3_p(wm, "model.20", w(256) + w(256), w(512), d(3)),
        "m21": B.conv_p(wm, "model.21", w(512), w(512), 3),
        "m23": B.c3_p(wm, "model.23", w(512) + w(512), w(1024), d(3)),
    }
    chans = [w(256), w(512), w(1024)]
    p["head"] = _det_head_p(wm, cfg, "model.24", chans, cfg.num_classes)
    return p


def _build_det_params(wm, cfg: Yolov8Cfg):
    w, d = _chans(cfg)
    p = _c2f_backbone_p(wm, cfg)
    p.update({
        "m9": B.sppf_p(wm, "model.9", w(1024), w(1024)),
        "m12": B.c2f_p(wm, "model.12", w(1024) + w(512), w(512), d(3)),
        "m15": B.c2f_p(wm, "model.15", w(512) + w(256), w(256), d(3)),
        "m16": B.conv_p(wm, "model.16", w(256), w(256), 3),
        "m18": B.c2f_p(wm, "model.18", w(512) + w(256), w(512), d(3)),
        "m19": B.conv_p(wm, "model.19", w(512), w(512), 3),
        "m21": B.c2f_p(wm, "model.21", w(1024) + w(512), w(1024), d(3)),
    })
    ch = [w(256), w(512), w(1024)]
    nc = 1 if cfg.task == "pose" else cfg.num_classes
    p["head"] = _det_head_p(wm, cfg, "model.22", ch, nc)
    if cfg.task == "pose":
        kpt_ch = cfg.num_kpts * 3
        p["cv4"] = _extra_branch_p(wm, "model.22.cv4", ch, max(ch[0] // 4, kpt_ch), kpt_ch)
    elif cfg.task == "obb":
        p["cv4"] = _extra_branch_p(wm, "model.22.cv4", ch, max(ch[0] // 4, 1), 1)
    elif cfg.task == "seg":
        p["cv4"] = _extra_branch_p(wm, "model.22.cv4", ch, max(ch[0] // 4, 32), 32)
        c_ = w(256)
        # ConvTranspose2d(c_, c_, 2, 2): torch weight (in, out, 2, 2), kept
        # in the JAX tree as (kh, kw, out, in)
        up_w = wm.tensor("model.22.proto.upsample.weight", (c_, c_, 2, 2))
        p["proto"] = {
            "cv1": B.conv_p(wm, "model.22.proto.cv1", ch[0], c_, 3),
            "up_w": np.transpose(up_w, (2, 3, 1, 0)),
            "up_b": wm.vec("model.22.proto.upsample.bias", c_),
            "cv2": B.conv_p(wm, "model.22.proto.cv2", c_, c_, 3),
            "cv3": B.conv_p(wm, "model.22.proto.cv3", c_, 32, 1),
        }
    return p


def build_params(wm, cfg: Yolov8Cfg):
    _check_cfg(cfg)
    if cfg.task == "cls":
        return _build_cls_params(wm, cfg)
    if cfg.variant == "p2":
        return _build_p2_params(wm, cfg)
    if cfg.variant == "5u":
        return _build_5u_params(wm, cfg)
    return _build_det_params(wm, cfg)


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------

# each graph's modules by key: (kind, stride or shortcut); "stem6" is 5u's stem
_C2F_BACKBONE = {"m0": ("conv", 2), "m1": ("conv", 2), "m2": ("c2f", True),
                 "m3": ("conv", 2), "m4": ("c2f", True), "m5": ("conv", 2),
                 "m6": ("c2f", True), "m7": ("conv", 2), "m8": ("c2f", True)}
_GRAPHS = {
    "det": {**_C2F_BACKBONE, "m9": ("sppf", None), "m12": ("c2f", False),
            "m15": ("c2f", False), "m16": ("conv", 2), "m18": ("c2f", False),
            "m19": ("conv", 2), "m21": ("c2f", False)},
    "p2": {**_C2F_BACKBONE, "m9": ("sppf", None), "m12": ("c2f", False),
           "m15": ("c2f", False), "m18": ("c2f", False), "m19": ("conv", 2),
           "m21": ("c2f", False), "m22": ("conv", 2), "m24": ("c2f", False),
           "m25": ("conv", 2), "m27": ("c2f", False)},
    "5u": {"m0": ("stem6", 2), "m1": ("conv", 2), "m2": ("c3", True), "m3": ("conv", 2),
           "m4": ("c3", True), "m5": ("conv", 2), "m6": ("c3", True), "m7": ("conv", 2),
           "m8": ("c3", True), "m9": ("sppf", None), "m10": ("conv", 1),
           "m13": ("c3", False), "m14": ("conv", 1), "m17": ("c3", False),
           "m18": ("conv", 2), "m20": ("c3", False), "m21": ("conv", 2),
           "m23": ("c3", False)},
    "cls": {**_C2F_BACKBONE, "m9_conv": ("conv", 1)},
}


def _block(kind, arg, p):
    if kind == "stem6":
        # 5u's 6×6 stem at pad 2 (model.cpp:1907): k // 2 would give 321² at 640²
        return B.Conv(p, stride=arg, pad=2)
    if kind == "conv":
        return B.Conv(p, stride=arg)
    if kind == "sppf":
        return B.SPPF(p)
    return (B.C2f if kind == "c2f" else B.C3)(p, shortcut=arg)


class Yolov8(AnchorFreeDet):
    """YOLOv8 built from an OIHW tensor tree (`params_from_jax` of a
    `build_params` tree). Submodule names mirror the tree's keys (``m2.m.0.cv1``,
    ``head.cv3.1.b``, ``cv4.0.a``, ``proto.up_w``, ``m9_linear``), which is
    what `core.convert.params_to_jax` writes an engine dir's keys from."""

    def __init__(self, cfg: Yolov8Cfg, params):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        graph = "cls" if cfg.task == "cls" else cfg.variant or "det"
        for key, (kind, arg) in _GRAPHS[graph].items():
            self.add_module(key, _block(kind, arg, params[key]))
        if graph == "cls":
            self.m9_linear = B.Linear(params["m9_linear"])
            return
        hd = params["head"]
        self.head = nn.ModuleDict({k: nn.ModuleList(B.branch3_m(q) for q in hd[k])
                                   for k in ("cv2", "cv3")})
        self._init_tail(params, (4, 8, 16, 32) if graph == "p2" else (8, 16, 32))

    def _head(self, feats):
        """Every level's box branch, then every level's class branch (the
        JAX package's order, which the int8 tier's slots follow), as NHWC
        views of the channels_last outputs."""
        return ([B.branch3(q, f).permute(0, 2, 3, 1) for q, f in zip(self.head["cv2"], feats)],
                [B.branch3(r, f).permute(0, 2, 3, 1) for r, f in zip(self.head["cv3"], feats)])

    def _det_features(self, x):
        """`_apply_main_from_x1` / `_apply_main_from_m3` on the plain graph."""
        c4 = self.m4(self.m3(self.m2(self.m1(self.m0(x)))))
        c6 = self.m6(self.m5(c4))
        p5_in = self.m9(self.m8(self.m7(c6)))
        p4_mid = self.m12(torch.cat([ops.upsample_nearest(p5_in), c6], dim=1))
        p3 = self.m15(torch.cat([ops.upsample_nearest(p4_mid), c4], dim=1))
        p4 = self.m18(torch.cat([self.m16(p3), p4_mid], dim=1))
        p5 = self.m21(torch.cat([self.m19(p4), p5_in], dim=1))
        return [p3, p4, p5]

    def _p2_features(self, x):
        """`_apply_p2`: P2..P5."""
        c2 = self.m2(self.m1(self.m0(x)))
        c4 = self.m4(self.m3(c2))
        c6 = self.m6(self.m5(c4))
        p5_in = self.m9(self.m8(self.m7(c6)))
        m12 = self.m12(torch.cat([ops.upsample_nearest(p5_in), c6], dim=1))
        m15 = self.m15(torch.cat([ops.upsample_nearest(m12), c4], dim=1))
        p2 = self.m18(torch.cat([ops.upsample_nearest(m15), c2], dim=1))
        p3 = self.m21(torch.cat([self.m19(p2), m15], dim=1))
        p4 = self.m24(torch.cat([self.m22(p3), m12], dim=1))
        p5 = self.m27(torch.cat([self.m25(p4), p5_in], dim=1))
        return [p2, p3, p4, p5]

    def _5u_features(self, x):
        """`_apply_5u_backbone` on the plain graph (its P2/P3 stages run as
        C3 then the stride-2 conv)."""
        c4 = self.m4(self.m3(self.m2(self.m1(self.m0(x)))))
        c6 = self.m6(self.m5(c4))
        m10 = self.m10(self.m9(self.m8(self.m7(c6))))
        m13 = self.m13(torch.cat([ops.upsample_nearest(m10), c6], dim=1))
        m14 = self.m14(m13)
        p3 = self.m17(torch.cat([ops.upsample_nearest(m14), c4], dim=1))
        p4 = self.m20(torch.cat([self.m18(p3), m14], dim=1))
        p5 = self.m23(torch.cat([self.m21(p4), m10], dim=1))
        return [p3, p4, p5]

    def _classify(self, x):
        """cls: backbone, 1×1 to 1280, global average pool, linear →
        (B, num_classes) logits in the module's dtype."""
        y = self.m8(self.m7(self.m6(self.m5(self.m4(self.m3(self.m2(self.m1(self.m0(x)))))))))
        return self.m9_linear(ops.global_avg_pool(self.m9_conv(y)))

    def forward(self, x):
        """x: (B, H, W, 3) NHWC frames in the module's dtype."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        cfg = self.cfg
        if cfg.task == "cls":
            return self._classify(x)
        feats = {"": self._det_features, "p2": self._p2_features,
                 "5u": self._5u_features}[cfg.variant](x)
        return self.decode(*self._head(feats), feats)


def apply_chain(module: Yolov8, x, cfg: Yolov8Cfg, ctx):
    """Int8-resident chain mirror of the standard v8 det forward (the JAX
    package's `yolov8.apply_chain` for ``enter="m3"``, on the plain graph;
    see `yolo11.apply_chain` for the design).

    x: (B, H, W, 3) letterboxed NHWC frames in the float islands' dtype.
    The 160² stem (m0, m1 and the m2 C2f) runs in float through the module,
    then the chain enters at m3; the neck's C2fs run without shortcuts; the
    head's box and class branches are chain convs with float exits, level
    by level (b3, c3, b4, c4, b5, c5), into the decode tail. The JAX
    mirror's batch fold (its folded weights' ``in_segments``) and s2d stem
    are TPU layout rewrites that keep the slot order and the scales, so the
    slots here are JAX's one for one and any batch ≥ 1 serves."""
    if cfg.task != "det" or cfg.variant:
        raise NotImplementedError("the chained int8 tier covers the standard v8 det graph")
    m = module
    xf = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xf = m.m2(m.m1(m.m0(xf)))
    x = ctx.quant_in(xf.permute(0, 2, 3, 1).contiguous())
    x = Q.qconv_a(ctx, m.m3, x, stride=2)
    c4 = Q.qc2f_a(ctx, m.m4, x)
    x = Q.qconv_a(ctx, m.m5, c4, stride=2)
    c6 = Q.qc2f_a(ctx, m.m6, x)
    x = Q.qc2f_a(ctx, m.m8, Q.qconv_a(ctx, m.m7, c6, stride=2))
    p5_in = Q.qsppf_a(ctx, m.m9, x)
    p4_mid = Q.qc2f_a(ctx, m.m12, ctx.concat([ctx.upsample(p5_in), c6]), shortcut=False)
    p3 = Q.qc2f_a(ctx, m.m15, ctx.concat([ctx.upsample(p4_mid), c4]), shortcut=False)
    p4 = Q.qc2f_a(ctx, m.m18, ctx.concat([Q.qconv_a(ctx, m.m16, p3, stride=2), p4_mid]),
                  shortcut=False)
    p5 = Q.qc2f_a(ctx, m.m21, ctx.concat([Q.qconv_a(ctx, m.m19, p4, stride=2), p5_in]),
                  shortcut=False)
    box_lv, cls_lv = [], []
    for f, q, r in zip((p3, p4, p5), m.head["cv2"], m.head["cv3"]):
        box_lv.append(Q.qbranch3(ctx, q, f))
        cls_lv.append(Q.qbranch3(ctx, r, f))
    return module.decode(box_lv, cls_lv)


# the JAX entry's letterbox_s2d factor; the port letterboxes to full frames
apply_chain.factor = 4
apply_chain.supports = lambda cfg: cfg.task == "det" and not cfg.variant
# the float islands of the chain: the modules it calls in float
apply_chain.float_modules = ("m0", "m1", "m2")


register(ModelDef(
    name="yolov8",
    build_params=build_params,
    module=Yolov8,
    default_cfg=Yolov8Cfg,
    input_shape=lambda cfg: (cfg.input_h, cfg.input_w, 3),
    apply_chain=apply_chain,
    doc="YOLOv8 det/seg/pose/obb/cls, P2 and 5u (reference: yolov8/)",
))

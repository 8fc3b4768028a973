"""YOLO11 detection (task="det") — the port's main path.

Reference: yolo11/src/model.cpp (buildEngineYolo11Det:138),
yolo11/src/block.cpp, yolo11/plugin/yololayer.cu. The JAX counterpart is
tensorrtx_tpu/models/yolo11.py (`apply` → `_apply_from_feats3`, det branch).

The module takes NHWC frames (as the JAX ``apply`` does) and returns the
fixed `Detections` buffer, or with ``postprocess="raw"`` the per-anchor
boxes, confidences and class ids. Backbone, neck and head run in NCHW
channels_last; DFL, decode and NMS in float32.

Scale multipliers (yolo11_det.cpp:115-160):
  n: gd=.50 gw=.25 maxc=1024 | s: .50/.50/1024 | m: .50/1.0/512
  l: 1.0/1.0/512 | x: 1.0/1.5/512
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from tensorrtx_tpu_torch.core.registry import ModelDef, register
from tensorrtx_tpu_torch.models import _yolo_blocks as B
from tensorrtx_tpu_torch.models import _yolo_qchain as Q
from tensorrtx_tpu_torch.ops import detect as D
from tensorrtx_tpu_torch.ops import nn as ops
from tensorrtx_tpu_torch.ops.nms import select_and_nms

SCALES = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

STRIDES = (8, 16, 32)


@dataclasses.dataclass
class Yolo11Cfg:
    """The JAX package's Yolo11Cfg, field for field, so an engine dir's
    meta.json loads in either package. This slice serves task="det"."""
    scale: str = "n"
    task: str = "det"
    num_classes: int = 80        # kNumClass
    input_h: int = 640
    input_w: int = 640
    conf_thresh: float = 0.5     # kConfThresh
    nms_thresh: float = 0.45     # kNmsThresh
    max_det: int = 300           # NMS buffer slots
    kpt_conf_thresh: float = 0.5
    num_kpts: int = 17
    reg_max: int = 16
    postprocess: str = "nms"     # "nms" | "raw" (per-anchor decode outputs)

    @property
    def multipliers(self):
        return SCALES[self.scale]


def _check_cfg(cfg: Yolo11Cfg):
    if cfg.task != "det":
        raise NotImplementedError(f"yolo11 task {cfg.task!r} is not ported yet; "
                                  "this package serves task='det'")
    if cfg.postprocess not in ("nms", "raw"):
        raise NotImplementedError(f"yolo11 postprocess {cfg.postprocess!r} is not ported")


def _chans(cfg: Yolo11Cfg):
    gd, gw, maxc = cfg.multipliers
    return (lambda x: B.get_width(x, gw, maxc)), (lambda x: B.get_depth(x, gd))


# ---------------------------------------------------------------------------
# param tree (numpy HWIO; byte-equal to the JAX package's build_params)
# ---------------------------------------------------------------------------

def _backbone_p(wm, cfg: Yolo11Cfg):
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


def _neck_p(wm, cfg: Yolo11Cfg):
    w, d = _chans(cfg)
    c3k = cfg.scale in ("m", "l", "x")
    return {
        "m9": B.sppf_p(wm, "model.9", w(1024), w(1024)),
        "m10": B.c2psa_p(wm, "model.10", w(1024), w(1024), d(2)),
        "m13": B.c3k2_p(wm, "model.13", w(1024) + w(512), w(512), d(2), c3k, e=0.5),
        "m16": B.c3k2_p(wm, "model.16", w(512) + w(512), w(256), d(2), c3k, e=0.5),
        "m17": B.conv_p(wm, "model.17", w(256), w(256), 3),
        "m19": B.c3k2_p(wm, "model.19", w(256) + w(512), w(512), d(2), c3k, e=0.5),
        "m20": B.conv_p(wm, "model.20", w(512), w(512), 3),
        "m22": B.c3k2_p(wm, "model.22", w(512) + w(1024), w(1024), d(2), True, e=0.5),
    }


def _det_head_p(wm, cfg: Yolo11Cfg, head: str, nc: int):
    w, _ = _chans(cfg)
    chans = [w(256), w(512), w(1024)]
    c2 = max(16, w(256) // 4, cfg.reg_max * 4)
    c3 = max(w(256), min(nc, 100))
    p: Dict = {"cv2": [], "cv3": []}
    for i, ci in enumerate(chans):
        p["cv2"].append({
            "a": B.conv_p(wm, f"{head}.cv2.{i}.0", ci, c2, 3),
            "b": B.conv_p(wm, f"{head}.cv2.{i}.1", c2, c2, 3),
            "c": wm.conv2d(f"{head}.cv2.{i}.2", cfg.reg_max * 4, c2, (1, 1)),
        })
        p["cv3"].append({
            "a0": B.conv_p(wm, f"{head}.cv3.{i}.0.0", ci, ci, 3, groups=ci),
            "a1": B.conv_p(wm, f"{head}.cv3.{i}.0.1", ci, c3, 1),
            "b0": B.conv_p(wm, f"{head}.cv3.{i}.1.0", c3, c3, 3, groups=c3),
            "b1": B.conv_p(wm, f"{head}.cv3.{i}.1.1", c3, c3, 1),
            "c": wm.conv2d(f"{head}.cv3.{i}.2", nc, c3, (1, 1)),
        })
    return p


def build_params(wm, cfg: Yolo11Cfg):
    _check_cfg(cfg)
    return {
        "backbone": _backbone_p(wm, cfg),
        "neck": _neck_p(wm, cfg),
        "head": _det_head_p(wm, cfg, "model.23", cfg.num_classes),
    }


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------

class Yolo11(nn.Module):
    """YOLO11 det built from an OIHW tensor tree (`params_from_jax` of a
    `build_params` tree). Submodule names mirror the tree's keys
    (``backbone.m0``, ``neck.m10.m.0.attn.qkv``, ``head.cv2.0.a``)."""

    def __init__(self, cfg: Yolo11Cfg, params):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        bb, nk, hd = params["backbone"], params["neck"], params["head"]
        self.backbone = nn.ModuleDict({
            "m0": B.Conv(bb["m0"], stride=2),
            "m1": B.Conv(bb["m1"], stride=2),
            "m2": B.C3k2(bb["m2"]),
            "m3": B.Conv(bb["m3"], stride=2),
            "m4": B.C3k2(bb["m4"]),
            "m5": B.Conv(bb["m5"], stride=2),
            "m6": B.C3k2(bb["m6"]),
            "m7": B.Conv(bb["m7"], stride=2),
            "m8": B.C3k2(bb["m8"]),
        })
        self.neck = nn.ModuleDict({
            "m9": B.SPPF(nk["m9"]),
            "m10": B.C2PSA(nk["m10"]),
            "m13": B.C3k2(nk["m13"]),
            "m16": B.C3k2(nk["m16"]),
            "m17": B.Conv(nk["m17"], stride=2),
            "m19": B.C3k2(nk["m19"]),
            "m20": B.Conv(nk["m20"], stride=2),
            "m22": B.C3k2(nk["m22"]),
        })
        self.head = nn.ModuleDict({
            "cv2": nn.ModuleList(nn.ModuleDict({
                "a": B.Conv(q["a"]), "b": B.Conv(q["b"]),
                "c": B.Conv(q["c"], act=False)}) for q in hd["cv2"]),
            "cv3": nn.ModuleList(nn.ModuleDict({
                "a0": B.Conv(r["a0"]), "a1": B.Conv(r["a1"]),
                "b0": B.Conv(r["b0"]), "b1": B.Conv(r["b1"]),
                "c": B.Conv(r["c"], act=False)}) for r in hd["cv3"]),
        })
        # float32 constants kept off the module state, so a dtype cast of
        # the module leaves them alone
        self._grid = D.make_anchor_grid(cfg.input_h, cfg.input_w, STRIDES)
        self._grid_on: Dict[torch.device, tuple] = {}

    def _anchor_grid(self, device):
        g = self._grid_on.get(device)
        if g is None:
            g = tuple(torch.from_numpy(a).to(device) for a in self._grid)
            self._grid_on[device] = g
        return g

    def _features(self, x):
        m = self.backbone
        x = m["m1"](m["m0"](x))
        x = m["m3"](m["m2"](x))
        c4 = m["m4"](x)
        c6 = m["m6"](m["m5"](c4))
        x = m["m8"](m["m7"](c6))
        n = self.neck
        p5_in = n["m10"](n["m9"](x))
        p4_mid = n["m13"](torch.cat([ops.upsample_nearest(p5_in), c6], dim=1))
        p3 = n["m16"](torch.cat([ops.upsample_nearest(p4_mid), c4], dim=1))
        p4 = n["m19"](torch.cat([n["m17"](p3), p4_mid], dim=1))
        p5 = n["m22"](torch.cat([n["m20"](p4), p5_in], dim=1))
        return p3, p4, p5

    def _head(self, feats):
        """Per level: box branch and class branch, as NHWC views of the
        channels_last outputs."""
        box_lv, cls_lv = [], []
        for f, q, r in zip(feats, self.head["cv2"], self.head["cv3"]):
            box = q["c"](q["b"](q["a"](f)))
            cls = r["c"](r["b1"](r["b0"](r["a1"](r["a0"](f)))))
            box_lv.append(box.permute(0, 2, 3, 1))
            cls_lv.append(cls.permute(0, 2, 3, 1))
        return box_lv, cls_lv

    def decode_det(self, box_lv, cls_lv):
        """The det tail from the head's NHWC outputs: DFL ltrb and best
        class per level, concatenated level-major like the reference
        plugin, box decode, then the raw outputs or select + NMS."""
        cfg = self.cfg
        b = box_lv[0].shape[0]
        ltrb, conf, cls_id = [], [], []
        for box, cls in zip(box_lv, cls_lv):
            ltrb.append(ops.dfl(box, cfg.reg_max).reshape(b, -1, 4))
            c, k = D.best_class(cls)
            conf.append(c.reshape(b, -1))
            cls_id.append(k.reshape(b, -1))
        ltrb, conf, cls_id = torch.cat(ltrb, 1), torch.cat(conf, 1), torch.cat(cls_id, 1)
        points, strides = self._anchor_grid(ltrb.device)
        boxes = D.decode_boxes_ltrb(ltrb, points, strides)
        if cfg.postprocess == "raw":
            return {"boxes": boxes, "conf": conf, "cls": cls_id}
        return select_and_nms(boxes, conf, cls_id, cfg.conf_thresh,
                              cfg.nms_thresh, cfg.max_det).as_dict()

    def forward(self, x):
        """x: (B, H, W, 3) NHWC frames in the module's dtype."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.decode_det(*self._head(self._features(x)))


def apply_chain(module: Yolo11, x, cfg: Yolo11Cfg, ctx):
    """Int8-resident chain mirror of the det forward (the JAX package's
    `yolo11.apply_chain` for ``enter="m3"``, on the plain graph).

    x: (B, H, W, 3) letterboxed NHWC frames in the float islands' dtype.
    The 160² stem (m0, m1, m2) runs in float through the module, then the
    chain enters at m3: every conv is int8×int8→int32 with a fused
    dequant + bias + act + requant epilogue and every activation between
    them is int8 (ops/qchain.py); C2PSA is a float island; the head's last
    1×1s exit in float into the decode tail. `ctx` is an `ops.qchain.ChainCtx`:
    tap mode runs this same body in float for calibration, run mode serves
    int8. The JAX mirror's batch fold and s2d stem are TPU layout rewrites
    that keep the slot order and the scales (a fold is a reshape; the
    columns of block-diagonal weights carry the unfolded maxima), so the
    slots here are JAX's one for one and any batch ≥ 1 serves."""
    if cfg.task != "det":
        raise NotImplementedError("the chained int8 tier covers the det task")
    bb, nk, hd = module.backbone, module.neck, module.head
    xf = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xf = bb["m2"](bb["m1"](bb["m0"](xf)))
    x = ctx.quant_in(xf.permute(0, 2, 3, 1).contiguous())
    x = Q.qconv_a(ctx, bb["m3"], x, stride=2)
    c4 = Q.qc3k2_a(ctx, bb["m4"], x)
    x = Q.qconv_a(ctx, bb["m5"], c4, stride=2)
    c6 = Q.qc3k2_a(ctx, bb["m6"], x)
    x = Q.qc3k2_a(ctx, bb["m8"], Q.qconv_a(ctx, bb["m7"], c6, stride=2))
    p5_in = Q.qc2psa_a(ctx, nk["m10"], Q.qsppf_a(ctx, nk["m9"], x))
    p4_mid = Q.qc3k2_a(ctx, nk["m13"], ctx.concat([ctx.upsample(p5_in), c6]))
    p3 = Q.qc3k2_a(ctx, nk["m16"], ctx.concat([ctx.upsample(p4_mid), c4]))
    p4 = Q.qc3k2_a(ctx, nk["m19"], ctx.concat([Q.qconv_a(ctx, nk["m17"], p3, stride=2),
                                              p4_mid]))
    x = Q.qconv_a(ctx, nk["m20"], p4, stride=2)
    p5 = Q.qc3k2_a(ctx, nk["m22"], ctx.concat([x, p5_in]))
    box_lv, cls_lv = [], []
    for f, q, r in zip((p3, p4, p5), hd["cv2"], hd["cv3"]):
        box, cls = Q.qdet_head_lv(ctx, q, r, f)
        box_lv.append(box)
        cls_lv.append(cls)
    return module.decode_det(box_lv, cls_lv)


# the JAX entry's letterbox_s2d factor; the port letterboxes to full frames
apply_chain.factor = 4
apply_chain.supports = lambda cfg: cfg.task == "det"
# the float islands of the chain: the modules it calls in float
apply_chain.float_modules = ("backbone.m0", "backbone.m1", "backbone.m2", "neck.m10")


def _input_shape(cfg: Yolo11Cfg):
    return (cfg.input_h, cfg.input_w, 3)


register(ModelDef(
    name="yolo11",
    build_params=build_params,
    module=Yolo11,
    default_cfg=Yolo11Cfg,
    input_shape=_input_shape,
    apply_chain=apply_chain,
    doc="YOLO11 det (reference: yolo11/)",
))

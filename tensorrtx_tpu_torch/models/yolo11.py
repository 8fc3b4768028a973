"""YOLO11 det, seg, pose, obb and cls — the port's main path.

Reference: yolo11/src/model.cpp (buildEngineYolo11Cls:33, Det:138, Seg:509,
Pose:801, Obb:1092), yolo11/src/block.cpp, yolo11/plugin/yololayer.cu. The
JAX counterpart is tensorrtx_tpu/models/yolo11.py (`apply` →
`_apply_from_feats3`, and `_apply_cls`).

The module takes NHWC frames (as the JAX ``apply`` does) and returns the
fixed `Detections` buffer (with ``extras``, and seg's ``masks``), with
``postprocess="raw"`` the per-anchor boxes, confidences, class ids, extras
and seg's proto, with ``postprocess="nmsfree"`` the gated top-k; cls
returns the (B, num_classes) logits. Backbone, neck and heads run in NCHW
channels_last; DFL, decode, NMS and the masks in float32.

Scale multipliers (yolo11_det.cpp:115-160):
  n: gd=.50 gw=.25 maxc=1024 | s: .50/.50/1024 | m: .50/1.0/512
  l: 1.0/1.0/512 | x: 1.0/1.5/512
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from tensorrtx_tpu_torch.core.registry import ModelDef, register
from tensorrtx_tpu_torch.models import _yolo_blocks as B
from tensorrtx_tpu_torch.models import _yolo_qchain as Q
from tensorrtx_tpu_torch.ops import detect as D
from tensorrtx_tpu_torch.ops import nn as ops
from tensorrtx_tpu_torch.ops.nms import select_and_nms, select_topk

SCALES = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

STRIDES = (8, 16, 32)
TASKS = ("det", "seg", "pose", "obb", "cls")
POSTPROCESS = ("nms", "raw", "nmsfree")


@dataclasses.dataclass
class Yolo11Cfg:
    """The JAX package's Yolo11Cfg, field for field, so an engine dir's
    meta.json loads in either package."""
    scale: str = "n"
    task: str = "det"            # det | seg | pose | obb | cls
    num_classes: int = 80        # kNumClass (pose: 1, obb: 15, cls: 1000)
    input_h: int = 640           # obb: 1024; cls: 224
    input_w: int = 640
    conf_thresh: float = 0.5     # kConfThresh
    nms_thresh: float = 0.45     # kNmsThresh
    max_det: int = 300           # NMS buffer slots
    kpt_conf_thresh: float = 0.5
    num_kpts: int = 17
    reg_max: int = 16
    postprocess: str = "nms"     # "nms" | "raw" (per-anchor decode outputs) | "nmsfree"

    @property
    def multipliers(self):
        return SCALES[self.scale]


def _check_cfg(cfg: Yolo11Cfg):
    if cfg.task not in TASKS:
        raise ValueError(f"yolo11 task {cfg.task!r}: one of {TASKS}")
    if cfg.postprocess not in POSTPROCESS:
        raise ValueError(f"yolo11 postprocess {cfg.postprocess!r}: one of {POSTPROCESS}")


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


def _extra_branch_p(wm, cfg: Yolo11Cfg, name: str, cmid: int, cout: int):
    """seg mask-coefficient / pose keypoint / obb angle branch per level:
    Conv3x3, Conv3x3, then a plain 1×1 with bias."""
    w, _ = _chans(cfg)
    return [{
        "a": B.conv_p(wm, f"{name}.{i}.0", ci, cmid, 3),
        "b": B.conv_p(wm, f"{name}.{i}.1", cmid, cmid, 3),
        "c": wm.conv2d(f"{name}.{i}.2", cout, cmid, (1, 1)),
    } for i, ci in enumerate([w(256), w(512), w(1024)])]


def _proto_p(wm, cfg: Yolo11Cfg):
    w, _ = _chans(cfg)
    c_ = max(w(256) // 4, 32)
    # ConvTranspose2d(c_, c_, 2, 2): torch weight (in, out, 2, 2), kept in
    # the JAX tree as (kh, kw, out, in)
    up_w = wm.tensor("model.23.proto.upsample.weight", (c_, c_, 2, 2))
    return {
        "cv1": B.conv_p(wm, "model.23.proto.cv1", w(256), c_, 3),
        "up_w": np.transpose(up_w, (2, 3, 1, 0)),
        "up_b": wm.vec("model.23.proto.upsample.bias", c_),
        "cv2": B.conv_p(wm, "model.23.proto.cv2", c_, c_, 3),
        "cv3": B.conv_p(wm, "model.23.proto.cv3", c_, 32, 1),
    }


def _build_cls_params(wm, cfg: Yolo11Cfg):
    """Cls graph = backbone 0..8, C2PSA at model.9, Classify head at model.10
    (1×1 to 1280, global average pool, linear; raw logits out),
    model.cpp:33-137."""
    w, d = _chans(cfg)
    return {
        "backbone": _backbone_p(wm, cfg),
        "cls_head": {
            "m9": B.c2psa_p(wm, "model.9", w(1024), w(1024), d(2)),
            "m10_conv": B.conv_p(wm, "model.10.conv", w(1024), 1280, 1),
            "m10_linear": wm.linear("model.10.linear", cfg.num_classes, 1280),
        },
    }


def build_params(wm, cfg: Yolo11Cfg):
    _check_cfg(cfg)
    if cfg.task == "cls":
        return _build_cls_params(wm, cfg)
    p = {
        "backbone": _backbone_p(wm, cfg),
        "neck": _neck_p(wm, cfg),
        "head": _det_head_p(wm, cfg, "model.23", cfg.num_classes),
    }
    w, _ = _chans(cfg)
    if cfg.task == "seg":
        p["cv4"] = _extra_branch_p(wm, cfg, "model.23.cv4", max(w(256) // 4, 32), 32)
        p["proto"] = _proto_p(wm, cfg)
    elif cfg.task == "pose":
        kpt_ch = cfg.num_kpts * 3
        p["cv4"] = _extra_branch_p(wm, cfg, "model.23.cv4", max(w(256) // 4, kpt_ch), kpt_ch)
    elif cfg.task == "obb":
        p["cv4"] = _extra_branch_p(wm, cfg, "model.23.cv4", max(w(256) // 4, 1), 1)
    return p


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------

def _backbone_m(bb):
    return nn.ModuleDict({
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


class Proto(nn.Module):
    """seg prototype masks from P3 (the JAX package's ``_proto_a``):
    Conv3x3, the 2×2 stride-2 transposed conv (``up_w`` in torch's
    (in, out, kh, kw) layout) + SiLU, Conv3x3, Conv1x1 to 32 channels."""

    def __init__(self, p):
        super().__init__()
        self.cv1 = B.Conv(p["cv1"])
        self.register_buffer("up_w", p["up_w"])
        self.register_buffer("up_b", p["up_b"])
        self.cv2 = B.Conv(p["cv2"])
        self.cv3 = B.Conv(p["cv3"])

    def forward(self, x):
        y = ops.silu(ops.conv_transpose2d(self.cv1(x), self.up_w, self.up_b, stride=2))
        return self.cv3(self.cv2(y))


def _masks(proto: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """sigmoid(proto · coeffs) per kept slot in float32 (yolo11_seg.cpp:36-60):
    proto (B, 32, h, w), coeffs (B, N, 32) → (B, N, h, w)."""
    p = proto.permute(0, 2, 3, 1).float()
    b, h, w, c = p.shape
    m = torch.bmm(coeffs, p.reshape(b, h * w, c).transpose(1, 2))
    return torch.sigmoid(m).reshape(b, -1, h, w)


class AnchorFreeDet(nn.Module):
    """The task tail the anchor-free families share (the JAX package's
    ``_decode_levels`` + ``_decode_det``/``_decode_and_nms``, used by its
    yolo11, yolov8, yolov10 and yolo26): the head per level, the cv4
    branch, the decode, the selection, seg's masks. A subclass sets
    ``cfg`` and calls `_init_tail` with its param tree and strides.

    ``postprocess``: "raw" returns the per-anchor outputs, "nms" select +
    NMS, "nmsfree" (yolo11) or "topk" (yolov10, yolo26) the gated top-k."""

    def _init_tail(self, params, strides=STRIDES):
        if "cv4" in params:
            self.cv4 = nn.ModuleList(B.branch3_m(q) for q in params["cv4"])
        if "proto" in params:
            self.proto = Proto(params["proto"])
        # float32 constants kept off the module state, so a dtype cast of
        # the module leaves them alone
        self._grid = D.make_anchor_grid(self.cfg.input_h, self.cfg.input_w, strides)
        self._grid_on: Dict[torch.device, tuple] = {}

    @staticmethod
    def _det_head_m(hd) -> nn.ModuleDict:
        """yolo11's head (also yolov10's and yolo26's one2one head): a box
        branch (`B.branch3_m`) and a class branch of two depthwise +
        pointwise pairs and a 1×1 exit, per level."""
        return nn.ModuleDict({
            "cv2": nn.ModuleList(B.branch3_m(q) for q in hd["cv2"]),
            "cv3": nn.ModuleList(nn.ModuleDict({
                "a0": B.Conv(r["a0"]), "a1": B.Conv(r["a1"]),
                "b0": B.Conv(r["b0"]), "b1": B.Conv(r["b1"]),
                "c": B.Conv(r["c"], act=False)}) for r in hd["cv3"]),
        })

    def _anchor_grid(self, device):
        g = self._grid_on.get(device)
        if g is None:
            g = tuple(torch.from_numpy(a).to(device) for a in self._grid)
            self._grid_on[device] = g
        return g

    def _head(self, feats):
        """Per level: box branch, then class branch (`_det_head_m`), as
        NHWC views of the channels_last outputs."""
        box_lv, cls_lv = [], []
        for f, q, r in zip(feats, self.head["cv2"], self.head["cv3"]):
            box = B.branch3(q, f)
            cls = r["c"](r["b1"](r["b0"](r["a1"](r["a0"](f)))))
            box_lv.append(box.permute(0, 2, 3, 1))
            cls_lv.append(cls.permute(0, 2, 3, 1))
        return box_lv, cls_lv

    def _extras(self, feats):
        """The cv4 branch per level, flattened level-major and row-major like
        the plugin (the JAX package's ``_flatten_levels``): (B, ΣN, E) in
        float32."""
        outs = []
        for f, q in zip(feats, self.cv4):
            y = B.branch3(q, f)
            outs.append(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1]))
        return torch.cat(outs, 1).float()

    def _ltrb(self, box_lv):
        """(B, ΣN, 4) float32 distances from the box levels: the DFL decode."""
        b = box_lv[0].shape[0]
        return torch.cat([ops.dfl(box, self.cfg.reg_max).reshape(b, -1, 4) for box in box_lv], 1)

    def decode(self, box_lv, cls_lv, feats=None):
        """The task tail from the head's NHWC outputs (``feats``, the
        feature maps, feed the cv4 branch and seg's proto): the ltrb
        distances (`_ltrb`) and best class per level, concatenated
        level-major like the reference plugin, the box decode (obb:
        rotated (cx, cy, w, h) and the angle), pose's keypoints or seg's
        mask coefficients as extras, then the raw outputs, the gated top-k
        or select + NMS, with seg's masks for the kept slots."""
        cfg = self.cfg
        task = getattr(cfg, "task", "det")
        b = box_lv[0].shape[0]
        conf, cls_id = [], []
        for cls in cls_lv:
            c, k = D.best_class(cls)
            conf.append(c.reshape(b, -1))
            cls_id.append(k.reshape(b, -1))
        ltrb, conf, cls_id = self._ltrb(box_lv), torch.cat(conf, 1), torch.cat(cls_id, 1)
        points, strides = self._anchor_grid(ltrb.device)
        extras = None
        if task == "obb":
            cx, cy, w, h, ang = D.decode_obb(ltrb, self._extras(feats)[..., 0], points, strides)
            boxes = torch.stack([cx, cy, w, h], dim=-1)
            extras = ang[..., None]
        else:
            boxes = D.decode_boxes_ltrb(ltrb, points, strides)
            if task == "pose":
                extras = D.decode_pose(self._extras(feats), points, strides, boxes,
                                       cfg.kpt_conf_thresh)
            elif task == "seg":
                extras = self._extras(feats)
        if cfg.postprocess == "raw":
            out = {"boxes": boxes, "conf": conf, "cls": cls_id}
            if extras is not None:
                out["extras"] = extras
            if task == "seg":
                out["proto"] = self.proto(feats[0]).permute(0, 2, 3, 1)
            return out
        if cfg.postprocess in ("nmsfree", "topk"):
            return select_topk(boxes, conf, cls_id, cfg.conf_thresh, cfg.max_det,
                               extras=extras).as_dict()
        dets = select_and_nms(boxes, conf, cls_id, cfg.conf_thresh, cfg.nms_thresh,
                              cfg.max_det, extras=extras, obb=task == "obb")
        out = dets.as_dict()
        if task == "seg":
            out["masks"] = _masks(self.proto(feats[0]), dets.extras)
        return out


class Yolo11(AnchorFreeDet):
    """YOLO11 built from an OIHW tensor tree (`params_from_jax` of a
    `build_params` tree). Submodule names mirror the tree's keys
    (``backbone.m0``, ``neck.m10.m.0.attn.qkv``, ``head.cv2.0.a``,
    ``cv4.0.a``, ``proto.up_w``, ``cls_head.m10_linear``), which is what
    `core.convert.params_to_jax` writes an engine dir's keys from."""

    def __init__(self, cfg: Yolo11Cfg, params):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        self.backbone = _backbone_m(params["backbone"])
        if cfg.task == "cls":
            ch = params["cls_head"]
            self.cls_head = nn.ModuleDict({
                "m9": B.C2PSA(ch["m9"]),
                "m10_conv": B.Conv(ch["m10_conv"]),
                "m10_linear": B.Linear(ch["m10_linear"]),
            })
            return
        nk = params["neck"]
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
        self.head = self._det_head_m(params["head"])
        self._init_tail(params)

    def _backbone(self, x):
        m = self.backbone
        x = m["m1"](m["m0"](x))
        x = m["m3"](m["m2"](x))
        c4 = m["m4"](x)
        c6 = m["m6"](m["m5"](c4))
        return m["m8"](m["m7"](c6)), c4, c6

    def _features(self, x):
        x, c4, c6 = self._backbone(x)
        n = self.neck
        p5_in = n["m10"](n["m9"](x))
        p4_mid = n["m13"](torch.cat([ops.upsample_nearest(p5_in), c6], dim=1))
        p3 = n["m16"](torch.cat([ops.upsample_nearest(p4_mid), c4], dim=1))
        p4 = n["m19"](torch.cat([n["m17"](p3), p4_mid], dim=1))
        p5 = n["m22"](torch.cat([n["m20"](p4), p5_in], dim=1))
        return p3, p4, p5

    def _classify(self, x):
        """cls: backbone, C2PSA, 1×1 to 1280, global average pool, linear →
        (B, num_classes) logits in the module's dtype."""
        h = self.cls_head
        y = h["m10_conv"](h["m9"](self._backbone(x)[0]))
        return h["m10_linear"](ops.global_avg_pool(y))

    def forward(self, x):
        """x: (B, H, W, 3) NHWC frames in the module's dtype."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if self.cfg.task == "cls":
            return self._classify(x)
        feats = self._features(x)
        return self.decode(*self._head(feats), feats)


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
    return module.decode(box_lv, cls_lv)


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
    doc="YOLO11 det/seg/pose/obb/cls (reference: yolo11/)",
))

"""Int8-resident chain twins of the shared YOLO blocks (`_yolo_blocks`).

The port of the JAX package's `tensorrtx_tpu/models/_yolo_qchain.py`. Each
helper mirrors its float twin's dataflow, with every op routed through an
`ops.qchain.ChainCtx`, so one body serves the calibration (tap) pass and
the int8 serving (run) pass and the scale and weight slots line up by
construction. The weights are the port's modules' (folded `Conv.w`, OIHW,
and `Conv.b`); chain tensors are NHWC.

Reference analog: inside a TensorRT int8 engine each of these blocks is an
int8-in/int8-out region with fused requant epilogues (yolo11/src/model.cpp
USE_INT8 + calibrator).
"""

from __future__ import annotations

from tensorrtx_tpu_torch.ops.qchain import ChainCtx, QTensor


def _ch(x) -> int:
    return (x.q if isinstance(x, QTensor) else x).shape[-1]


def qconv_a(ctx: ChainCtx, m, x, stride: int = 1, act: bool = True):
    """A `_yolo_blocks.Conv` module as a chain conv."""
    return ctx.conv(x, m.w, m.b, act="silu" if act else None, stride=stride)


def qbottleneck_a(ctx, m, x, shortcut=True):
    y = qconv_a(ctx, m.cv1, x)
    y = qconv_a(ctx, m.cv2, y)
    if shortcut and _ch(x) == _ch(y):
        return ctx.add(x, y)
    return y


def qc3k_a(ctx, m, x, shortcut=True):
    y1 = qconv_a(ctx, m.cv1, x)
    y2 = qconv_a(ctx, m.cv2, x)
    for b in m.m:
        y1 = qbottleneck_a(ctx, b, y1, shortcut)
    return qconv_a(ctx, m.cv3, ctx.concat([y1, y2]))


def qc3k2_a(ctx, m, x, shortcut=True):
    y = qconv_a(ctx, m.cv1, x)
    c_ = _ch(y) // 2
    parts = ctx.split(y, (c_, c_))
    cur = parts[1]
    for b in m.m:
        cur = (qc3k_a(ctx, b, cur, shortcut) if hasattr(b, "cv3")
               else qbottleneck_a(ctx, b, cur, shortcut))
        parts.append(cur)
    return qconv_a(ctx, m.cv2, ctx.concat(parts))


def qsppf_a(ctx, m, x):
    y = qconv_a(ctx, m.cv1, x)
    p1 = ctx.maxpool(y, m.k)
    p2 = ctx.maxpool(p1, m.k)
    p3 = ctx.maxpool(p2, m.k)
    return qconv_a(ctx, m.cv2, ctx.concat([y, p1, p2, p3]))


def qc2psa_a(ctx, m, x):
    """The C2PSA attention stack as a float island in the module's dtype
    (TensorRT likewise leaves these layers in float inside an int8 engine),
    re-entering the chain at its exit. The NHWC tensor is the module's
    NCHW channels_last input without a copy."""
    xf = ctx.to_float(x)
    y = m(xf.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return ctx.from_float(y.contiguous())


# C2f (yolov8) and C3 (yolov5) run through the c3k2/c3k mirrors unchanged:
# the same dataflow, the kernel sizes in the weights (their float twins are
# aliased the same way in `_yolo_blocks`)
qc2f_a = qc3k2_a
qc3_a = qc3k_a


def qbranch3(ctx, q, f):
    """A plain a → b conv pair and a 1×1 float-out exit (yolov8's box AND
    class branches: v8 has no depthwise pair in its class branch)."""
    y = qconv_a(ctx, q["a"], f)
    y = qconv_a(ctx, q["b"], y)
    return ctx.conv_out(y, q["c"].w, q["c"].b)


def qdet_head_lv(ctx, q, r, f):
    """One detect-head level (box cv2 and class cv3 branches) on a chain
    tensor; the last 1×1s emit float logits, the decode tail's inputs."""
    box = qbranch3(ctx, q, f)
    z = ctx.dwconv(f, r["a0"].w, r["a0"].b)
    z = qconv_a(ctx, r["a1"], z)
    z = ctx.dwconv(z, r["b0"].w, r["b0"].b)
    z = qconv_a(ctx, r["b1"], z)
    cls = ctx.conv_out(z, r["c"].w, r["c"].b)
    return box, cls

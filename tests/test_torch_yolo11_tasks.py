"""Port YOLO11 seg, pose, obb and cls (tensorrtx_tpu_torch) against the JAX
package on the CPU: the new ops (transposed conv, linear, pooling, pose and
obb decode, probiou), the selection with extras, rotated boxes and without
NMS, each task's raw outputs, its detections (seg's masks too) and cls's
logits, and the independent torch graph of tests/torch_refs from one .wts.

float32, scale n at 96² (cls at 64²); weights from one `RandomWeightMap`
seed (the two packages draw byte-equal trees) or from one .wts file;
inputs from numpy seeds.

Decisions at a threshold (a keypoint's confidence against 0.5, its place
against its box's edges, a pair's IoU against 0.45) may fall apart between
torch and XLA on a last-bit difference. Such an output is compared only
where no input lies within a stated ε of its threshold.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrtx_tpu.core.engine import Engine as JaxEngine
from tensorrtx_tpu.core.params import WeightMap as JaxWeightMap
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.models import yolo11 as jy
from tensorrtx_tpu.ops import detect as jd
from tensorrtx_tpu.ops import nms as jn
from tensorrtx_tpu.ops import nn as jnn
from tensorrtx_tpu_torch.core.convert import params_from_jax
from tensorrtx_tpu_torch.core.engine import Engine, build_engine
from tensorrtx_tpu_torch.core.params import WeightMap
from tensorrtx_tpu_torch.models import yolo11 as ty
from tensorrtx_tpu_torch.ops import detect as td
from tensorrtx_tpu_torch.ops import nms as tn
from tensorrtx_tpu_torch.ops import nn as tnn

H = 96
CLS_H = 64
NC = {"seg": 80, "pose": 1, "obb": 15, "cls": 1000}
NMS_THRESH = 0.45
KPT_THRESH = 0.5
EPS_CONF = 1e-6    # a keypoint's confidence this close to KPT_THRESH may gate apart
EPS_PX = 1e-3      # a keypoint this close (px) to an edge of its box may gate apart
EPS_IOU = 1e-4     # no candidate pair may lie this close to NMS_THRESH


def cfgs(task, **over):
    """(JAX cfg, port cfg) of a task at the test size."""
    size = CLS_H if task == "cls" else H
    kw = dict(task=task, num_classes=NC[task], input_h=size, input_w=size, **over)
    return dataclasses.replace(jy.Yolo11Cfg(), **kw), ty.Yolo11Cfg(**kw)


def jtree(p):
    return jax.tree.map(jnp.asarray, p)


def np_out(out):
    return ({k: np.asarray(v) for k, v in out.items()} if isinstance(out, dict)
            else np.asarray(out))


@pytest.fixture(scope="module")
def params():
    """Each task's parameter tree, drawn once (the packages' builders are
    byte-equal, `test_build_params_byte_equal`)."""
    return {t: jy.build_params(JaxRWM(seed=0), cfgs(t)[0]) for t in NC}


def run_both(params, task, x, **over):
    """The JAX engine and the port's on the same parameters and input."""
    jcfg, tcfg = cfgs(task, **over)
    exp = JaxEngine("yolo11", jtree(params[task]), jcfg, "fp32")(x)
    got = Engine("yolo11", params_from_jax(params[task]), tcfg, device="cpu")(x)
    return np_out(exp), np_out(got)


def keypoint_flips(got, exp, boxes_g, boxes_e, atol, eps_conf=EPS_CONF, eps_px=EPS_PX):
    """Decoded keypoints (..., 3K) of the port against JAX's: where neither
    is gated, (x, y, conf) within atol; where one is gated (−1) and the
    other not, the other's confidence must lie within eps_conf of the
    threshold or its (x, y) within eps_px of an edge of its box. Returns
    the number of such flips."""
    g = got.reshape(*got.shape[:-1], -1, 3)
    e = exp.reshape(*exp.shape[:-1], -1, 3)
    gg, ge = g[..., 2] == -1, e[..., 2] == -1
    both = ~gg & ~ge
    np.testing.assert_allclose(g[both], e[both], atol=atol)
    np.testing.assert_array_equal(g[gg & ge], e[gg & ge])
    flips = 0
    for side, other, bx in ((g, ge & ~gg, boxes_g), (e, gg & ~ge, boxes_e)):
        idx = np.argwhere(other)
        for i in idx:
            x, y, c = side[tuple(i)].astype(np.float64)
            b = bx[tuple(i[:-1])].astype(np.float64)
            edge = min(x - b[0], b[2] - x, y - b[1], b[3] - y)
            assert c - KPT_THRESH < eps_conf or edge < eps_px, (i, x, y, c, b)
        flips += len(idx)
    return flips


def assert_nms_decidable(boxes, conf, cls, conf_thresh, angles=None):
    """No same-class pair of candidates (conf ≥ conf_thresh) has an IoU
    (probiou with angles) within EPS_IOU of NMS_THRESH, in float64: NMS
    must then decide alike on last-bit differences of its inputs."""
    for bi in range(conf.shape[0]):
        sel = conf[bi] >= conf_thresh
        bx = boxes[bi][sel].astype(np.float64)
        if angles is None:
            iou = np.asarray(jn.box_iou_matrix(jnp.asarray(bx)))
        else:
            ob = np.concatenate([bx, angles[bi][sel][:, None]], -1)
            iou = np.asarray(jn.probiou_matrix(jnp.asarray(ob, jnp.float32)))
        same = cls[bi][sel][:, None] == cls[bi][sel][None, :]
        near = same & (np.abs(iou - NMS_THRESH) < EPS_IOU)
        np.fill_diagonal(near, False)
        assert not near.any(), f"image {bi}: a candidate pair within {EPS_IOU} of the threshold"


# ---------------------------------------------------------------------------
# (a) the new ops
# ---------------------------------------------------------------------------

def test_weight_map_linear_and_vec_match_jax(rng):
    raw = {"fc.weight": rng.normal(size=(7 * 5,)).astype(np.float32),
           "fc.bias": rng.normal(size=(7,)).astype(np.float32),
           "up.bias": rng.normal(size=(4,)).astype(np.float32)}
    jw, tw = JaxWeightMap(dict(raw)), WeightMap(dict(raw))
    j, t = jw.linear("fc", 7, 5), tw.linear("fc", 7, 5)
    assert t["w"].shape == (5, 7) and t["w"].flags.c_contiguous
    np.testing.assert_array_equal(t["w"], j["w"])
    np.testing.assert_array_equal(t["b"], j["b"])
    assert tw.linear("fc", 7, 5, bias=False)["b"] is None
    np.testing.assert_array_equal(tw.vec("up.bias", 4), jw.vec("up.bias", 4))


@pytest.mark.parametrize("bias", [True, False])
def test_conv_transpose2d_matches_jax(rng, bias):
    """The proto's 2×2 stride-2 transposed conv: the JAX tree's (kh, kw,
    out, in) kernel through `params_from_jax` is torch's (in, out, kh, kw)."""
    x = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    w = rng.normal(size=(2, 2, 6, 8)).astype(np.float32)        # (kh, kw, out, in)
    b = rng.normal(size=(6,)).astype(np.float32) if bias else None
    exp = np.asarray(jnn.conv_transpose2d(jnp.asarray(x), jnp.asarray(w),
                                          None if b is None else jnp.asarray(b), stride=2))
    tw = params_from_jax({"w": w})["w"]
    assert tw.shape == (8, 6, 2, 2)
    got = tnn.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), tw,
                               None if b is None else torch.from_numpy(b), stride=2)
    assert exp.shape == (2, 10, 12, 6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), exp, atol=1e-5)


def test_linear_and_global_avg_pool_match_jax(rng):
    x = rng.normal(size=(3, 4, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 10)).astype(np.float32)             # (in, out)
    b = rng.normal(size=(10,)).astype(np.float32)
    pooled = jnn.global_avg_pool(jnp.asarray(x))
    exp = np.asarray(jnn.linear(pooled, jnp.asarray(w), jnp.asarray(b)))
    tp = tnn.global_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tp.numpy(), np.asarray(pooled), atol=1e-6)
    got = tnn.linear(tp, torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), exp, atol=1e-5)
    np.testing.assert_allclose(tnn.linear(tp, torch.from_numpy(w)).numpy(),
                               np.asarray(jnn.linear(pooled, jnp.asarray(w))), atol=1e-5)


def test_decode_pose_matches_jax(rng):
    points, strides = jd.make_anchor_grid(H, H, (8, 16, 32))
    n = points.shape[0]
    kpt = rng.normal(0, 1.5, (2, n, 17 * 3)).astype(np.float32)
    cx = (points[:, 0] * strides)[None]
    cy = (points[:, 1] * strides)[None]
    half = rng.uniform(2, 40, (2, n, 2))
    boxes = np.stack([cx - half[..., 0], cy - half[..., 1], cx + half[..., 0],
                      cy + half[..., 1]], -1).astype(np.float32)
    exp = np.asarray(jd.decode_pose(jnp.asarray(kpt), jnp.asarray(points), jnp.asarray(strides),
                                    jnp.asarray(boxes), KPT_THRESH))
    got = td.decode_pose(torch.from_numpy(kpt), torch.from_numpy(points),
                         torch.from_numpy(strides), torch.from_numpy(boxes), KPT_THRESH).numpy()
    gated = exp.reshape(2, n, 17, 3)[..., 2] == -1
    assert 0.2 < gated.mean() < 0.9       # both gates act on these inputs
    assert keypoint_flips(got, exp, boxes, boxes, atol=1e-4) == 0


def test_decode_obb_matches_jax(rng):
    points, strides = jd.make_anchor_grid(H, H, (8, 16, 32))
    n = points.shape[0]
    ltrb = rng.uniform(0, 6, (2, n, 4)).astype(np.float32)
    ang = rng.normal(0, 2, (2, n)).astype(np.float32)
    exp = jd.decode_obb(jnp.asarray(ltrb), jnp.asarray(ang), jnp.asarray(points),
                        jnp.asarray(strides))
    got = td.decode_obb(torch.from_numpy(ltrb), torch.from_numpy(ang),
                        torch.from_numpy(points), torch.from_numpy(strides))
    for name, e, g, tol in zip(("cx", "cy", "w", "h", "angle"), exp, got,
                               (1e-3, 1e-3, 1e-4, 1e-4, 1e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=tol, err_msg=name)
    a = got[4].numpy()
    assert a.min() >= -math.pi / 4 - 1e-6 and a.max() <= 3 * math.pi / 4 + 1e-6


def rotated_boxes(rng, b, n, degenerate):
    """(b, n, 5) [cx, cy, w, h, angle]; with `degenerate`, every third box
    has w = 0 and every fifth h = 0."""
    cxy = rng.uniform(0, 60, (b, n, 2))
    wh = rng.uniform(4, 30, (b, n, 2))
    if degenerate:
        wh[:, ::3, 0] = 0.0
        wh[:, ::5, 1] = 0.0
    ang = rng.uniform(-math.pi / 4, 3 * math.pi / 4, (b, n, 1))
    ob = np.concatenate([cxy, wh, ang], -1).astype(np.float32)
    ob[:, 1::7] = ob[:, 0:-1:7][:, :ob[:, 1::7].shape[1]]      # exact duplicates
    return ob


@pytest.mark.parametrize("degenerate", [False, True])
def test_probiou_matrix_matches_jax(rng, degenerate):
    """Pairs of proper boxes agree within 1e-5. A degenerate box (w = 0 or
    h = 0) has a singular covariance, so the formula's log term takes a
    rounding residue (its own determinant, or the pair's) and gives NaN or
    a value set by that residue's sign and size, in either package: such
    pairs agree (within 1e-5, or both NaN) on at least 95 % of them and
    are otherwise NaN or within [0, 1]. Proper boxes give finite values."""
    ob = rotated_boxes(rng, 2, 64, degenerate)
    got = tn.probiou_matrix(torch.from_numpy(ob)).numpy()
    assert got.shape == (2, 64, 64)
    assert np.isfinite(got).all() != degenerate
    flat = (ob[..., 2] == 0) | (ob[..., 3] == 0)
    for i in range(2):
        exp = np.asarray(jn.probiou_matrix(jnp.asarray(ob[i])))
        pair = flat[i][:, None] | flat[i][None, :]
        np.testing.assert_allclose(got[i][~pair], exp[~pair], atol=1e-5)
        g, e = got[i][pair], exp[pair]
        agree = (np.abs(g - e) <= 1e-5) | (np.isnan(g) & np.isnan(e))
        assert agree.mean() >= 0.95 if degenerate else agree.size == 0
        assert (np.isnan(g) | ((g >= 0) & (g <= 1))).all()
    assert (got > 0.5).any() and (got < 0.1).any()


# ---------------------------------------------------------------------------
# (b) the selection: extras, rotated boxes, no NMS
# ---------------------------------------------------------------------------

def candidates(rng, b, n, nc=3):
    """Unsorted candidates with exact score ties and duplicated boxes; the
    tail of the scores under the gate."""
    cxy = rng.uniform(0, 100, (b, n, 2))
    wh = rng.uniform(5, 40, (b, n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0:-1:7][:, :boxes[:, 1::7].shape[1]]
    scores = rng.choice(np.linspace(0.1, 0.9, 9), (b, n)).astype(np.float32)
    classes = rng.integers(0, nc, (b, n)).astype(np.float32)
    return boxes, scores, classes


def assert_dets_equal(got, exp):
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]), err_msg=k)


@pytest.mark.parametrize("width", [32, 51], ids=["seg", "pose"])
def test_select_and_nms_with_extras_matches_jax(rng, width):
    """xyxy IoUs are min, max, products and one division, each correctly
    rounded in both packages, so near-threshold pairs decide alike here."""
    boxes, scores, classes = candidates(rng, 3, 400)
    extras = rng.normal(size=(3, 400, width)).astype(np.float32)
    args = (0.3, NMS_THRESH, 100)
    exp = jn.select_and_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                            *args, extras=jnp.asarray(extras)).as_dict()
    got = tn.select_and_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes), *args,
                            extras=torch.from_numpy(extras)).as_dict()
    assert got["extras"].shape == (3, 100, width)
    assert_dets_equal(got, exp)


def test_select_and_nms_obb_matches_jax(rng):
    """Rotated boxes: the probiou keep mask in torch ops, the angle carried
    as extras; candidates with exact score ties, duplicates and degenerate
    boxes."""
    ob = rotated_boxes(rng, 3, 400, degenerate=True)
    ob[..., :2] *= 3.0
    _, scores, classes = candidates(rng, 3, 400)
    boxes, ang = ob[..., :4], ob[..., 4:]
    assert_nms_decidable(boxes, scores, classes, 0.3, angles=ang[..., 0])
    args = (0.3, NMS_THRESH, 100)
    exp = jn.select_and_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                            *args, extras=jnp.asarray(ang), obb=True).as_dict()
    got = tn.select_and_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes), *args, extras=torch.from_numpy(ang),
                            obb=True).as_dict()
    counts = got["count"].numpy()
    assert (counts > 0).all() and (counts < (scores >= 0.3).sum(-1)).all()   # NMS removed some
    assert_dets_equal(got, exp)


@pytest.mark.parametrize("with_extras", [True, False])
def test_select_topk_matches_jax(rng, with_extras):
    boxes, scores, classes = candidates(rng, 2, 300)
    extras = rng.normal(size=(2, 300, 5)).astype(np.float32) if with_extras else None
    exp = jn.select_topk(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.5,
                         50, extras=None if extras is None else jnp.asarray(extras)).as_dict()
    got = tn.select_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), 0.5, 50,
                         extras=None if extras is None else torch.from_numpy(extras)).as_dict()
    assert ("extras" in got) == with_extras
    assert_dets_equal(got, exp)


# ---------------------------------------------------------------------------
# (c)-(e) the tasks against the JAX engine
# ---------------------------------------------------------------------------

def test_build_params_byte_equal(params):
    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap

    for task in NC:
        got = ty.build_params(RandomWeightMap(seed=0), cfgs(task)[1])
        jl, jdef = jax.tree_util.tree_flatten(params[task])
        tl, tdef = jax.tree_util.tree_flatten(got)
        assert jdef == tdef, task
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(a, b)


def check_task_outputs(task, got, exp):
    """The fields of a raw or nms output of one task against JAX's (numpy
    dicts of the same leaves and shapes): classes, counts and keep flags
    equal, scores within 1e-5, boxes within 1e-3 px, keypoints by
    `keypoint_flips`, other extras, proto and masks within 1e-5."""
    assert set(got) == set(exp)
    box = "boxes"
    if "conf" in exp:       # raw
        np.testing.assert_allclose(got["conf"], exp["conf"], atol=1e-5)
        np.testing.assert_array_equal(got["cls"], exp["cls"])
    else:
        for k in ("count", "valid", "classes"):
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
        np.testing.assert_allclose(got["scores"], exp["scores"], atol=1e-5)
    np.testing.assert_allclose(got[box], exp[box], atol=1e-3)
    if task == "pose":
        keypoint_flips(got["extras"], exp["extras"], got[box], exp[box], atol=1e-3)
    else:
        np.testing.assert_allclose(got["extras"], exp["extras"], atol=1e-5)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in exp.items()}
    if "proto" in exp:
        assert got["proto"].shape[-3:] == (H // 4, H // 4, 32)
        np.testing.assert_allclose(got["proto"], exp["proto"], atol=1e-5)
    if "masks" in exp:
        assert got["masks"].shape[-3:] == (189, H // 4, H // 4)     # min(max_det, anchors)
        np.testing.assert_allclose(got["masks"], exp["masks"], atol=1e-5)


@pytest.mark.parametrize("task", ["seg", "pose", "obb"])
def test_raw_outputs_match_jax(params, rng, task):
    x = rng.uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    exp, got = run_both(params, task, x, postprocess="raw")
    width = {"seg": 32, "pose": 51, "obb": 1}[task]
    assert got["extras"].shape == (2, 189, width)
    check_task_outputs(task, got, exp)


@pytest.mark.parametrize("task,postprocess", [("seg", "nms"), ("pose", "nms"), ("obb", "nms"),
                                              ("seg", "nmsfree")])
def test_detections_match_jax(params, rng, task, postprocess):
    """The served tail at a low conf_thresh (every anchor a candidate; seg's
    masks of all 300 slots). The candidates' pairs are first checked to lie
    off the IoU threshold (`assert_nms_decidable`) on JAX's raw outputs."""
    x = rng.uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    raw, _ = run_both(params, task, x, postprocess="raw")
    assert_nms_decidable(raw["boxes"], raw["conf"], raw["cls"], 0.05,
                         angles=raw["extras"][..., 0] if task == "obb" else None)
    exp, got = run_both(params, task, x, postprocess=postprocess, conf_thresh=0.05)
    assert (exp["count"] > 0).all()
    if postprocess == "nms":
        assert (exp["count"] < 189).all()
    check_task_outputs(task, got, exp)


@pytest.mark.parametrize("batch", [1, 3])
def test_cls_logits_match_jax(params, rng, batch):
    x = rng.uniform(0, 1, (batch, CLS_H, CLS_H, 3)).astype(np.float32)
    exp, got = run_both(params, "cls", x)
    assert got.shape == exp.shape == (batch, 1000)
    assert np.abs(exp).max() > 1e-2
    np.testing.assert_allclose(got, exp, atol=1e-5 * (1 + np.abs(exp).max()))


# ---------------------------------------------------------------------------
# (f) the independent torch graph, through one .wts
# ---------------------------------------------------------------------------

def oracle_engine(task, tmp_path, seed):
    from torch_refs.yolo11_torch import Yolo11Torch, randomize

    from tensorrtx_tpu_torch.core.wts import state_dict_to_wts

    tm = randomize(Yolo11Torch(scale="n", nc=NC[task], task=task), seed=seed).eval()
    wts = tmp_path / f"{task}.wts"
    state_dict_to_wts(str(wts), tm.state_dict())
    eng = build_engine("yolo11", str(wts), scale="n", task=task, num_classes=NC[task],
                       input_h=160, input_w=160, postprocess="raw", device="cpu")
    return tm, eng


def flat_levels(maps):
    return np.concatenate([t.numpy().reshape(t.shape[0], t.shape[1], -1).transpose(0, 2, 1)
                           for t in maps], 1)


@pytest.mark.parametrize("task", ["seg", "pose", "obb"])
def test_torch_reference_witness(tmp_path, rng, task):
    """The ultralytics-style torch graph (tests/torch_refs) → .wts → the
    port's build_engine, as `tests/test_yolo11_tasks.py` holds the JAX
    package: seg's coefficients and proto, pose's keypoints by the
    reference's formula, obb's angle."""
    tm, eng = oracle_engine(task, tmp_path, {"seg": 21, "pose": 22, "obb": 23}[task])
    x = rng.uniform(0, 1, (1, 3, 160, 160)).astype(np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    res = eng(np.transpose(x, (0, 2, 3, 1)))
    raw = flat_levels(out["cv4"])
    got = res["extras"].numpy()
    if task == "seg":
        np.testing.assert_allclose(got, raw, atol=2e-3)
        exp_proto = out["proto"].numpy().transpose(0, 2, 3, 1)
        tol = max(2e-3, 2e-5 * float(np.abs(exp_proto).max()))
        np.testing.assert_allclose(res["proto"].numpy(), exp_proto, atol=tol)
    elif task == "obb":
        exp = (1 / (1 + np.exp(-raw[..., 0])) - 0.25) * math.pi
        np.testing.assert_allclose(got[..., 0], exp, atol=1e-3)
        assert (res["boxes"].numpy()[..., 2:] >= 0).all()
    else:
        points, strides = jd.make_anchor_grid(160, 160, (8, 16, 32))
        k = raw.reshape(1, -1, 17, 3).astype(np.float64)
        kx = (k[..., 0] * 2 + points[None, :, None, 0] - 0.5) * strides[None, :, None]
        ky = (k[..., 1] * 2 + points[None, :, None, 1] - 0.5) * strides[None, :, None]
        kc = 1 / (1 + np.exp(-k[..., 2]))
        bx = res["boxes"].numpy()[:, :, None].astype(np.float64)
        ok = (kc >= KPT_THRESH) & (kx >= bx[..., 0]) & (kx <= bx[..., 2]) \
            & (ky >= bx[..., 1]) & (ky <= bx[..., 3])
        exp = np.where(ok[..., None], np.stack([kx, ky, kc], -1), -1.0).reshape(1, -1, 51)
        assert 0.05 < ok.mean() < 0.95
        keypoint_flips(got, exp, res["boxes"].numpy(), res["boxes"].numpy(), atol=1e-2)

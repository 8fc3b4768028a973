"""Port YOLOv8 (tensorrtx_tpu_torch.models.yolov8) against the JAX package
on the CPU: every (task, variant)'s parameter tree, raw outputs and
detections (seg's masks and pose's keypoints on matched slots), cls's
logits, the uint8 → detections `ServingPipeline`, the independent torch
graph of tests/torch_refs through one .wts, engine dirs in both
directions and the command line.

float32, scale n at 64²; weights from one `RandomWeightMap` seed (the two
packages draw byte-equal trees, `test_build_params_byte_equal`) or from a
.wts; inputs from numpy seeds. Tolerances: raw conf 1e-4, boxes 1e-2 px,
classes equal, extras 1e-4 (pose's keypoints by
`test_torch_yolo11_tasks.keypoint_flips`), proto 1e-4, cls logits
1e-4·(1 + max |logit|); detections: counts and classes equal, scores
within 1e-5, matched boxes' IoU ≥ 0.9999 (obb: coordinates within 1e-2
px), masks within 1e-5. A gate or an NMS is compared only where no input
lies within a stated ε of its threshold (`assert_gate_decidable`,
`test_torch_yolo11_tasks.assert_nms_decidable`).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tensorrtx_tpu.core.engine import Engine as JaxEngine
from tensorrtx_tpu.core.engine import load_engine as jax_load_engine
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.core.runner import ServingPipeline as JaxPipeline
from tensorrtx_tpu.models import yolov8 as jv8
from tensorrtx_tpu_torch import cli
from tensorrtx_tpu_torch.core.convert import params_from_jax
from tensorrtx_tpu_torch.core.engine import Engine, build_engine, load_engine
from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
from tensorrtx_tpu_torch.core.runner import ServingPipeline
from tensorrtx_tpu_torch.models import yolov8 as tv8
from tensorrtx_tpu.ops import nms as jn
from test_torch_yolo11_tasks import EPS_IOU, NMS_THRESH, jtree, keypoint_flips, np_out

H = 64
BUCKET = (80, 72)
EPS_CONF = 1e-6     # no candidate's confidence this close to the gate
# (task, variant) → num_classes; every graph the port serves
CONFIGS = {("det", ""): 80, ("seg", ""): 80, ("pose", ""): 1, ("obb", ""): 15,
           ("cls", ""): 1000, ("det", "p2"): 80, ("det", "5u"): 80}
IDS = [t + (f"-{v}" if v else "") for t, v in CONFIGS]
ANCHORS = {"": 64 + 16 + 4, "p2": 256 + 64 + 16 + 4, "5u": 64 + 16 + 4}


def cfgs(task, variant="", **over):
    kw = dict(task=task, variant=variant, num_classes=CONFIGS[task, variant], input_h=H,
              input_w=H, **over)
    return dataclasses.replace(jv8.Yolov8Cfg(), **kw), tv8.Yolov8Cfg(**kw)


# the input of the raw, detection and engine-dir tests
X = np.random.default_rng(0).uniform(0, 1, (2, H, H, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return {key: jv8.build_params(JaxRWM(seed=0), cfgs(*key)[0]) for key in CONFIGS}


_JITS = {}


def jax_apply(jm, params, x, *jcfgs):
    """The JAX package's ``jm.apply`` (what its fp32 `Engine` jits) under
    each of ``jcfgs`` on the same parameters and input, as ONE jitted
    program, so that XLA compiles the network once for all of them (the
    raw and the served outputs of a test share it); jitted programs are
    kept by model, cfgs and input shape. Returns numpy outputs, one per
    cfg."""
    key = (jm.__name__, tuple(repr(c) for c in jcfgs), x.shape)
    if key not in _JITS:
        _JITS[key] = jax.jit(lambda p, v: tuple(jm.apply(p, v, c) for c in jcfgs))
    return [np_out(o) for o in _JITS[key](jtree(params), x)]


@pytest.fixture(scope="module")
def jax_outs(params):
    """Per graph, what JAX computes on X in one program: cls's logits, or
    (the raw outputs, the served detections at the gate that
    `decidable_gate` picks on the port's raw outputs, that gate)."""
    cache = {}

    def get(key):
        if key not in cache:
            if key[0] == "cls":
                cache[key] = jax_apply(jv8, params[key], X, cfgs(*key)[0])[0]
            else:
                t = decidable_gate(port(params, key, X, postprocess="raw"), obb=key[0] == "obb")
                cache[key] = (*jax_apply(jv8, params[key], X, *served_cfgs(key, t)), t)
        return cache[key]
    return get


def served_cfgs(key, thresh):
    """The JAX cfgs (raw, served at ``thresh``) of a detection graph."""
    return cfgs(*key, postprocess="raw")[0], cfgs(*key, conf_thresh=thresh)[0]


def port(params, key, x, **over):
    """The port's engine on the same parameters and input."""
    return np_out(Engine("yolov8", params_from_jax(params[key]), cfgs(*key, **over)[1],
                         device="cpu")(x))


def _iou64(b):
    """(N, 4) xyxy → (N, N) IoU in float64."""
    b = b.astype(np.float64)
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    return np.where(inter > 0, inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-300),
                    0.0)


def assert_nms_decidable(boxes, conf, cls, conf_thresh, angles=None):
    """`test_torch_yolo11_tasks.assert_nms_decidable` with the xyxy IoU in
    numpy float64 (no XLA compile per candidate count): no same-class pair
    of candidates has an IoU (probiou with angles) within EPS_IOU of
    NMS_THRESH."""
    for bi in range(conf.shape[0]):
        sel = conf[bi] >= conf_thresh
        if angles is None:
            iou = _iou64(boxes[bi][sel])
        else:
            ob = np.concatenate([boxes[bi][sel], angles[bi][sel][:, None]], -1)
            iou = np.asarray(jn.probiou_matrix(ob.astype(np.float32)))
        same = cls[bi][sel][:, None] == cls[bi][sel][None, :]
        near = same & (np.abs(iou - NMS_THRESH) < EPS_IOU)
        np.fill_diagonal(near, False)
        assert not near.any(), f"image {bi}: a candidate pair within {EPS_IOU} of the threshold"


def frames(seed, b):
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, 256, (b, *BUCKET, 3), dtype=np.uint8)
    hw = np.stack([rng.integers(40, BUCKET[0] + 1, b), rng.integers(40, BUCKET[1] + 1, b)],
                  1).astype(np.int32)
    return fr, hw


def check_raw(task, got, exp):
    """Raw per-anchor outputs (numpy dicts) against JAX's."""
    assert set(got) == set(exp)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in exp.items()}
    np.testing.assert_allclose(got["conf"], exp["conf"], atol=1e-4)
    np.testing.assert_array_equal(got["cls"], exp["cls"])
    np.testing.assert_allclose(got["boxes"], exp["boxes"], atol=1e-2)
    if task == "pose":
        keypoint_flips(got["extras"], exp["extras"], got["boxes"], exp["boxes"], atol=1e-3)
    elif "extras" in exp:
        np.testing.assert_allclose(got["extras"], exp["extras"], atol=1e-4)
    if "proto" in exp:
        np.testing.assert_allclose(got["proto"], exp["proto"], atol=1e-4)


def assert_gate_decidable(conf, thresh):
    """No confidence lies within EPS_CONF of the gate, so the same
    candidates pass it on last-bit differences of the scores."""
    assert (np.abs(conf.astype(np.float64) - thresh) >= EPS_CONF).all()


def decidable_gate(raw, obb=False):
    """The lowest gate at which neither the gate nor NMS over its
    candidates has an input within ε of its threshold (`assert_gate_decidable`,
    `assert_nms_decidable`) on these raw outputs: 0.05 (every anchor), else
    the first of 16 gaps between distinct confidences, from the lowest up.
    With random weights the confidences sit in a narrow band and near-equal
    boxes are many, so the lowest gate need not be decidable."""
    vals = np.unique(raw["conf"].astype(np.float64))
    gaps = [(lo + hi) / 2 for lo, hi in zip(vals[:-1], vals[1:]) if hi - lo >= 2 * EPS_CONF]
    gates = [0.05] + gaps[::max(1, len(gaps) // 16)]
    for t in gates:
        try:
            assert_gate_decidable(raw["conf"], t)
            assert_nms_decidable(raw["boxes"], raw["conf"], raw["cls"], t,
                                 angles=raw["extras"][..., 0] if obb else None)
        except AssertionError:
            continue
        return t
    raise AssertionError(f"no decidable gate among {gates}")


def match_slots(got, exp, i, obb=False):
    """The valid slots of image i of two detection dicts paired one to one:
    each of the port's slots with JAX's slot of the same class whose box is
    nearest (two packages may order scores a last bit apart differently).
    Asserts counts equal, scores within 1e-5, IoU ≥ 0.9999 (obb, and a
    box with no area, as yolo26's raw ltrb regression gives with random
    weights: the coordinates within 1e-2 px). Returns the pairs."""
    n = int(exp["count"][i])
    assert int(got["count"][i]) == n
    gb, eb = got["boxes"][i][:n].astype(np.float64), exp["boxes"][i][:n].astype(np.float64)
    pairs, free = [], set(range(n))
    for a in range(n):
        cand = [j for j in free if exp["classes"][i][j] == got["classes"][i][a]]
        assert cand, f"image {i}: slot {a} has no partner of class {got['classes'][i][a]}"
        j = min(cand, key=lambda j: np.abs(gb[a] - eb[j]).max())
        free.discard(j)
        pairs.append((a, j))
        assert abs(got["scores"][i][a] - exp["scores"][i][j]) <= 1e-5
        if obb or (eb[j][2:] <= eb[j][:2]).any():     # no area: no IoU to compare
            assert np.abs(gb[a] - eb[j]).max() <= 1e-2, (a, j, gb[a], eb[j])
        else:
            assert _iou64(np.stack([gb[a], eb[j]]))[0, 1] >= 0.9999, (a, j, gb[a], eb[j])
    return pairs


def check_dets(task, got, exp):
    assert set(got) == set(exp)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in exp.items()}
    np.testing.assert_array_equal(got["count"], exp["count"])
    for i in range(exp["count"].shape[0]):
        pairs = match_slots(got, exp, i, obb=task == "obb")
        if not pairs:
            continue
        a, b = (np.array(p) for p in zip(*pairs))
        if task == "seg":
            np.testing.assert_allclose(got["masks"][i][a], exp["masks"][i][b], atol=1e-5)
        elif task == "pose":
            keypoint_flips(got["extras"][i][a], exp["extras"][i][b], got["boxes"][i][a],
                           exp["boxes"][i][b], atol=1e-3)
        elif task == "obb":
            np.testing.assert_allclose(got["extras"][i][a], exp["extras"][i][b], atol=1e-5)


# ---------------------------------------------------------------------------
# parameters, raw outputs, detections, logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(CONFIGS), ids=IDS)
def test_build_params_byte_equal(params, key):
    got = tv8.build_params(RandomWeightMap(seed=0), cfgs(*key)[1])
    jl, jdef = jax.tree_util.tree_flatten(params[key])
    tl, tdef = jax.tree_util.tree_flatten(got)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


RAW = [k for k in CONFIGS if k[0] != "cls"]


@pytest.mark.parametrize("key", RAW, ids=[i for i in IDS if i != "cls"])
def test_raw_outputs_match_jax(params, jax_outs, key):
    exp, got = jax_outs(key)[0], port(params, key, X, postprocess="raw")
    assert got["boxes"].shape == (2, ANCHORS[key[1]], 4)
    if key[0] == "seg":
        assert got["proto"].shape == (2, H // 4, H // 4, 32)
    check_raw(key[0], got, exp)


@pytest.mark.parametrize("key", RAW, ids=[i for i in IDS if i != "cls"])
def test_detections_match_jax(params, jax_outs, key):
    """The served tail at the lowest gate (`decidable_gate`) at which the
    gate and the candidates' IoUs lie off their thresholds on the port's
    raw outputs, checked on JAX's too."""
    task = key[0]
    raw, exp, thresh = jax_outs(key)
    assert_gate_decidable(raw["conf"], thresh)
    assert_nms_decidable(raw["boxes"], raw["conf"], raw["cls"], thresh,
                         angles=raw["extras"][..., 0] if task == "obb" else None)
    got = port(params, key, X, conf_thresh=thresh)
    # NMS removed some of the gate's candidates
    assert (exp["count"] > 0).all() and (exp["count"] < (raw["conf"] >= thresh).sum(-1)).all()
    if task == "seg":
        assert got["masks"].shape == (2, min(300, ANCHORS[""]), H // 4, H // 4)
    check_dets(task, got, exp)


def test_cls_logits_match_jax(params, jax_outs):
    exp, got = jax_outs(("cls", "")), port(params, ("cls", ""), X)
    assert got.shape == exp.shape == (2, 1000)
    assert np.abs(exp).max() > 1e-2
    np.testing.assert_allclose(got, exp, atol=1e-4 * (1 + np.abs(exp).max()))


# ---------------------------------------------------------------------------
# the pipeline, the torch reference, engine dirs, the command line
# ---------------------------------------------------------------------------

def test_serving_pipeline_matches_jax(params):
    """uint8 frames of different true sizes in one bucket → detections,
    the port's pipeline (gather letterbox, plain graph, the NMS kernel's
    CPU route) against JAX's (s2d letterbox and stem for det, XLA NMS);
    then `detect_images` maps the same boxes back to each image."""
    key = ("det", "")
    fr, hw = frames(1, 2)
    rawcfg = cfgs(*key, postprocess="raw")[1]
    raw = np_out(ServingPipeline(Engine("yolov8", params_from_jax(params[key]), rawcfg,
                                        device="cpu"), *BUCKET)(fr, hw))
    jcfg, tcfg = cfgs(*key, conf_thresh=decidable_gate(raw))
    jpipe = JaxPipeline(JaxEngine("yolov8", jtree(params[key]), jcfg, "fp32"), *BUCKET,
                        donate=False)
    pipe = ServingPipeline(Engine("yolov8", params_from_jax(params[key]), tcfg, device="cpu"),
                           *BUCKET)
    exp, got = np_out(jpipe(fr, hw)), np_out(pipe(fr, hw))
    assert (exp["count"] > 0).all()
    check_dets("det", got, exp)
    images = [f[:h, :w] for f, (h, w) in zip(fr, hw)]
    for g, e in zip(pipe.detect_images(images), jpipe.detect_images(images)):
        assert len(g["boxes"]) == len(e["boxes"]) > 0
        np.testing.assert_allclose(np.sort(g["scores"]), np.sort(e["scores"]), atol=1e-5)


def oracle(variant, task, seed, tmp_path):
    from torch_refs.yolo11_torch import randomize
    from torch_refs.yolov8_torch import Yolov8VariantTorch

    from tensorrtx_tpu_torch.core.wts import state_dict_to_wts

    nc = CONFIGS[task, variant]
    tm = randomize(Yolov8VariantTorch(nc=nc, task=task, variant=variant), seed=seed).eval()
    wts = tmp_path / "v8.wts"
    state_dict_to_wts(str(wts), tm.state_dict())
    eng = build_engine("yolov8", str(wts), scale="n", task=task, variant=variant,
                       num_classes=nc, input_h=H, input_w=H, postprocess="raw", device="cpu")
    return tm, eng


@pytest.mark.parametrize("task,variant", [("seg", "")])
def test_torch_reference_witness(tmp_path, rng, task, variant):
    """The ultralytics-style torch graph (tests/torch_refs/yolov8_torch.py)
    → .wts → the port's build_engine: the head decoded by numpy (DFL, best
    class, the strides), seg's coefficients and proto."""
    from test_yolo11 import np_decode

    tm, eng = oracle(variant, task, {"": 31, "p2": 32, "5u": 33}[variant] + (task == "seg"),
                     tmp_path)
    x = rng.uniform(0, 1, (1, 3, H, H)).astype(np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    res = np_out(eng(np.transpose(x, (0, 2, 3, 1))))
    strides = (4, 8, 16, 32) if variant == "p2" else (8, 16, 32)
    head = [(b.numpy(), c.numpy()) for b, c in out["head"]]
    exp_boxes, exp_conf, exp_cls = np_decode(head, strides=strides)
    np.testing.assert_allclose(res["conf"], exp_conf, atol=1e-4)
    np.testing.assert_allclose(res["boxes"], exp_boxes, atol=1e-2)
    assert (res["cls"][0].astype(int) == exp_cls[0]).mean() > 0.99
    if task == "seg":
        coef = np.concatenate([t.numpy().reshape(1, 32, -1).transpose(0, 2, 1)
                               for t in out["cv4"]], 1)
        np.testing.assert_allclose(res["extras"], coef, atol=2e-3)
        np.testing.assert_allclose(res["proto"], out["proto"].numpy().transpose(0, 2, 3, 1),
                                   atol=2e-3)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("key", [("seg", ""), ("cls", "")], ids=str)
def test_engine_dir_crosses_packages(params, jax_outs, tmp_path, key, direction):
    """A dir saved by one package loads in the other with the same keys
    and arrays (seg's transposed conv, cls's linear), and serves the same
    outputs."""
    cls = key[0] == "cls"
    jcfg, tcfg = cfgs(*key, **({} if cls else {"postprocess": "raw"}))
    x = X
    theirs, ours = tmp_path / "jax", tmp_path / "port"
    JaxEngine("yolov8", jtree(params[key]), jcfg, "fp32").save(str(theirs))
    Engine("yolov8", params_from_jax(params[key]), tcfg, device="cpu").save(str(ours))
    with np.load(theirs / "params.npz") as a, np.load(ours / "params.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if direction == "port_to_jax":
        # what JAX loaded, through the JAX apply its Engine jits (the
        # program of `jax_outs`)
        je = jax_load_engine(str(ours))
        assert je.cfg == jcfg
        exp = jax_apply(jv8, je.params, x, *([je.cfg] if cls else
                                             served_cfgs(key, jax_outs(key)[2])))[0]
        got = np_out(Engine("yolov8", params_from_jax(params[key]), tcfg, device="cpu")(x))
    else:
        exp = jax_outs(key) if cls else jax_outs(key)[0]
        eng = load_engine(str(theirs), device="cpu")
        assert eng.cfg == tcfg
        got = np_out(eng(x))
    if cls:
        np.testing.assert_allclose(got, exp, atol=1e-4 * (1 + np.abs(exp).max()))
    else:
        check_raw(key[0], got, exp)


def test_cli_lists_builds_and_runs_a_p2_engine(tmp_path, capsys):
    """`cli list` names the new models; `cli build yolov8 --set variant=p2`
    from a .wts, then `cli run` on two images, on the CPU: the printed
    detections are the pipeline's."""
    from PIL import Image

    from tensorrtx_tpu_torch.core.wts import save_wts

    assert cli.main(["list"]) == 0
    names = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert {"yolo11", "yolov8", "yolov10", "yolo26"} <= set(names)
    _, tcfg = cfgs("det", "p2", conf_thresh=0.25)
    wm = RandomWeightMap(seed=0)
    tv8.build_params(wm, tcfg)
    save_wts(str(tmp_path / "p2.wts"), wm.raw)
    assert cli.main(["build", "yolov8", "-w", str(tmp_path / "p2.wts"), "-o",
                     str(tmp_path / "p2"), "--set", "variant=p2", f"input_h={H}",
                     f"input_w={H}", "conf_thresh=0.25", "--device", "cpu"]) == 0
    fr, hw = frames(5, 2)
    images = [f[:h, :w] for f, (h, w) in zip(fr, hw)]
    (tmp_path / "imgs").mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im).save(tmp_path / "imgs" / f"{i}.png")
    capsys.readouterr()
    assert cli.main(["run", str(tmp_path / "p2"), str(tmp_path / "imgs"), "--batch", "2",
                     "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    eng = load_engine(str(tmp_path / "p2"), device="cpu")
    assert eng.cfg == tcfg
    ref = ServingPipeline(eng, max(h for h, _ in hw), max(w for _, w in hw)).detect_images(images)
    assert [len(ln["detections"]) for ln in lines] == [len(r["boxes"]) for r in ref]
    assert all(len(r["boxes"]) for r in ref)
    for ln, r in zip(lines, ref):
        assert [d["class"] for d in ln["detections"]] == r["classes"].tolist()


def test_cfg_refusals():
    with pytest.raises(ValueError, match="variant"):
        tv8.build_params(RandomWeightMap(0), tv8.Yolov8Cfg(variant="p6"))
    with pytest.raises(ValueError, match="det graph"):
        tv8.build_params(RandomWeightMap(0), tv8.Yolov8Cfg(task="seg", variant="p2"))
    with pytest.raises(ValueError, match="postprocess"):
        tv8.build_params(RandomWeightMap(0), tv8.Yolov8Cfg(postprocess="nmsfree"))

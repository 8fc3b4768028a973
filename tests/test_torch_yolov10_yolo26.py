"""Port YOLOv10 (det, NMS-free) and YOLO26 (det, obb, cls; NMS-free)
against the JAX package on the CPU: parameter trees (v10 at scales n and
m, whose CIBs take the RepVGGDW and the plain depthwise 3×3), raw outputs,
the gated top-k detections, cls's logits, the uint8 → detections
`ServingPipeline`, the independent torch graphs of tests/torch_refs through
a .wts, engine dirs in both directions and the command line.

float32 at 64², weights from one `RandomWeightMap` seed or a .wts, inputs
from numpy seeds; the tolerances of tests/test_torch_yolov8.py (raw conf
1e-4, boxes 1e-2 px, classes equal, angle 1e-5, logits 1e-4·(1 + max);
detections paired slot by slot by `match_slots`, at a gate no confidence
lies within 1e-6 of).
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
from tensorrtx_tpu.models import yolo26 as j26
from tensorrtx_tpu.models import yolov10 as jv10
from tensorrtx_tpu_torch import cli
from tensorrtx_tpu_torch.core.convert import params_from_jax
from tensorrtx_tpu_torch.core.engine import Engine, build_engine, load_engine
from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
from tensorrtx_tpu_torch.core.runner import ServingPipeline
from tensorrtx_tpu_torch.models import yolo26 as t26
from tensorrtx_tpu_torch.models import yolov10 as tv10
from test_torch_yolo11_tasks import jtree, np_out
from test_torch_yolov8 import (BUCKET, EPS_CONF, X, assert_gate_decidable, frames, jax_apply,
                               match_slots)

H = 64
ANCHORS = 64 + 16 + 4
# name → (model, JAX module, port module, cfg class, cfg overrides)
CONFIGS = {
    "v10n": ("yolov10", jv10, tv10, "Yolov10Cfg", {}),
    "v10m": ("yolov10", jv10, tv10, "Yolov10Cfg", {"scale": "m"}),
    "y26det": ("yolo26", j26, t26, "Yolo26Cfg", {}),
    "y26obb": ("yolo26", j26, t26, "Yolo26Cfg", {"task": "obb", "num_classes": 15}),
    "y26cls": ("yolo26", j26, t26, "Yolo26Cfg", {"task": "cls", "num_classes": 1000}),
}


def cfgs(key, **over):
    _, jm, tm, cls, kw = CONFIGS[key]
    kw = dict(input_h=H, input_w=H, **kw, **over)
    return dataclasses.replace(getattr(jm, cls)(), **kw), getattr(tm, cls)(**kw)


@pytest.fixture(scope="module")
def params():
    return {key: CONFIGS[key][1].build_params(JaxRWM(seed=0), cfgs(key)[0]) for key in CONFIGS}


def engines(params, key, **over):
    """(JAX engine, the port's engine) of a config on the same parameters."""
    jcfg, tcfg = cfgs(key, **over)
    name = CONFIGS[key][0]
    return (JaxEngine(name, jtree(params[key]), jcfg, "fp32"),
            Engine(name, params_from_jax(params[key]), tcfg, device="cpu"))


def port(params, key, x, **over):
    return np_out(engines(params, key, **over)[1](x))


def topk_cfgs(key, thresh):
    """The JAX cfgs (raw, gated top-k at ``thresh``) of a detection graph."""
    return cfgs(key, postprocess="raw")[0], cfgs(key, conf_thresh=thresh)[0]


@pytest.fixture(scope="module")
def jax_outs(params):
    """Per config, what JAX computes on X in one program (`jax_apply`):
    cls's logits, v10m's raw outputs, or (the raw outputs, the top-k at a
    gate between distinct confidences of the port's raw outputs, that
    gate)."""
    cache = {}

    def get(key):
        if key not in cache:
            jm = CONFIGS[key][1]
            if key == "y26cls":
                cache[key] = jax_apply(jm, params[key], X, cfgs(key)[0])[0]
            elif key == "v10m":
                cache[key] = jax_apply(jm, params[key], X, cfgs(key, postprocess="raw")[0])[0]
            else:
                t = gate_between(port(params, key, X, postprocess="raw")["conf"])
                cache[key] = (*jax_apply(jm, params[key], X, *topk_cfgs(key, t)), t)
        return cache[key]
    return get


def check_raw(got, exp):
    assert set(got) == set(exp)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in exp.items()}
    np.testing.assert_allclose(got["conf"], exp["conf"], atol=1e-4)
    np.testing.assert_array_equal(got["cls"], exp["cls"])
    np.testing.assert_allclose(got["boxes"], exp["boxes"], atol=1e-2)
    if "extras" in exp:
        np.testing.assert_allclose(got["extras"], exp["extras"], atol=1e-5)


def check_topk(got, exp, obb=False):
    """The gated top-k: fields, shapes and counts equal, the valid slots
    paired one to one (`match_slots`: classes, scores, boxes), obb's angle
    on the pairs."""
    assert set(got) == set(exp)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in exp.items()}
    np.testing.assert_array_equal(got["count"], exp["count"])
    for i in range(exp["count"].shape[0]):
        pairs = match_slots(got, exp, i, obb=obb)
        if obb and pairs:
            a, b = (np.array(p) for p in zip(*pairs))
            np.testing.assert_allclose(got["extras"][i][a], exp["extras"][i][b], atol=1e-5)


def gate_between(conf):
    """A gate in the widest gap between distinct confidences in the middle
    half of their range: part of the anchors pass, and none lies within
    EPS_CONF of it."""
    vals = np.unique(conf.astype(np.float64))
    mid = vals[len(vals) // 4: 3 * len(vals) // 4 + 1]
    i = int(np.argmax(np.diff(mid)))
    t = float(mid[i] + mid[i + 1]) / 2
    assert mid[i + 1] - mid[i] >= 2 * EPS_CONF
    return t


# ---------------------------------------------------------------------------
# parameters, raw outputs, detections, logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(CONFIGS))
def test_build_params_byte_equal(params, key):
    got = CONFIGS[key][2].build_params(RandomWeightMap(seed=0), cfgs(key)[1])
    jl, jdef = jax.tree_util.tree_flatten(params[key])
    tl, tdef = jax.tree_util.tree_flatten(got)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_v10_cib_forms(params):
    """n's last C2fCIB takes the RepVGGDW (7×7 + 3×3), m's CIBs the plain
    depthwise 3×3, as the reference's per-scale tables say."""
    assert "lk" in params["v10n"]["m22"]["m"][0] and "c2" not in params["v10n"]["m22"]["m"][0]
    for k in ("m8", "m19", "m22"):
        assert "c2" in params["v10m"][k]["m"][0] and "lk" not in params["v10m"][k]["m"][0]
    assert params["v10n"]["m22"]["m"][0]["lk"]["conv"]["w"].shape[:2] == (7, 7)


@pytest.mark.parametrize("key", ["v10n", "v10m", "y26det", "y26obb"])
def test_raw_outputs_match_jax(params, jax_outs, key):
    exp = jax_outs(key) if key == "v10m" else jax_outs(key)[0]
    got = port(params, key, X, postprocess="raw")
    assert got["boxes"].shape == (2, ANCHORS, 4)
    check_raw(got, exp)


@pytest.mark.parametrize("key", ["v10n", "y26det", "y26obb"])
def test_topk_detections_match_jax(params, jax_outs, key):
    """The NMS-free tail (`select_topk`; obb with its angle as extras) at a
    gate between distinct confidences, off every confidence of JAX's raw
    outputs too."""
    raw, exp, thresh = jax_outs(key)
    assert_gate_decidable(raw["conf"], thresh)
    got = port(params, key, X, conf_thresh=thresh)
    assert (exp["count"] > 0).all() and (exp["count"] < ANCHORS).all()
    check_topk(got, exp, obb=key == "y26obb")


def test_y26_cls_logits_match_jax(params, jax_outs):
    exp, got = jax_outs("y26cls"), port(params, "y26cls", X)
    assert got.shape == exp.shape == (2, 1000)
    assert np.abs(exp).max() > 1e-2
    np.testing.assert_allclose(got, exp, atol=1e-4 * (1 + np.abs(exp).max()))


# ---------------------------------------------------------------------------
# the pipeline, the torch references, engine dirs, the command line
# ---------------------------------------------------------------------------

def test_serving_pipeline_matches_jax(params):
    """uint8 frames of different true sizes in one bucket → the top-k
    detections of YOLOv10n, the port's pipeline against JAX's (s2d
    letterbox and stem); `detect_images` maps them back to each image
    (v10's cfg has no task field). yolo26's NMS-free tail is the same
    pipeline code (`test_topk_detections_match_jax`)."""
    key = "v10n"
    fr, hw = frames(1, 2)
    _, traw = engines(params, key, postprocess="raw")
    raw = np_out(ServingPipeline(traw, *BUCKET)(fr, hw))
    je, te = engines(params, key, conf_thresh=gate_between(raw["conf"]))
    jpipe, pipe = JaxPipeline(je, *BUCKET, donate=False), ServingPipeline(te, *BUCKET)
    exp, got = np_out(jpipe(fr, hw)), np_out(pipe(fr, hw))
    assert (exp["count"] > 0).all()
    check_topk(got, exp)
    images = [f[:h, :w] for f, (h, w) in zip(fr, hw)]
    for g, e in zip(pipe.detect_images(images), jpipe.detect_images(images)):
        assert len(g["boxes"]) == len(e["boxes"]) > 0
        np.testing.assert_allclose(np.sort(g["scores"]), np.sort(e["scores"]), atol=1e-5)


def test_v10_torch_reference_witness(tmp_path, rng):
    """tests/torch_refs/yolov10_torch.py → .wts → the port's build_engine:
    the one2one head decoded by numpy (DFL, best class)."""
    from test_yolo11 import np_decode
    from torch_refs.yolo11_torch import randomize
    from torch_refs.yolov10_torch import Yolov10Torch

    from tensorrtx_tpu_torch.core.wts import state_dict_to_wts

    tm = randomize(Yolov10Torch(), seed=51).eval()
    state_dict_to_wts(str(tmp_path / "v10.wts"), tm.state_dict())
    eng = build_engine("yolov10", str(tmp_path / "v10.wts"), scale="n", input_h=H, input_w=H,
                       postprocess="raw", device="cpu")
    x = rng.uniform(0, 1, (1, 3, H, H)).astype(np.float32)
    with torch.no_grad():
        head = [(b.numpy(), c.numpy()) for b, c in tm(torch.from_numpy(x))]
    exp_boxes, exp_conf, exp_cls = np_decode(head)
    res = np_out(eng(np.transpose(x, (0, 2, 3, 1))))
    np.testing.assert_allclose(res["conf"], exp_conf, atol=1e-4)
    np.testing.assert_allclose(res["boxes"], exp_boxes, atol=1e-2)
    assert (res["cls"][0].astype(int) == exp_cls[0]).mean() > 0.99


@pytest.mark.parametrize("task", ["obb", "cls"])
def test_y26_torch_reference_witness(tmp_path, task):
    """tests/torch_refs/yolo26_torch.py → .wts → the port's build_engine:
    the raw ltrb decode (no DFL), obb's angle, cls's logits."""
    from test_parity_yolo26 import np_decode26
    from torch_refs.yolo11_torch import randomize
    from torch_refs.yolo26_torch import Yolo26Torch

    from tensorrtx_tpu_torch.core.wts import state_dict_to_wts

    nc = {"det": 80, "obb": 15, "cls": 37}[task]
    seed = {"det": 41, "obb": 42, "cls": 43}[task]
    tm = randomize(Yolo26Torch(task=task, nc=nc), seed=seed).eval()
    state_dict_to_wts(str(tmp_path / "y26.wts"), tm.state_dict())
    kw = {} if task == "cls" else {"postprocess": "raw"}
    eng = build_engine("yolo26", str(tmp_path / "y26.wts"), scale="n", task=task,
                       num_classes=nc, input_h=H, input_w=H, device="cpu", **kw)
    x = np.random.default_rng(seed).uniform(0, 1, (1, 3, H, H)).astype(np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    res = np_out(eng(np.transpose(x, (0, 2, 3, 1))))
    if task == "cls":
        np.testing.assert_allclose(res, out.numpy(), atol=1e-4 * (1 + np.abs(res).max()))
        return
    head = [(b.numpy(), c.numpy()) for b, c in out["head"]]
    exp_boxes, exp_conf, exp_cls = np_decode26(head, nc=nc)
    np.testing.assert_allclose(res["conf"], exp_conf, atol=1e-4)
    assert (res["cls"][0].astype(int) == exp_cls[0]).mean() > 0.99
    if task == "det":
        np.testing.assert_allclose(res["boxes"], exp_boxes, atol=1e-2)
    else:
        ang = np.concatenate([t.numpy().reshape(1, -1) for t in out["cv4"]], 1)
        np.testing.assert_allclose(res["extras"][..., 0],
                                   (1 / (1 + np.exp(-ang)) - 0.25) * np.pi, atol=1e-4)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("key", ["v10n", "y26cls"])
def test_engine_dir_crosses_packages(params, jax_outs, tmp_path, key, direction):
    """A dir saved by one package loads in the other (v10's cfg without a
    task field, yolo26's without nms_thresh and reg_max) with the same
    keys and arrays, and serves the same outputs (JAX's through the
    program of `jax_outs`)."""
    cls = key == "y26cls"
    je, te = engines(params, key, **({} if cls else {"postprocess": "raw"}))
    x = X
    theirs, ours = tmp_path / "jax", tmp_path / "port"
    je.save(str(theirs))
    te.save(str(ours))
    with np.load(theirs / "params.npz") as a, np.load(ours / "params.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert json.loads((ours / "meta.json").read_text())["cfg"] == \
        json.loads((theirs / "meta.json").read_text())["cfg"]
    if direction == "port_to_jax":
        loaded = jax_load_engine(str(ours))
        assert loaded.cfg == je.cfg
        jcfgs = [je.cfg] if cls else topk_cfgs(key, jax_outs(key)[2])
        exp, got = jax_apply(CONFIGS[key][1], loaded.params, x, *jcfgs)[0], np_out(te(x))
    else:
        eng = load_engine(str(theirs), device="cpu")
        assert eng.cfg == te.cfg
        exp, got = (jax_outs(key) if cls else jax_outs(key)[0]), np_out(eng(x))
    if cls:
        np.testing.assert_allclose(got, exp, atol=1e-4 * (1 + np.abs(exp).max()))
    else:
        check_raw(got, exp)


def test_cli_builds_and_runs_a_v10_engine(tmp_path, capsys):
    """`cli build yolov10` from a .wts, then `cli run` on two images, on the
    CPU: the printed detections are the pipeline's."""
    from PIL import Image

    from tensorrtx_tpu_torch.core.wts import save_wts

    _, tcfg = cfgs("v10n", conf_thresh=0.5)
    wm = RandomWeightMap(seed=0)
    tv10.build_params(wm, tcfg)
    save_wts(str(tmp_path / "v10.wts"), wm.raw)
    assert cli.main(["build", "yolov10", "-w", str(tmp_path / "v10.wts"), "-o",
                     str(tmp_path / "v10"), "--set", f"input_h={H}", f"input_w={H}",
                     "conf_thresh=0.5", "--device", "cpu"]) == 0
    fr, hw = frames(5, 2)
    images = [f[:h, :w] for f, (h, w) in zip(fr, hw)]
    (tmp_path / "imgs").mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im).save(tmp_path / "imgs" / f"{i}.png")
    capsys.readouterr()
    assert cli.main(["run", str(tmp_path / "v10"), str(tmp_path / "imgs"), "--batch", "2",
                     "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    eng = load_engine(str(tmp_path / "v10"), device="cpu")
    assert eng.cfg == tcfg
    ref = ServingPipeline(eng, max(h for h, _ in hw), max(w for _, w in hw)).detect_images(images)
    assert [len(ln["detections"]) for ln in lines] == [len(r["boxes"]) for r in ref]
    for ln, r in zip(lines, ref):
        assert [d["class"] for d in ln["detections"]] == r["classes"].tolist()


def test_cfg_refusals():
    with pytest.raises(ValueError, match="postprocess"):
        Engine("yolov10", params_from_jax(tv10.build_params(RandomWeightMap(0), cfgs("v10n")[1])),
               cfgs("v10n", postprocess="nms")[1], device="cpu")
    with pytest.raises(ValueError, match="task"):
        t26.Yolo26(t26.Yolo26Cfg(task="seg"), {})

"""The port's YOLO11 seg, pose, obb and cls engines through the entry points a
user calls, against the JAX package on the CPU: engine dirs in both
directions, `ServingPipeline.__call__`, `stream_fn` and `detect_images`
(images smaller than the bucket), `cli build|run`, and the refusals: the
int8 tiers take only det, `detect_images` no cls engine. The captured
CUDA-graph route of the same calls is held on the card
(tests/test_torch_gpu.py, chip_smoke.py).

float32, scale n at 96² (cls at 64²), weights from one `RandomWeightMap`
seed; frames from numpy seeds. Tolerances: those of
`test_torch_yolo11_tasks.check_task_outputs`; NMS is compared only where
the port's raw outputs put no candidate pair within 1e-4 of the IoU
threshold (`assert_nms_decidable`).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrtx_tpu.core.engine import Engine as JaxEngine
from tensorrtx_tpu.core.engine import load_engine as jax_load_engine
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.core.runner import ServingPipeline as JaxPipeline
from tensorrtx_tpu.models import yolo11 as jy
from tensorrtx_tpu_torch import cli
from tensorrtx_tpu_torch.core import engine as teng
from tensorrtx_tpu_torch.core import quant as tq
from tensorrtx_tpu_torch.core.convert import params_from_jax
from tensorrtx_tpu_torch.core.engine import Engine, load_engine
from tensorrtx_tpu_torch.core.runner import ServingPipeline
from test_torch_yolo11_tasks import (NC, assert_nms_decidable, cfgs, check_task_outputs,
                                     jtree, np_out)

BUCKET = (120, 100)
CONF = 0.25
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    return {t: jy.build_params(JaxRWM(seed=0), cfgs(t)[0]) for t in NC}


_PIPES = {}


def pipes(params, task):
    """(the port's pipeline, JAX's) of a task at conf CONF, built once."""
    if task not in _PIPES:
        jcfg, tcfg = cfgs(task, conf_thresh=CONF)
        jeng = JaxEngine("yolo11", jtree(params[task]), jcfg, "fp32")
        teng_ = Engine("yolo11", params_from_jax(params[task]), tcfg, device="cpu")
        _PIPES[task] = (ServingPipeline(teng_, *BUCKET),
                        JaxPipeline(jeng, *BUCKET, donate=False))
    return _PIPES[task]


def frames(seed, b):
    """b uint8 frames in the bucket, each image smaller than the bucket in
    its top-left corner."""
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, 256, (b, *BUCKET, 3), dtype=np.uint8)
    hw = np.stack([rng.integers(50, BUCKET[0], b), rng.integers(50, BUCKET[1], b)],
                  1).astype(np.int32)
    return fr, hw


def decidable(params, task, fr, hw):
    """The port's raw outputs on these frames leave NMS no near-threshold
    pair (the candidates at CONF)."""
    _, tcfg = cfgs(task, postprocess="raw")
    eng = Engine("yolo11", params_from_jax(params[task]), tcfg, device="cpu")
    raw = {k: v.numpy() for k, v in ServingPipeline(eng, *BUCKET)(fr, hw).items()}
    assert_nms_decidable(raw["boxes"], raw["conf"], raw["cls"], CONF,
                         angles=raw["extras"][..., 0] if task == "obb" else None)


def check(task, got, exp):
    if task == "cls":
        got, exp = np.asarray(got), np.asarray(exp)
        assert got.shape == exp.shape
        np.testing.assert_allclose(got, exp, atol=1e-5 * (1 + np.abs(exp).max()))
    else:
        check_task_outputs(task, np_out(got), np_out(exp))


# ---------------------------------------------------------------------------
# (g) engine dirs both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("task", ["seg", "cls"])
def test_engine_dir_crosses_packages(params, tmp_path, rng, task, direction):
    """seg's proto (the transposed conv's kernel, (kh, kw, out, in) in the
    dir) and cls's linear ((in, out)) survive a save in one package and a
    load in the other; the dir's keys are the ones JAX writes."""
    jcfg, tcfg = cfgs(task, postprocess="raw")
    size = jcfg.input_h
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    theirs, ours = tmp_path / "jax", tmp_path / "port"
    JaxEngine("yolo11", jtree(params[task]), jcfg, "fp32").save(str(theirs))
    Engine("yolo11", params_from_jax(params[task]), tcfg, device="cpu").save(str(ours))
    with np.load(theirs / "params.npz") as a, np.load(ours / "params.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    keys = set(np.load(ours / "params.npz").files)
    assert ({"proto/up_w", "proto/up_b", "cv4/0/c/w"} if task == "seg"
            else {"cls_head/m10_linear/w", "cls_head/m9/cv1/w"}) <= keys
    if direction == "port_to_jax":
        exp = jax_load_engine(str(ours))(x)
        got = Engine("yolo11", params_from_jax(params[task]), tcfg, device="cpu")(x)
    else:
        exp = JaxEngine("yolo11", jtree(params[task]), jcfg, "fp32")(x)
        eng = load_engine(str(theirs), device="cpu")
        assert eng.cfg == tcfg
        got = eng(x)
    check(task, got, exp)


# ---------------------------------------------------------------------------
# (h) the pipeline against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["seg", "pose", "obb", "cls"])
def test_pipeline_call_matches_jax(params, task):
    pipe, jpipe = pipes(params, task)
    fr, hw = frames(1, 2)
    if task != "cls":
        decidable(params, task, fr, hw)
    exp = jpipe(fr, hw)
    got = pipe(fr, hw)
    if task != "cls":
        assert (np.asarray(exp["count"]) > 0).all()
    check(task, got, exp)


@pytest.mark.parametrize("task", ["seg", "pose", "obb", "cls"])
def test_stream_fn_matches_jax(params, task):
    """`stream_fn(4)`: four batch-1 forwards stacked (leaves (4, 1, ...))
    against JAX's scan over the same frames."""
    pipe, jpipe = pipes(params, task)
    fr, hw = frames(2, 4)
    if task != "cls":
        decidable(params, task, fr, hw)
    exp = jpipe.stream_fn(4)(jpipe._params, jnp.asarray(fr), jnp.asarray(hw))
    got = pipe.stream_fn(4)(fr, hw)
    lead = (got if task == "cls" else got["boxes"]).shape[:2]
    assert lead == (4, 1)
    check(task, got, exp)


@pytest.mark.parametrize("task", ["seg", "pose", "obb"])
def test_detect_images_matches_jax(params, task):
    """Per-image detections mapped back to each image: boxes, scores and
    classes only, as JAX presents them (obb's (cx, cy, w, h) too go
    through the xyxy mapping in both packages)."""
    pipe, jpipe = pipes(params, task)
    fr, hw = frames(3, 2)
    images = [f[:h, :w] for f, (h, w) in zip(fr, hw)]
    decidable(params, task, fr, hw)
    exp = jpipe.detect_images(images)
    got = pipe.detect_images(images)
    assert len(got) == len(exp) == 2
    for g, e in zip(got, exp):
        assert set(g) == set(e) == {"boxes", "scores", "classes"}
        assert len(e["boxes"]) > 0
        np.testing.assert_array_equal(g["classes"], e["classes"])
        np.testing.assert_allclose(g["scores"], e["scores"], atol=1e-5)
        np.testing.assert_allclose(g["boxes"], e["boxes"], atol=1e-2)


# ---------------------------------------------------------------------------
# (i) refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["seg", "pose", "obb", "cls"])
def test_int8_tiers_refuse_other_tasks(params, task):
    """The int8 tiers' conv slots were held against JAX's scale table on det
    only, so seg's, pose's and obb's extra convs (and cls) are refused
    before any slot is assigned."""
    eng = Engine("yolo11", params_from_jax(params[task]), cfgs(task)[1], device="cpu")
    size = eng.cfg.input_h
    with pytest.raises(NotImplementedError, match="det"):
        tq.calibrate(eng, [np.zeros((1, size, size, 3), np.float32)], "absmax")
    with pytest.raises(NotImplementedError, match="det"):
        tq.QuantizedEngine(eng, np.ones(200, np.float32))
    with pytest.raises(NotImplementedError, match="det"):
        tq.ChainedInt8Engine(eng, dtype=torch.float32)


def test_cli_int8_build_refuses_other_tasks(params, tmp_path, monkeypatch):
    def fake_build(name, wts, precision="fp32", device="cuda", **over):
        _, tcfg = cfgs("seg")
        return Engine(name, params_from_jax(params["seg"]), tcfg, device="cpu")

    monkeypatch.setattr(teng, "build_engine", fake_build)
    with pytest.raises(NotImplementedError, match="det"):
        cli.main(["build", "yolo11", "-w", "x.wts", "-o", str(tmp_path / "e"),
                  "--set", "task=seg", "--int8-calib-dir", str(tmp_path), "--device", "cpu"])
    assert not (tmp_path / "e").exists()


def test_cls_engine_has_no_detections(params, tmp_path):
    pipe, _ = pipes(params, "cls")
    fr, hw = frames(4, 1)
    assert pipe(fr, hw).shape == (1, 1000)
    with pytest.raises(ValueError, match="cls"):
        pipe.detect_images([fr[0, :hw[0, 0], :hw[0, 1]]])
    pipe.engine.save(str(tmp_path / "cls"))
    from PIL import Image

    (tmp_path / "imgs").mkdir()
    Image.fromarray(fr[0]).save(tmp_path / "imgs" / "a.png")
    with pytest.raises(ValueError, match="cls"):
        cli.main(["run", str(tmp_path / "cls"), str(tmp_path / "imgs"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# the command line and the package without JAX
# ---------------------------------------------------------------------------

def test_cli_builds_and_runs_a_seg_engine(tmp_path, capsys):
    """`cli build --set task=seg` from a .wts, then `cli run` on two images
    of different sizes, on the CPU; the printed detections are the
    pipeline's."""
    from PIL import Image

    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
    from tensorrtx_tpu_torch.core.wts import save_wts
    from tensorrtx_tpu_torch.models import yolo11 as ty

    _, tcfg = cfgs("seg", conf_thresh=CONF)
    wm = RandomWeightMap(seed=0)
    ty.build_params(wm, tcfg)
    save_wts(str(tmp_path / "seg.wts"), wm.raw)
    assert cli.main(["build", "yolo11", "-w", str(tmp_path / "seg.wts"), "-o",
                     str(tmp_path / "seg"), "--set", "task=seg", "input_h=96", "input_w=96",
                     f"conf_thresh={CONF}", "--device", "cpu"]) == 0
    fr, hw = frames(5, 2)
    images = [f[:h, :w] for f, (h, w) in zip(fr, hw)]
    (tmp_path / "imgs").mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im).save(tmp_path / "imgs" / f"{i}.png")
    capsys.readouterr()
    assert cli.main(["run", str(tmp_path / "seg"), str(tmp_path / "imgs"), "--batch", "2",
                     "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    eng = load_engine(str(tmp_path / "seg"), device="cpu")
    assert eng.cfg == tcfg
    ref = ServingPipeline(eng, max(h for h, _ in hw), max(w for _, w in hw)).detect_images(images)
    assert [len(ln["detections"]) for ln in lines] == [len(r["boxes"]) for r in ref]
    assert all(len(r["boxes"]) for r in ref)
    for ln, r in zip(lines, ref):
        assert [d["class"] for d in ln["detections"]] == r["classes"].tolist()


def test_task_modules_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tensorrtx_tpu'] = None\n"
        "import numpy as np\n"
        "from tensorrtx_tpu_torch.core.convert import params_from_jax\n"
        "from tensorrtx_tpu_torch.core.engine import Engine\n"
        "from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap\n"
        "from tensorrtx_tpu_torch.core.runner import ServingPipeline\n"
        "from tensorrtx_tpu_torch.models.yolo11 import Yolo11Cfg, build_params\n"
        "from tensorrtx_tpu_torch.ops import detect, nms, nn\n"
        "for task, nc, size in (('seg', 80, 64), ('pose', 1, 64), ('obb', 15, 64),\n"
        "                       ('cls', 10, 32)):\n"
        "    cfg = Yolo11Cfg(task=task, num_classes=nc, input_h=size, input_w=size,\n"
        "                    conf_thresh=0.25)\n"
        "    eng = Engine('yolo11', params_from_jax(build_params(RandomWeightMap(0), cfg)),\n"
        "                 cfg, device='cpu')\n"
        "    out = ServingPipeline(eng, 70, 60)(np.zeros((1, 70, 60, 3), np.uint8))\n"
        "    print(task, *sorted(out) if isinstance(out, dict) else tuple(out.shape))\n"
        "print(nms.probiou_matrix.__name__, detect.decode_obb.__name__, nn.linear.__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "seg boxes classes count extras masks scores valid",
        "pose boxes classes count extras scores valid",
        "obb boxes classes count extras scores valid",
        "cls 1 10",
        "probiou_matrix decode_obb linear"]

"""The int8 tiers on the port's new models against the JAX package on the
CPU: YOLOv8 det's chained tier (`yolov8.apply_chain`, the C2f/C3 and
branch chain twins) and its float-resident tier (`QuantizedEngine`), the
float-resident tier's conv slots for every new det graph, and the tiers'
refusals.

The JAX chain runs its Pallas kernels in interpret mode, every JAX pass
jitted; the port's int8 convs take their plain versions here (CPU
tensors). float32 islands, scale n at 64², batch 2, weights from one
`RandomWeightMap` seed, frames from numpy seeds. Bars: the chain's slots
and weights equal to JAX's, its scales within 1e-5 relative; raw outputs
conf 1e-4, boxes 0.05 px, classes on ≥ 99 % of the anchors (the 1-LSB
budget of tests/test_torch_qchain.py, which leaves room for a requant
flip at a rounding tie).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrtx_tpu.core import quant as jq
from tensorrtx_tpu.core.engine import Engine as JaxEngine
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.models import yolo26 as j26
from tensorrtx_tpu.models import yolov8 as jv8
from tensorrtx_tpu.models import yolov10 as jv10
from tensorrtx_tpu.ops import qchain as jqc
from tensorrtx_tpu.ops.preprocess import letterbox_s2d_batch
from tensorrtx_tpu_torch.core import quant as tq
from tensorrtx_tpu_torch.core.convert import chain_weights_from_jax, params_from_jax
from tensorrtx_tpu_torch.core.engine import Engine
from tensorrtx_tpu_torch.core.quant import ChainedInt8Engine
from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
from tensorrtx_tpu_torch.models import yolo26 as t26
from tensorrtx_tpu_torch.models import yolov8 as tv8
from tensorrtx_tpu_torch.models import yolov10 as tv10

REPO = Path(__file__).resolve().parents[1]
H = 64
f32 = jnp.float32


def v8_cfgs(**over):
    kw = dict(input_h=H, input_w=H, **over)
    return dataclasses.replace(jv8.Yolov8Cfg(), **kw), tv8.Yolov8Cfg(**kw)


def check_raw_int8(got, exp, n_anchors=64 + 16 + 4):
    assert got["boxes"].shape == exp["boxes"].shape == (2, n_anchors, 4)
    assert np.isfinite(got["boxes"]).all()
    assert np.abs(got["conf"] - exp["conf"]).max() <= 1e-4
    assert np.abs(got["boxes"] - exp["boxes"]).max() <= 0.05
    assert (got["cls"] == exp["cls"]).mean() >= 0.99


# ---------------------------------------------------------------------------
# the chained tier: letterbox → float stem (m0, m1, m2) → int8 chain → decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain_run():
    """YOLOv8n det at 64², float32 islands in both packages; 2 frames of
    true size (80, 72) and (60, 50) in an 80×72 bucket, calibrated on the
    full frames. Returns what both packages computed."""
    jcfg, tcfg = v8_cfgs(postprocess="raw")
    params = jv8.build_params(JaxRWM(seed=0), jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 80, 72, 3), dtype=np.uint8)
    full_hw = np.array([[80, 72], [80, 72]], np.int32)
    src_hw = np.array([[80, 72], [60, 50]], np.int32)
    meta = {}

    def x4(frames, hw):
        return letterbox_s2d_batch(frames, hw, H, H, out_dtype=f32, factor=4)

    def jtap(p, frames, hw):
        ctx = jqc.ChainCtx("tap", dtype=f32, enter="m3")
        jv8.apply_chain(p, x4(frames, hw), jcfg, ctx, f=1)
        meta["dw"] = ctx.w_is_dw
        return ctx.taps, ctx.ws

    taps, ws = jax.jit(jtap)(jp, frames, full_hw)
    jscales = np.maximum(np.asarray(jnp.stack(taps)) / np.float32(127.0), np.float32(1e-8))
    jwq, jsw = jqc.quantize_chain_weights([np.asarray(w) for w in ws], meta["dw"])

    def jrun(p, wq, scales, frames, hw):
        ctx = jqc.ChainCtx("run", scales=scales, wq=wq, sw=jsw, dtype=f32, enter="m3")
        return jv8.apply_chain(p, x4(frames, hw), jcfg, ctx, f=1)

    exp = {k: np.asarray(v) for k, v in
           jax.jit(jrun)(jp, jwq, jnp.asarray(jscales), frames, src_hw).items()}

    ce = ChainedInt8Engine(Engine("yolov8", params_from_jax(params), tcfg, device="cpu"),
                           dtype=torch.float32)
    tscales = ce.calibrate([frames])
    own_wq = ce.wq
    ce.wq, ce.sw = chain_weights_from_jax(jwq, jsw)
    ce.set_scales(jscales)
    got = {k: v.numpy() for k, v in ce(frames, src_hw).items()}
    return dict(jscales=jscales, tscales=tscales, n_w=len(jwq), ce=ce, exp=exp, got=got,
                own_wq=own_wq, frames=frames, src_hw=src_hw, tcfg=tcfg, params=params)


def test_chain_slots_and_scales_match_jax(chain_run):
    """69 scale slots and 57 weights, JAX's one for one: 35 int8 3×3 and 22
    int8 1×1 (6 of them the head's float exits); no depthwise conv."""
    r = chain_run
    assert r["ce"].n_scales == len(r["jscales"]) == 69
    assert len(r["ce"].wq) == r["n_w"] == 57
    np.testing.assert_allclose(r["tscales"], r["jscales"], rtol=1e-5)
    for a, b in zip(r["own_wq"], r["ce"].wq):
        assert torch.equal(a, b)
    kinds = [(w.dtype, w.shape[1]) for w in r["ce"].wq]
    assert kinds.count((torch.int8, 3)) == 35 and kinds.count((torch.int8, 1)) == 22


def test_chain_raw_outputs_match_jax(chain_run):
    """With identical scales and weights the raw per-anchor outputs agree
    within the budget: the int32 sums are exact in both packages; what is
    left is the float32 rounding of the float stem (JAX runs it as s2d
    convs) and of the decode."""
    check_raw_int8(chain_run["got"], chain_run["exp"])


def test_chain_serves_detections(chain_run):
    """The nms tail of the chained v8 engine serves the detection dict that
    `present_detections` maps back to each image."""
    from tensorrtx_tpu_torch.core.runner import present_detections

    r = chain_run
    cfg = dataclasses.replace(r["tcfg"], postprocess="nms", conf_thresh=0.25)
    ce = ChainedInt8Engine(Engine("yolov8", params_from_jax(r["params"]), cfg, device="cpu"),
                           dtype=torch.float32)
    ce.set_scales(r["jscales"])
    out = ce(r["frames"], r["src_hw"])
    assert set(out) == {"boxes", "scores", "classes", "valid", "count"}
    dets = present_detections(out, r["src_hw"], cfg)
    for d, (h, w) in zip(dets, r["src_hw"]):
        assert len(d["boxes"]) > 0 and (d["boxes"][:, 2] <= w).all() and (d["boxes"][:, 3] <= h).all()


def test_chain_covers_the_standard_det_graph_only():
    _, tcfg = v8_cfgs(variant="p2")
    eng = Engine("yolov8", params_from_jax(tv8.build_params(RandomWeightMap(0), tcfg)), tcfg,
                 device="cpu")
    with pytest.raises(ValueError, match="no chained int8 path"):
        ChainedInt8Engine(eng, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the float-resident tier
# ---------------------------------------------------------------------------

# name → (model, JAX module, port module, cfg class, overrides, slots, depthwise,
# int8 (3×3 s1, 3×3 s2, 1×1))
TIER = {
    "v8det": ("yolov8", jv8, tv8, "Yolov8Cfg", {}, 63, 0, (32, 7, 24)),
    "v8p2": ("yolov8", jv8, tv8, "Yolov8Cfg", {"variant": "p2"}, 78, 0, (40, 8, 30)),
    "v8_5u": ("yolov8", jv8, tv8, "Yolov8Cfg", {"variant": "5u"}, 73, 0, (22, 6, 44)),
    "v10n": ("yolov10", jv10, tv10, "Yolov10Cfg", {}, 83, 14, (24, 4, 41)),
    "y26det": ("yolo26", j26, t26, "Yolo26Cfg", {}, 102, 8, (32, 7, 55)),
}


def tier_engines(key, **over):
    name, jm, tm, cls, kw = TIER[key][:5]
    kw = dict(input_h=H, input_w=H, postprocess="raw", **kw, **over)
    jcfg, tcfg = dataclasses.replace(getattr(jm, cls)(), **kw), getattr(tm, cls)(**kw)
    params = jm.build_params(JaxRWM(seed=0), jcfg)
    return (JaxEngine(name, jax.tree.map(jnp.asarray, params), jcfg, "fp32"),
            Engine(name, params_from_jax(params), tcfg, device="cpu"))


_JAX_CONV_WEIGHTS = jq._conv_weights


def jax_conv_weights(je):
    """JAX's weight spy (`_conv_weights`: every ``nn.conv2d`` call of one
    forward on zeros, the row-phase convs through their weight builders)
    run under `jax.eval_shape`: the spy records the engine's own weight
    arrays as JAX's forward reaches them, and the forward is traced, not
    compiled op by op."""
    out = []
    jax.eval_shape(lambda: out.append(_JAX_CONV_WEIGHTS(je)) or 0)
    return out[0]


@pytest.mark.parametrize("key", list(TIER))
def test_tier_conv_weights_match_jax(key):
    """The tier's slots (`Conv` forward pre-hooks in call order) against
    JAX's weight spy (`jax_conv_weights`): the same weights, byte for byte,
    in the same order. v10's SCDown depthwise stride-2 conv and both
    RepVGGDW convs are slots of their own; 5u's 6×6 stem is one (the tier
    has no int8 kernel for it)."""
    je, te = tier_engines(key)
    jw, tw = jax_conv_weights(je), tq.conv_weights(te)
    n, n_dw, (s1, s2, k1) = TIER[key][5:]
    assert len(tw) == len(jw) == n
    for a, b in zip(jw, tw):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    _, convs = tq._slotted_copy(te, torch.float32)
    kinds = [(m.w.shape[2], m.stride) for m in convs if not m.slot.depthwise]
    assert sum(m.slot.depthwise for m in convs) == n_dw
    assert (kinds.count((3, 1)), kinds.count((3, 2)), kinds.count((1, 1))) == (s1, s2, k1)


def test_tier_matches_jax_on_v8_det(monkeypatch):
    """`QuantizedEngine` on YOLOv8n det in both packages at the port's
    percentile scales (calibration's slot order is JAX's by
    `test_tier_conv_weights_match_jax`, and its choosers are held against
    JAX's by tests/test_torch_quant.py): the same int8 weights per slot,
    and raw outputs within the budget, as tests/test_torch_quant.py holds
    yolo11's tier. At absmax scales this batch puts conv inputs within
    float32 rounding of a requant tie (7 of the 63 within 1e-5 LSB, the
    scale taken at the calibration batch's maximum), where XLA's and
    torch's last-bit different conv sums may round apart; one such flip
    moves conf by about 2e-4."""
    je, te = tier_engines("v8det")
    batch = np.random.default_rng(2).uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    jscales = tq.calibrate(te, [batch], "percentile")
    # JAX's tier reads its weights by its spy: traced, not run op by op
    # (the same arrays, `test_tier_conv_weights_match_jax`)
    monkeypatch.setattr(jq, "_conv_weights", jax_conv_weights)
    jqe, tqe = jq.QuantizedEngine(je, jscales), tq.QuantizedEngine(te, jscales)
    slots = tqe.slots()
    assert len(slots) == len(jqe.wq) == 63
    for a, sl in zip(jqe.wq, slots):
        np.testing.assert_array_equal(np.asarray(a).transpose(3, 0, 1, 2), sl.wq.numpy())
    x = np.random.default_rng(1).uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    exp = {k: np.asarray(v) for k, v in jqe(x).items()}
    got = {k: v.numpy() for k, v in tqe(x).items()}
    check_raw_int8(got, exp)
    fl = {k: v.numpy() for k, v in te(x).items()}
    assert np.abs(fl["conf"] - got["conf"]).max() > 0      # the int8 path ran


# ---------------------------------------------------------------------------
# refusals and imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,task,nc", [("yolov8", "seg", 80), ("yolov8", "pose", 1),
                                           ("yolov8", "obb", 15), ("yolov8", "cls", 1000),
                                           ("yolo26", "obb", 15), ("yolo26", "cls", 1000)])
def test_int8_tiers_refuse_other_tasks(model, task, nc):
    """Both tiers take det only: the other tasks' extra convs have no slot
    order held against JAX's scale table, and cls has no detection tail."""
    tm = {"yolov8": tv8, "yolo26": t26}[model]
    cfg = (tm.Yolov8Cfg if model == "yolov8" else tm.Yolo26Cfg)(
        task=task, num_classes=nc, input_h=H, input_w=H)
    eng = Engine(model, params_from_jax(tm.build_params(RandomWeightMap(0), cfg)), cfg,
                 device="cpu")
    with pytest.raises(NotImplementedError, match="det"):
        tq.calibrate(eng, [np.zeros((1, H, H, 3), np.float32)], "absmax")
    with pytest.raises(NotImplementedError, match="det"):
        tq.QuantizedEngine(eng, np.ones(200, np.float32))
    with pytest.raises(NotImplementedError, match="det"):
        ChainedInt8Engine(eng, dtype=torch.float32)


def test_new_modules_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tensorrtx_tpu'] = None\n"
        "import numpy as np\n"
        "from tensorrtx_tpu_torch.core.convert import params_from_jax\n"
        "from tensorrtx_tpu_torch.core.engine import Engine\n"
        "from tensorrtx_tpu_torch.core.quant import ChainedInt8Engine\n"
        "from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap\n"
        "from tensorrtx_tpu_torch.core.runner import ServingPipeline\n"
        "from tensorrtx_tpu_torch.models import _yolo_blocks, _yolo_qchain, yolo26, yolov8, yolov10\n"
        "cfg = yolov8.Yolov8Cfg(input_h=64, input_w=64, conf_thresh=0.25)\n"
        "eng = Engine('yolov8', params_from_jax(yolov8.build_params(RandomWeightMap(0), cfg)), cfg,\n"
        "             device='cpu')\n"
        "out = ServingPipeline(eng, 70, 60)(np.zeros((1, 70, 60, 3), np.uint8))\n"
        "ce = ChainedInt8Engine(eng)\n"
        "print(*sorted(out), ce.n_scales, yolov10.Yolov10Cfg().postprocess,\n"
        "      yolo26.Yolo26Cfg().postprocess, _yolo_qchain.qbranch3.__name__,\n"
        "      _yolo_blocks.C2f.__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["boxes", "classes", "count", "scores", "valid", "69", "topk",
                                  "topk", "qbranch3", "C3k2"]

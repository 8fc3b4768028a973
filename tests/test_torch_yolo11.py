"""Port YOLO11 det (tensorrtx_tpu_torch) against the JAX package on the CPU:
blocks, the raw head outputs, and the uint8→detections serving pipeline,
float32, small sizes. Weights come from one `RandomWeightMap` seed (the
two packages draw byte-equal trees) or from one .wts file.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tensorrtx_tpu.core.engine import Engine as JaxEngine
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.core.runner import ServingPipeline as JaxPipeline
from tensorrtx_tpu.models import _yolo_blocks as JB
from tensorrtx_tpu.models import yolo11 as jy
from tensorrtx_tpu_torch.core.convert import params_from_jax
from tensorrtx_tpu_torch.core.engine import Engine, build_engine
from tensorrtx_tpu_torch.core.runner import ServingPipeline
from tensorrtx_tpu_torch.models import _yolo_blocks as TB
from tensorrtx_tpu_torch.models import yolo11 as ty

H = 96


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def jtree(p):
    return jax.tree.map(jnp.asarray, p)


BLOCKS = {
    "c3k2_bottleneck": (lambda wm: JB.c3k2_p(wm, "m", 32, 48, 2, False, e=0.5),
                        JB.c3k2_a, TB.C3k2, 32),
    "c3k2_c3k": (lambda wm: JB.c3k2_p(wm, "m", 32, 32, 1, True, e=0.5),
                 JB.c3k2_a, TB.C3k2, 32),
    "sppf": (lambda wm: JB.sppf_p(wm, "m", 64, 64), JB.sppf_a, TB.SPPF, 64),
    "c2psa": (lambda wm: JB.c2psa_p(wm, "m", 256, 256, 1), JB.c2psa_a, TB.C2PSA, 256),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, rng):
    build, japply, module, cin = BLOCKS[name]
    p = build(JaxRWM(seed=3, scale=0.1))
    x = rng.normal(size=(2, 6, 5, cin)).astype(np.float32)
    exp = np.asarray(japply(jtree(p), jnp.asarray(x)))
    with torch.inference_mode():
        got = module(params_from_jax(p))(nchw(x))
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(exp).max() > 1e-2  # the block carries signal
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def params():
    cfg = dataclasses.replace(jy.Yolo11Cfg(), input_h=H, input_w=H)
    return jy.build_params(JaxRWM(seed=0), cfg)


def test_raw_head_matches_jax_apply(params, rng):
    jcfg = dataclasses.replace(jy.Yolo11Cfg(), input_h=H, input_w=H, postprocess="raw")
    tcfg = ty.Yolo11Cfg(input_h=H, input_w=H, postprocess="raw")
    x = rng.uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    exp = jax.jit(lambda p, v: jy.apply(p, v, jcfg))(jtree(params), jnp.asarray(x))
    got = Engine("yolo11", params_from_jax(params), tcfg, device="cpu")(x)
    assert got["boxes"].shape == (2, 189, 4)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(exp["conf"]), atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(exp["boxes"]), atol=1e-2)
    np.testing.assert_array_equal(got["cls"].numpy(), np.asarray(exp["cls"]))


def test_serving_pipeline_matches_jax(params, rng):
    """Port ServingPipeline (gather letterbox, plain graph, CUDA-kernel NMS
    wrapper on its CPU route) against the JAX ServingPipeline (s2d letterbox,
    rewritten graph, XLA NMS) at float32: 2 frames of different true size
    in one 120×100 bucket. max_det covers all 189 anchors, so the result
    does not hang on the order of near-equal scores at a top-k cut."""
    over = dict(input_h=H, input_w=H, conf_thresh=0.25, max_det=300)
    jeng = JaxEngine("yolo11", jtree(params),
                     dataclasses.replace(jy.Yolo11Cfg(), **over), "fp32")
    teng = Engine("yolo11", params_from_jax(params), ty.Yolo11Cfg(**over), device="cpu")
    frames = rng.integers(0, 256, (2, 120, 100, 3), dtype=np.uint8)
    src_hw = np.array([[120, 100], [80, 90]], np.int32)
    exp = {k: np.asarray(v) for k, v in
           JaxPipeline(jeng, 120, 100, donate=False)(frames, src_hw).items()}
    got = {k: v.numpy() for k, v in ServingPipeline(teng, 120, 100)(frames, src_hw).items()}
    assert set(got) == set(exp)
    assert (exp["count"] > 0).all()
    np.testing.assert_array_equal(got["count"], exp["count"])
    np.testing.assert_array_equal(got["valid"], exp["valid"])
    np.testing.assert_array_equal(got["classes"], exp["classes"])
    np.testing.assert_allclose(got["scores"], exp["scores"], atol=1e-5)
    np.testing.assert_allclose(got["boxes"], exp["boxes"], atol=1e-3)
    # the host API maps the same boxes back to each image
    dets = ServingPipeline(teng, 120, 100).detect_images([frames[0], frames[1, :80, :90]])
    assert [len(d["boxes"]) for d in dets] == list(exp["count"])


def test_torch_reference_witness(tmp_path, rng):
    """Third witness: the independent ultralytics-style torch graph
    (tests/torch_refs) → .wts → the port's build_engine, raw head decode."""
    from test_yolo11 import np_decode
    from torch_refs.yolo11_torch import Yolo11Torch, randomize

    from tensorrtx_tpu_torch.core.wts import state_dict_to_wts

    tm = randomize(Yolo11Torch(scale="n", nc=80), seed=1).eval()
    wts = tmp_path / "y11n.wts"
    state_dict_to_wts(str(wts), tm.state_dict())
    eng = build_engine("yolo11", str(wts), scale="n", input_h=H, input_w=H,
                       postprocess="raw", device="cpu")
    x = rng.uniform(0, 1, (1, 3, H, H)).astype(np.float32)
    with torch.no_grad():
        head = [(b.numpy(), c.numpy()) for b, c in tm(torch.from_numpy(x))["head"]]
    exp_boxes, exp_conf, exp_cls = np_decode(head)
    got = eng(np.transpose(x, (0, 2, 3, 1)))
    np.testing.assert_allclose(got["conf"].numpy(), exp_conf, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy(), exp_boxes, atol=1e-2)
    assert (got["cls"].numpy()[0].astype(int) == exp_cls[0]).mean() > 0.99

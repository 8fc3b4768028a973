"""The port's float-resident int8 tier and its standalone kernels
(tensorrtx_tpu_torch: ops/cuda/quantize, ops/cuda/conv_planar,
ops/quant_ctx, core/quant `calibrate`/`QuantizedEngine`, load_engine, cli)
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py
and tests/test_pallas_conv_planar.py run them. The port's kernels take
their plain versions here (CPU tensors); `tests/test_torch_gpu.py` holds
the CUDA kernels against those plain versions on the card.
"""

import copy
import dataclasses
import inspect
import json
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
from tensorrtx_tpu.core.engine import load_engine as jax_load_engine
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.core.runner import ServingPipeline as JaxPipeline
from tensorrtx_tpu.models import yolo11 as jy
from tensorrtx_tpu.ops.pallas import conv_planar as jcp
from tensorrtx_tpu.ops.pallas.quantize import quantize_int8 as jax_quantize_int8
from tensorrtx_tpu_torch import cli
from tensorrtx_tpu_torch.core import engine as teng
from tensorrtx_tpu_torch.core import quant as tq
from tensorrtx_tpu_torch.core.convert import params_from_jax
from tensorrtx_tpu_torch.core.runner import ServingPipeline
from tensorrtx_tpu_torch.models import yolo11 as ty
from tensorrtx_tpu_torch.ops import quant_ctx as tqctx
from tensorrtx_tpu_torch.ops.cuda import conv_planar as tcp
from tensorrtx_tpu_torch.ops.cuda import quantize as tqz

REPO = Path(__file__).resolve().parents[1]
H = 64


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


# ---------------------------------------------------------------------------
# quantize_int8: both forms, each against its own source
# ---------------------------------------------------------------------------

def quant_inputs(seed, scale):
    """Values on every half-integer multiple of the scale (exact ties when
    the scale is a power of two), values beyond ±127·s, and noise."""
    rng = np.random.default_rng(seed)
    ties = (np.arange(-300, 301) + 0.5) * scale
    x = np.concatenate([ties, rng.normal(0, 60 * scale, 4003), [200 * scale, -500 * scale]])
    return x.astype(np.float32).reshape(2, -1, 7)


@pytest.mark.parametrize("scale", [0.25, 0.05, 0.0371])
def test_quantize_int8_plain_matches_pallas_kernel(scale):
    x = quant_inputs(1, scale)
    exp = np.asarray(jax_quantize_int8(jnp.asarray(x), scale, interpret=True))
    got = tqz.quantize_int8(t(x), torch.tensor(scale, dtype=torch.float32))
    assert got.dtype == torch.int8 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), exp)
    assert (np.abs(exp) == 127).any() and (np.abs(exp) < 127).mean() > 0.8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_divide_matches_the_tier_formula(dtype):
    """The tier's form (`ops/nn.py:98`): clip(round(x.astype(f32) / sx))."""
    for scale in (0.25, 0.0371):
        x = t(quant_inputs(2, scale)).to(dtype)
        xf = x.float().numpy()
        exp = jax.jit(lambda x, s: jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8))(
            xf, np.float32(scale))
        got = tqz.quantize_int8(x, scale, divide=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_quantize_int8_refuses_what_the_kernel_cannot_take():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        tqz.quantize_int8(x.t(), 0.1)
    with pytest.raises(TypeError):
        tqz.quantize_int8(x.double(), 0.1)


# ---------------------------------------------------------------------------
# quantize_int8_stochastic: properties (TPU random bits cannot be reproduced)
# ---------------------------------------------------------------------------

def test_philox_known_answers():
    """Random123's known-answer vectors for philox4x32_10."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, exp in cases:
        got = tqz.philox4x32_10(*[torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
        assert tuple(int(g) for g in got) == exp


def test_quantize_int8_stochastic_properties():
    s = 0.0625            # a power of two: x · (1/s) is exact, integers stay integers
    base = np.random.default_rng(3).normal(0, 3, 64).astype(np.float32)
    base[:4] = [127 * s, -127 * s, 200 * s, -300 * s]      # at and beyond the range
    base[4:8] = [0.0, 2 * s, -5 * s, 0.5 * s]              # integers and a half
    draws = 4096
    x = t(np.tile(base, (draws, 1)))
    q = tqz.quantize_int8_stochastic(x, s, seed=11)
    assert q.dtype == torch.int8 and q.shape == x.shape
    qf = q.numpy().astype(np.float64)
    v = np.clip(base.astype(np.float64) / s, -127, 127)
    assert np.abs(qf).max() <= 127
    assert (np.abs(qf - v) < 1).all()
    assert (qf[:, 4:7] == v[4:7]).all()                     # integers never move
    frac = v - np.floor(v)
    sigma = np.sqrt(frac * (1 - frac) / draws)
    bias = qf.mean(0) - v
    assert (np.abs(bias) <= 5 * sigma + 1e-12).all()        # each element
    assert abs(bias.mean()) <= 3 * np.sqrt((sigma ** 2).sum()) / len(v)   # pooled, 3σ
    assert torch.equal(q, tqz.quantize_int8_stochastic(x, torch.tensor(s), seed=11))
    assert not torch.equal(q, tqz.quantize_int8_stochastic(x, s, seed=12))
    xb = x.to(torch.bfloat16)
    bf = tqz.quantize_int8_stochastic(xb, s, seed=11)
    assert (np.abs(bf.numpy() - np.clip(xb.float().numpy() / s, -127, 127)) < 1).all()


# ---------------------------------------------------------------------------
# planar convs
# ---------------------------------------------------------------------------

PLANAR = ([(3, act, res) for act, res in (("silu", False), ("relu", True), (None, False),
                                            ("silu", True))]
          + [(1, act, res) for act in ("silu", "relu", None) for res in (False, True)])
# (B, C, Co, H, W) of 1x1 cases at the CUDA kernel's edges: W = 33 (rows not
# 16-byte multiples), Co = 72 (two channel tiles), C = 1
PLANAR_1X1_EDGES = [(1, 17, 72, 8, 33), (2, 1, 24, 8, 33), (1, 3, 72, 8, 40)]
# and 3x3 cases: the C = 3 -> 16 stem, H = 5 with W = 33 (ragged rows, a row
# tile that is not 8), and B = 2 with a residual across the image boundary
PLANAR_3X3_EDGES = [(1, 3, 16, 8, 24), (1, 4, 8, 5, 33), (2, 5, 16, 7, 20)]


@pytest.mark.parametrize("k,act,res,shape", [
    *(pytest.param(*p, None, id="-".join(map(str, p))) for p in PLANAR),
    *(pytest.param(1, act, res, sh, id=f"1-{act}-{res}-{'x'.join(map(str, sh))}")
      for sh, (act, res) in zip(PLANAR_1X1_EDGES, (("silu", True), ("relu", False), (None, True)))),
    *(pytest.param(3, act, res, sh, id=f"3-{act}-{res}-{'x'.join(map(str, sh))}")
      for sh, (act, res) in zip(PLANAR_3X3_EDGES, (("silu", False), ("relu", False), (None, True)))),
])
def test_planar_conv_plain_matches_pallas_kernel(k, act, res, shape):
    rng = np.random.default_rng(10 * k + len(str(act)) + res)
    b, c, co, h, w = shape or ((2, 8, 16, 16, 16) if k == 3 else (2, 16, 8, 16, 16))
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    wt = rng.normal(0, 0.1, (k, k, c, co)).astype(np.float32)
    bias = rng.normal(0, 0.1, (co,)).astype(np.float32)
    r = rng.normal(0, 1, (b, h, co, w)).astype(np.float32) if res else None
    jfn, tfn = ((jcp.conv3x3_planar, tcp.conv3x3_planar) if k == 3
                else (jcp.conv1x1_planar, tcp.conv1x1_planar))
    exp = np.asarray(jfn(jcp.to_planar(jnp.asarray(x)), jnp.asarray(wt), jnp.asarray(bias),
                         residual=None if r is None else jnp.asarray(r), act=act,
                         th=8 if h % 8 == 0 else h, interpret=True))
    xp = tcp.to_planar(t(x))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jcp.to_planar(jnp.asarray(x))))
    np.testing.assert_array_equal(tcp.from_planar(xp).numpy(), x)
    got = tfn(xp, t(wt), t(bias), residual=None if r is None else t(r), act=act)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), exp, atol=1e-5)
    if k == 1:        # the (C, Co) weight form
        np.testing.assert_array_equal(
            tfn(xp, t(wt[0, 0]), t(bias), residual=None if r is None else t(r),
                act=act).numpy(), got.numpy())


# ---------------------------------------------------------------------------
# calibration math
# ---------------------------------------------------------------------------

def test_tap_histogram_matches_jnp_histogram():
    rng = np.random.default_rng(4)
    hi = np.float32(3.7)
    edges = np.asarray(jnp.linspace(0.0, hi, 2049, dtype=jnp.float32))
    xa = np.concatenate([edges, edges[::7], [hi, hi, 0.0], np.abs(rng.normal(0, 1, 5000)),
                         [4.5, 9.0]]).astype(np.float32)     # above the range: dropped
    exp, _ = jnp.histogram(jnp.asarray(xa), bins=2048, range=(0.0, float(hi)))
    got = tqctx.abs_histogram(t(xa), float(hi), 2048)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert float(got[-1]) >= 3 and float(got.sum()) == (xa <= hi).sum() < len(xa)


def test_scale_choosers_match_jax():
    rng = np.random.default_rng(5)
    data = np.append(np.abs(rng.normal(0, 1.0, 100000)), [8.0])
    hists = [np.histogram(data, bins=2048, range=(0, 8.0))[0].astype(np.float32),
             np.zeros(2048, np.float32)]
    for h, a in zip(hists, (8.0, 0.0)):
        assert tq.entropy_scale(h, a) == jq.entropy_scale(h, a)
        assert tq.percentile_scale(h, a) == jq.percentile_scale(h, a)


# ---------------------------------------------------------------------------
# the tier at 64²: YOLO11n, random weights, fp32
# ---------------------------------------------------------------------------

def _recording(mod, name, taps, real=True):
    """A stand-in for mod.<name>(hist, absmax) that records its inputs in
    taps and returns the real chooser's value (or, with real False, the
    call's position, 1-based)."""
    fn = getattr(mod, name)

    def spy(h, a):
        taps.append((np.array(h), float(a)))
        return fn(h, a) if real else float(len(taps))
    return spy


@pytest.fixture(scope="module")
def tier():
    """YOLO11n at 64² in both packages, calibrated with absmax and with
    percentile on the same batches. The percentile calibrations record
    what each package's `calibrate` hands its chooser: every tap's
    histogram and |x|max (entropy runs on the same two passes)."""
    jcfg = dataclasses.replace(jy.Yolo11Cfg(), input_h=H, input_w=H, postprocess="raw")
    tcfg = ty.Yolo11Cfg(input_h=H, input_w=H, postprocess="raw")
    params = jy.build_params(JaxRWM(seed=0), jcfg)
    je = JaxEngine("yolo11", jax.tree.map(jnp.asarray, params), jcfg, "fp32")
    te = teng.Engine("yolo11", params_from_jax(params), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.uniform(0, 1, (1, H, H, 3)).astype(np.float32) for _ in range(2)]
    taps = {"j": [], "t": []}
    scales = {"absmax": (jq.calibrate(je, batches, "absmax"), tq.calibrate(te, batches, "absmax"))}
    with pytest.MonkeyPatch.context() as mp:
        for key, mod in (("j", jq), ("t", tq)):
            mp.setattr(mod, "percentile_scale", _recording(mod, "percentile_scale", taps[key]))
        scales["percentile"] = (jq.calibrate(je, batches, "percentile"),
                                tq.calibrate(te, batches, "percentile"))
    return dict(je=je, te=te, params=params, batches=batches, scales=scales, taps=taps)


def test_trace_order_weights_match_jax(tier):
    jw = jq._conv_weights(tier["je"])
    tw = tq.conv_weights(tier["te"])
    assert len(tw) == len(jw) == 87
    for a, b in zip(jw, tw):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    for a, b in zip(jq.weight_scales(tier["je"], jw), tq.weight_scales(tier["te"], tw)):
        np.testing.assert_array_equal(a, b)
    _, convs = tq._slotted_copy(tier["te"], torch.float32)
    kinds = [(m.w.shape[2], m.stride) for m in convs if not m.slot.depthwise]
    assert sum(m.slot.depthwise for m in convs) == 7
    assert (kinds.count((3, 1)), kinds.count((3, 2)), kinds.count((1, 1))) == (28, 7, 45)


@pytest.mark.parametrize("method", ["absmax", "percentile"])
def test_calibrate_matches_jax(tier, method):
    exp, got = tier["scales"][method]
    assert got.dtype == np.float32 and got.shape == exp.shape == (87,)
    np.testing.assert_allclose(got, exp, rtol=1e-6)


def _check_tap_histograms(got, exp):
    """Tap by tap, what the port's calibration hands its chooser against
    JAX's: the same |x|max ranges (rtol 1e-6), and histograms with every
    tap's total equal and under 0.05 % of the values in another bin. Where
    both packages see the same float32 values the counts are equal
    (test_tap_histogram_matches_jnp_histogram); here the float32 rounding
    of the conv sums differs between XLA and torch, which moves the few
    values that sit within an ulp of an edge to the next bin (measured: 35
    of 454,016, in 14 of the 87 taps)."""
    assert len(got) == len(exp) == 87
    np.testing.assert_allclose([a for _, a in got], [a for _, a in exp], rtol=1e-6)
    assert all(g.sum() == e.sum() for (g, _), (e, _) in zip(got, exp))
    moved = sum(float(np.abs(g - e).sum()) for (g, _), (e, _) in zip(got, exp)) / 2
    total = sum(float(e.sum()) for e, _ in exp)
    assert moved / total < 5e-4, (moved, total)


def test_calibration_histograms_match_jax(tier):
    """The histogram pass of `calibrate`, tap by tap, as the fixture's
    percentile calibrations recorded it in each package."""
    _check_tap_histograms(tier["taps"]["t"], tier["taps"]["j"])


def test_calibrate_entropy_matches_jax(tier, monkeypatch):
    """Entropy calibration (the default, TensorRT's Int8EntropyCalibrator2
    analog) end to end in the port: `calibrate` hands the KL search each
    tap's histogram over [0, |x|max], those inputs match JAX's (recorded by
    the fixture: entropy and percentile share the two passes), and the
    search's thresholds come back in slot order. Then both packages' KL
    searches (~0.5 s a tap) run on every tap whose histogram differs
    between them and choose the same threshold; on the other taps the
    inputs are equal and the choosers are the same code
    (test_scale_choosers_match_jax)."""
    fed = []
    monkeypatch.setattr(tq, "entropy_scale", _recording(tq, "entropy_scale", fed, real=False))
    got = tq.calibrate(tier["te"], tier["batches"], "entropy")
    monkeypatch.undo()
    np.testing.assert_array_equal(got, np.arange(1, 88, dtype=np.float32))
    exp = tier["taps"]["j"]
    _check_tap_histograms(fed, exp)
    differ = [i for i, ((g, _), (e, _)) in enumerate(zip(fed, exp)) if not np.array_equal(g, e)]
    for i in differ:
        assert tq.entropy_scale(*fed[i]) == pytest.approx(jq.entropy_scale(*exp[i]), rel=1e-6), i


@pytest.fixture(scope="module")
def engines(tier):
    scales = tier["scales"]["percentile"][1]
    return jq.QuantizedEngine(tier["je"], scales), tq.QuantizedEngine(tier["te"], scales)


def test_quantized_engine_matches_jax(tier, engines):
    """Raw per-anchor outputs at the same scales: conf 1e-4, boxes 0.05 px,
    classes on ≥ 99 % of the anchors (the bars of tests/test_torch_qchain.py).
    The int32 sums are exact in both packages; what is left is the float32
    rounding of the float layers between them (attention, depthwise convs,
    decode) and a quantize flip where that rounding meets a rounding tie."""
    jqe, tqe = engines
    slots = tqe.slots()
    assert len(slots) == len(jqe.wq) == 87
    for a, sl in zip(jqe.wq, slots):
        if sl.depthwise:      # served in float: no int8 weight on the device
            assert sl.wq is None
        else:
            np.testing.assert_array_equal(np.asarray(a).transpose(3, 0, 1, 2), sl.wq.numpy())
    x = np.random.default_rng(1).uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    exp = {k: np.asarray(v) for k, v in jqe(x).items()}
    got = {k: v.numpy() for k, v in tqe(x).items()}
    assert got["boxes"].shape == exp["boxes"].shape == (2, 84, 4)
    assert np.abs(got["conf"] - exp["conf"]).max() <= 1e-4
    assert np.abs(got["boxes"] - exp["boxes"]).max() <= 0.05
    assert (got["cls"] == exp["cls"]).mean() >= 0.99
    fl = {k: v.numpy() for k, v in tier["te"](x).items()}
    assert np.abs(fl["conf"] - got["conf"]).max() > 0      # the int8 path ran


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda z: np.prod(np.clip(z[:, 2:] - z[:, :2], 0, None), -1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def test_serving_pipeline_matches_jax(tier, engines):
    """uint8 frames → detections through `ServingPipeline` on a
    `QuantizedEngine` in both packages (JAX's runs the int8 s2d serving
    path, exact against its plain int8 apply by tests/test_quant.py)."""
    cfgs = {p: dataclasses.replace(tier[e].cfg, postprocess="nms", conf_thresh=0.25,
                                   max_det=32) for p, e in (("j", "je"), ("t", "te"))}
    tqe = tq.QuantizedEngine(teng.Engine("yolo11", params_from_jax(tier["params"]), cfgs["t"],
                                         device="cpu"), tier["scales"]["percentile"][1])
    # the JAX engine of the raw tests with the nms tail: its pipeline reads
    # cfg, params and raw_apply_s2d (which takes self.cfg), so a shallow
    # copy spares a second eager weight-collection pass
    jqe = copy.copy(engines[0])
    jqe.cfg = cfgs["j"]
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8),
              rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)]
    exp = JaxPipeline(jqe, 64, 64, donate=False).detect_images(images)
    got = ServingPipeline(tqe, 64, 64).detect_images(images)
    n_total = 0
    for e, g in zip(exp, got):
        assert len(g["boxes"]) == len(e["boxes"])
        n_total += len(g["boxes"])
        if len(e["boxes"]):
            iou = _iou(g["boxes"], e["boxes"])
            same = g["classes"][:, None] == e["classes"][None, :]
            assert (np.where(same, iou, 0).max(1) > 0.99).all()
    assert n_total > 0


def test_int8_engine_dirs_cross_both_ways(tier, engines, tmp_path):
    jqe, tqe = engines
    x = np.random.default_rng(2).uniform(0, 1, (1, H, H, 3)).astype(np.float32)
    jqe.save(str(tmp_path / "j"))
    te = teng.load_engine(str(tmp_path / "j"), device="cpu")
    assert isinstance(te, tq.QuantizedEngine) and te.precision == "int8"
    np.testing.assert_array_equal(te.act_scales, jqe.act_scales)
    np.testing.assert_array_equal(te(x)["conf"].numpy(), tqe(x)["conf"].numpy())
    assert isinstance(teng.Engine.load(str(tmp_path / "j"), device="cpu"), teng.Engine)

    tqe.save(str(tmp_path / "t"))
    meta = json.loads((tmp_path / "t" / "meta.json").read_text())
    assert meta["int8"] is True
    assert json.loads((tmp_path / "t" / "int8calib.json").read_text())["meta"] == {
        "model": "yolo11"}
    je2 = jax_load_engine(str(tmp_path / "t"))
    assert type(je2).__name__ == "QuantizedEngine"
    np.testing.assert_array_equal(je2.act_scales, tqe.act_scales)
    np.testing.assert_allclose(np.asarray(je2(x)["conf"]), tqe(x)["conf"].numpy(), atol=1e-4)


def test_tier_refuses_what_is_not_served(tier):
    te = tier["te"]
    with pytest.raises(ValueError):
        tq.calibrate(te, [], "absmax")
    with pytest.raises(ValueError):
        tq.calibrate(te, tier["batches"], "minmax")
    with pytest.raises(ValueError):
        tq.QuantizedEngine(te, np.ones(5, np.float32))
    fp16 = teng.Engine("yolo11", params_from_jax(tier["params"]), te.cfg, "fp16", device="cpu")
    with pytest.raises(NotImplementedError):
        tq.QuantizedEngine(fp16, tier["scales"]["absmax"][1])


def test_int8_entry_points_default_to_the_card():
    for fn in (tq.QuantizedEngine.load, teng.load_engine):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_cli_builds_and_runs_an_int8_engine(tmp_path, capsys):
    from PIL import Image

    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
    from tensorrtx_tpu_torch.core.wts import save_wts

    wm = RandomWeightMap(seed=0)
    ty.build_params(wm, ty.Yolo11Cfg())
    save_wts(str(tmp_path / "y.wts"), wm.raw)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(8)
    for i, (h, w) in enumerate([(64, 48), (50, 64), (64, 64)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
    out = tmp_path / "y.int8"
    assert cli.main(["build", "yolo11", "-w", str(tmp_path / "y.wts"), "-o", str(out),
                     "--set", f"input_h={H}", f"input_w={H}", "--int8-calib-dir", str(imgs),
                     "--calib-method", "percentile", "--calib-images", "2",
                     "--device", "cpu"]) == 0
    assert json.loads((out / "meta.json").read_text())["int8"] is True
    assert len(json.loads((out / "int8calib.json").read_text())["act_scales"]) == 87
    capsys.readouterr()
    assert cli.main(["run", str(out), str(imgs), "--batch", "2", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [Path(ln["image"]).name for ln in lines] == ["0.png", "1.png", "2.png"]


def test_quant_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['tensorrtx_tpu'] = None\n"
            "from tensorrtx_tpu_torch.core import quant\n"
            "from tensorrtx_tpu_torch.ops import quant_ctx\n"
            "from tensorrtx_tpu_torch.ops.cuda import quantize, conv_planar\n"
            "print(quant.QuantizedEngine.__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "QuantizedEngine"

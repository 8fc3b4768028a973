"""The port's chained int8 tier (tensorrtx_tpu_torch: ops/cuda/qconv,
ops/qchain, models/_yolo_qchain, yolo11.apply_chain, core/quant) against
the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its Pallas kernels in interpret mode and its XLA chain as is;
every JAX pass is jitted. The port's int8 convs take their plain versions
here (CPU tensors); `tests/test_torch_gpu.py` holds the CUDA kernels
against those plain versions on the card.

Requant bound: an int8 output may differ by one step (1 LSB) where
``o / s_out`` lies within float32 rounding of a half-integer (SiLU's
sigmoid is a different transcendental in XLA and torch), on under 1 % of
the elements — the budget of tests/test_qconv_pallas.py.
"""

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
from torch import nn

from tensorrtx_tpu.core.engine import Engine as JaxEngine
from tensorrtx_tpu.core.quant import ChainedInt8Engine as JaxChained
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.models import _yolo_blocks as JB
from tensorrtx_tpu.models import _yolo_qchain as JQ
from tensorrtx_tpu.models import yolo11 as jy
from tensorrtx_tpu.ops import qchain as jqc
from tensorrtx_tpu.ops.pallas import qconv as jpk
from tensorrtx_tpu.ops.preprocess import letterbox_s2d_batch
from tensorrtx_tpu_torch import cli
from tensorrtx_tpu_torch.core import engine as teng
from tensorrtx_tpu_torch.core.convert import chain_weights_from_jax, params_from_jax
from tensorrtx_tpu_torch.core.quant import ChainedInt8Engine
from tensorrtx_tpu_torch.models import _yolo_blocks as TB
from tensorrtx_tpu_torch.models import _yolo_qchain as TQ
from tensorrtx_tpu_torch.models import yolo11 as ty
from tensorrtx_tpu_torch.ops import qchain as tqc
from tensorrtx_tpu_torch.ops.cuda import qconv as tk

REPO = Path(__file__).resolve().parents[1]
H = 96
f32 = jnp.float32


def lsb_ok(got, exp, frac=0.01):
    """int8 payloads within one step, differing on under `frac` of them."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(exp, np.int32))
    assert d.max() <= 1, f"max LSB diff {d.max()}"
    assert (d > 0).mean() < frac, f"{(d > 0).mean():.4f} of the elements differ"


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def int8_inputs(rng, b, h, w, c, co, k):
    xq = rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, k, c, co), dtype=np.int8)          # HWIO
    scale = (rng.uniform(0.5, 1.5, co) / (127.0 * 127.0 * k * c ** 0.5) * 8).astype(np.float32)
    bias = rng.normal(0, 0.3, co).astype(np.float32)
    return xq, wq, scale, bias


def ohwi(wq):
    return t(np.asarray(wq).transpose(3, 0, 1, 2))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the TPU kernels and the XLA chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,hh,ww,c,co", [(3, 8, 16, 128, 128), (1, 4, 16, 256, 64)])
@pytest.mark.parametrize("act", ["silu", "relu", None])
def test_plain_qconv_matches_pallas_kernel(k, hh, ww, c, co, act):
    rng = np.random.default_rng(k * 10 + len(str(act)))
    xq, wq, scale, bias = int8_inputs(rng, 3 if k == 3 else 1, hh, ww, c, co, k)
    jfn, tfn = (jpk.qconv3x3, tk.qconv3x3) if k == 3 else (jpk.qconv1x1, tk.qconv1x1)
    exp = jfn(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale), jnp.asarray(bias),
              f32(0.02), act=act, interpret=True)
    got = tfn(t(xq), ohwi(wq), t(scale), t(bias), 0.02, act=act)
    assert got.dtype == torch.int8 and tuple(got.shape) == exp.shape
    lsb_ok(got.numpy(), exp)


def test_plain_qconv_residual_and_float_exit_match_pallas_kernel():
    rng = np.random.default_rng(7)
    xq, wq, scale, bias = int8_inputs(rng, 2, 8, 16, 128, 128, 3)
    res = rng.integers(-127, 128, (2, 8, 16, 128), dtype=np.int8)
    exp = jpk.qconv3x3(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                       jnp.asarray(bias), f32(0.02), act="relu", residual=jnp.asarray(res),
                       res_scale=f32(0.01), interpret=True)
    got = tk.qconv3x3(t(xq), ohwi(wq), t(scale), t(bias), 0.02, act="relu",
                      residual=t(res), res_scale=0.01)
    lsb_ok(got.numpy(), exp)
    for kk, jfn, tfn in ((3, jpk.qconv3x3, tk.qconv3x3), (1, jpk.qconv1x1, tk.qconv1x1)):
        xq, wq, scale, bias = int8_inputs(rng, 2, 8, 16, 128, 64, kk)
        exp = jfn(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale), jnp.asarray(bias),
                  f32(1.0), act=None, out_float=True, out_dtype=f32, interpret=True)
        got = tfn(t(xq), ohwi(wq), t(scale), t(bias), None, act=None, out_float=True,
                  out_dtype=torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)


# shapes the Pallas gate refuses: the XLA formulation is the reference there
XLA_CASES = [
    # (op, k, stride, B, H, W, C, Co, act)
    ("conv", 3, 2, 2, 11, 9, 16, 32, "silu"),
    ("conv", 3, 2, 1, 20, 20, 64, 64, "silu"),
    ("conv", 1, 1, 2, 5, 7, 80, 80, "silu"),
    ("conv", 1, 1, 2, 5, 7, 96, 48, "relu"),
    ("conv", 3, 1, 1, 173, 16, 128, 128, "silu"),     # crashes the Pallas kernel
    ("conv_add", 3, 1, 1, 173, 16, 128, 128, "relu"),
    ("conv_add", 1, 1, 2, 6, 6, 80, 80, "silu"),
    ("conv_out", 1, 1, 2, 5, 7, 80, 80, None),
    ("conv_out", 3, 1, 1, 9, 11, 24, 40, "silu"),
    # tails of the 1×1 tensor-core GEMM: K (C = 48), N (Co = 32), M (2·5·7
    # = 70; 9·11 = 99, not a multiple of 64) and the byte-wise path (C = 6)
    ("conv", 1, 1, 2, 5, 7, 48, 32, "silu"),
    ("conv", 1, 1, 1, 13, 7, 6, 10, "relu"),
    ("conv_add", 1, 1, 1, 9, 11, 512, 256, "silu"),
    ("conv_out", 1, 1, 2, 5, 7, 48, 32, None),
    # the float-resident tier's stem shapes through the 3×3 tensor-core
    # GEMM: the C = 3 stride-2 stem on an odd map, C = 8, and a float exit
    ("conv", 3, 2, 1, 17, 13, 3, 16, "silu"),
    ("conv", 3, 1, 2, 9, 11, 8, 16, "silu"),
    ("conv_out", 3, 1, 1, 9, 11, 16, 32, None),
]


@pytest.mark.parametrize("case", XLA_CASES, ids=str)
def test_plain_qconv_matches_xla_chain(case):
    op, k, stride, b, hh, ww, c, co, act = case
    rng = np.random.default_rng(sum(case[1:8]))
    xq, wq, _, bias = int8_inputs(rng, b, hh, ww, c, co, k)
    s_in, s_out = np.float32(0.05), np.float32(0.04)
    sw = (rng.uniform(0.5, 1.5, co) / (127.0 * k * c ** 0.5) * 3).astype(np.float32)
    ho, wo = (hh - 1) // stride + 1, (ww - 1) // stride + 1
    res = rng.integers(-127, 128, (b, ho, wo, co), dtype=np.int8)
    w_float = np.zeros((k, k, c, co), np.float32)     # read in tap mode only

    def jrun(xq, wq, sw, b_, res, s_in, s_out):
        ctx = jqc.ChainCtx("run", scales=jnp.stack([s_out]), wq=[wq], sw=[sw], dtype=f32,
                           pallas=False)
        x = jqc.QTensor(xq, s_in)
        if op == "conv":
            return ctx.conv(x, w_float, b_, act=act, stride=stride).q
        if op == "conv_add":
            return ctx.conv_add(x, w_float, b_, jqc.QTensor(res, s_in * 0.5), act=act).q
        return ctx.conv_out(x, w_float, b_, act=act)

    exp = jax.jit(jrun)(xq, wq, sw, bias, res, s_in, s_out)
    ctx = tqc.ChainCtx("run", scales=t([s_out]), wq=[ohwi(wq)], sw=[t(sw)],
                       dtype=torch.float32)
    x = tqc.QTensor(t(xq), t(s_in))
    wt = t(w_float.transpose(3, 2, 0, 1))
    if op == "conv":
        got = ctx.conv(x, wt, t(bias), act=act, stride=stride).q
    elif op == "conv_add":
        got = ctx.conv_add(x, wt, t(bias), tqc.QTensor(t(res), t(s_in) * 0.5), act=act).q
    else:
        got = ctx.conv_out(x, wt, t(bias), act=act)
    assert tuple(got.shape) == exp.shape
    if op == "conv_out":
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)
    else:
        lsb_ok(got.numpy(), exp)


GEMM_CASES = [
    # (B, H, W, C, Co, act, residual, out)
    (2, 5, 7, 48, 32, "silu", False, "int8"),
    (1, 13, 7, 6, 10, "relu", True, "int8"),
    (1, 9, 11, 512, 256, "silu", True, "int8"),
    (2, 5, 7, 80, 80, None, False, "float32"),
    (1, 9, 11, 384, 128, "silu", False, "bfloat16"),
    (2, 5, 7, 48, 32, None, False, "exact"),
]


@pytest.mark.parametrize("case", GEMM_CASES, ids=str)
def test_plain_qconv1x1_is_an_exact_gemm(case):
    """The 1×1 plain version is an exact int64 GEMM (B·H·W, C) × (C, Co)
    followed by the epilogue in the kernel's order: the formulation the
    tensor-core kernel computes. "exact": float32 exit with scale 1, no
    bias and no activation, the int32 sum itself."""
    b, hh, ww, c, co, act, residual, out = case
    rng = np.random.default_rng(sum(case[:5]))
    xq, wq, scale, bias = int8_inputs(rng, b, hh, ww, c, co, 1)
    xq, wq, scale, bias = t(xq), ohwi(wq), t(scale), t(bias)
    if out == "exact":
        scale, bias, act = torch.ones(co), None, None
    kw = {"act": act, "out_float": out != "int8",
          "out_dtype": torch.bfloat16 if out == "bfloat16" else torch.float32}
    if residual:
        kw["residual"] = t(rng.integers(-127, 128, (b, hh, ww, co), dtype=np.int8))
        kw["res_scale"] = torch.tensor(0.01)
    got = tk.qconv1x1(xq, wq, scale, bias, torch.tensor(0.02), **kw)

    acc = (xq.reshape(-1, c).long() @ wq.reshape(co, c).long().t()).reshape(b, hh, ww, co)
    assert int(acc.abs().max()) < 2 ** 24
    o = acc.to(torch.float32) * scale
    if bias is not None:
        o = o + bias
    if residual:
        o = o + kw["residual"].to(torch.float32) * kw["res_scale"]
    o = tk.act_f(o, act)
    exp = o.to(kw["out_dtype"]) if kw["out_float"] else tk.requant(o, torch.tensor(0.02))
    assert got.dtype == exp.dtype and torch.equal(got, exp)
    if out == "exact":
        assert torch.equal(got, acc.to(torch.float32))


GEMM3_CASES = [
    # (stride, B, H, W, C, Co, act, residual, out)
    (2, 1, 17, 13, 3, 16, None, False, "exact"),     # the tier's C = 3 stem
    (2, 2, 9, 11, 3, 16, None, False, "bfloat16"),
    (1, 1, 12, 10, 8, 16, None, False, "exact"),     # C = 8: two taps a chunk
    (1, 2, 7, 9, 16, 8, "silu", False, "int8"),      # Co = 8: one n8 fragment
    (2, 1, 10, 8, 16, 32, None, False, "exact"),
    (1, 1, 5, 7, 48, 40, "relu", True, "int8"),      # K (432) and N (40) tails
    (2, 2, 11, 9, 48, 16, None, False, "float32"),
    (1, 1, 6, 5, 128, 72, "silu", False, "int8"),
]


def im2col3x3(xq, stride):
    """(B·Ho·Wo, 9·C) int64: row (b, oy, ox) holds the input pixels
    (oy·s + ky − 1, ox·s + kx − 1), zero in the padding, ordered (tap, c)
    with tap = 3·ky + kx: the A operand of the 3×3 kernel's implicit GEMM."""
    b, h, w, c = xq.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = torch.nn.functional.pad(xq.long(), (0, 0, 1, 1, 1, 1))
    taps = [xp[:, ky:ky + stride * (ho - 1) + 1:stride, kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, 3).reshape(b * ho * wo, 9 * c)


@pytest.mark.parametrize("case", GEMM3_CASES, ids=str)
def test_plain_qconv3x3_is_an_exact_gemm(case):
    """The 3×3 plain version is an exact int64 GEMM of the (tap, c)-ordered
    im2col matrix with the OHWI weight read as (Co, 9·C), followed by the
    epilogue in the kernel's order: the formulation the tensor-core kernel
    computes, and the weight layout it relies on. "exact": float32 exit with
    scale 1, no bias and no activation, the int32 sum itself."""
    stride, b, hh, ww, c, co, act, residual, out = case
    rng = np.random.default_rng(sum(case[:6]))
    xq, wq, scale, bias = int8_inputs(rng, b, hh, ww, c, co, 3)
    xq, wq, scale, bias = t(xq), ohwi(wq), t(scale), t(bias)
    if out == "exact":
        scale, bias, act = torch.ones(co), None, None
    ho, wo = (hh - 1) // stride + 1, (ww - 1) // stride + 1
    kw = {"act": act, "out_float": out != "int8", "stride": stride,
          "out_dtype": torch.bfloat16 if out == "bfloat16" else torch.float32}
    if residual:
        kw["residual"] = t(rng.integers(-127, 128, (b, ho, wo, co), dtype=np.int8))
        kw["res_scale"] = torch.tensor(0.01)
    got = tk.qconv3x3(xq, wq, scale, bias, torch.tensor(0.02), **kw)

    acc = (im2col3x3(xq, stride) @ wq.reshape(co, 9 * c).long().t()).reshape(b, ho, wo, co)
    assert int(acc.abs().max()) < 2 ** 24
    o = acc.to(torch.float32) * scale
    if bias is not None:
        o = o + bias
    if residual:
        o = o + kw["residual"].to(torch.float32) * kw["res_scale"]
    o = tk.act_f(o, act)
    exp = o.to(kw["out_dtype"]) if kw["out_float"] else tk.requant(o, torch.tensor(0.02))
    assert got.dtype == exp.dtype and torch.equal(got, exp)
    if out == "exact":
        assert torch.equal(got, acc.to(torch.float32))
    elif out == "int8":
        assert float((exp.abs() == 127).float().mean()) < 0.5     # not all saturated


# ---------------------------------------------------------------------------
# ChainCtx op by op
# ---------------------------------------------------------------------------

def _payload(rng, shape, s):
    return rng.integers(-127, 128, shape, dtype=np.int8), np.float32(s)


CTX_OPS = ["quant_in", "concat", "add", "maxpool", "upsample", "split", "dwconv",
           "to_float", "from_float", "avgpool2_s1", "add_n"]


@pytest.mark.parametrize("op", CTX_OPS)
def test_chainctx_op_matches_jax(op):
    rng = np.random.default_rng(len(op))
    shape = (2, 7, 6, 24)
    qa, sa = _payload(rng, shape, 0.031)
    qb, sb = _payload(rng, shape, 0.047)
    qc, sc = _payload(rng, shape[:3] + (8,), 0.02)
    xf = rng.normal(0, 2, shape).astype(np.float32)
    wdw = rng.normal(0, 0.2, (3, 3, 1, 24)).astype(np.float32)            # HWIO
    bdw = rng.normal(0, 0.1, 24).astype(np.float32)
    s_out = np.float32(0.039)

    def apply(ctx, Q, arr, w):
        """The op in one package: its ChainCtx, QTensor, array maker and
        depthwise weight."""
        a, b, c = Q(arr(qa), arr(sa)), Q(arr(qb), arr(sb)), Q(arr(qc), arr(sc))
        return {
            "quant_in": lambda: ctx.quant_in(arr(xf)),
            "concat": lambda: ctx.concat([a, c, b]),
            "add": lambda: ctx.add(a, b),
            "maxpool": lambda: ctx.maxpool(a, 5),
            "upsample": lambda: ctx.upsample(a),
            "split": lambda: ctx.split(a, (8, 16))[1],
            "dwconv": lambda: ctx.dwconv(a, w, arr(bdw)),
            "to_float": lambda: ctx.to_float(a),
            "from_float": lambda: ctx.from_float(arr(xf)),
            "avgpool2_s1": lambda: ctx.avgpool2_s1(a),
            "add_n": lambda: ctx.add_n([a, b, a]),
        }[op]()

    jw = jnp.asarray(wdw, jnp.bfloat16)          # the JAX package keeps dw weights in bf16
    jctx = jqc.ChainCtx("run", scales=jnp.asarray([s_out]), wq=[jw], sw=[jnp.ones(24)],
                        dtype=f32)
    exp = jax.jit(lambda: apply(jctx, jqc.QTensor, jnp.asarray, jnp.asarray(wdw)))()
    tw, _ = chain_weights_from_jax([jw], [np.ones(24, np.float32)])
    tctx = tqc.ChainCtx("run", scales=t([s_out]), wq=tw, sw=[torch.ones(24)],
                        dtype=torch.float32)
    got = apply(tctx, tqc.QTensor, t, t(wdw.transpose(3, 2, 0, 1)))
    if isinstance(exp, jqc.QTensor):
        assert isinstance(got, tqc.QTensor) and got.q.dtype == torch.int8
        assert got.q.is_contiguous() and tuple(got.q.shape) == exp.q.shape
        assert float(got.s) == float(exp.s)
        lsb_ok(got.q.numpy(), exp.q, frac=0.005)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


# ---------------------------------------------------------------------------
# chain blocks
# ---------------------------------------------------------------------------

def _head_modules(q, r):
    return (nn.ModuleDict({"a": TB.Conv(q["a"]), "b": TB.Conv(q["b"]),
                           "c": TB.Conv(q["c"], act=False)}),
            nn.ModuleDict({k: TB.Conv(r[k], act=k != "c") for k in ("a0", "a1", "b0", "b1", "c")}))


def _head_p(wm):
    p = jy._det_head_p(wm, dataclasses.replace(jy.Yolo11Cfg(), scale="n"), "model.23", 80)
    return {"q": p["cv2"][0], "r": p["cv3"][0]}


QBLOCKS = {
    # name: (param builder, JAX chain block, port module, port chain block, C in)
    "c3k2_bottleneck": (lambda wm: JB.c3k2_p(wm, "m", 32, 48, 2, False, e=0.5),
                        JQ.qc3k2_a, TB.C3k2, TQ.qc3k2_a, 32),
    "c3k2_c3k": (lambda wm: JB.c3k2_p(wm, "m", 32, 32, 1, True, e=0.5),
                 JQ.qc3k2_a, TB.C3k2, TQ.qc3k2_a, 32),
    "sppf": (lambda wm: JB.sppf_p(wm, "m", 64, 64), JQ.qsppf_a, TB.SPPF, TQ.qsppf_a, 64),
    "c2psa": (lambda wm: JB.c2psa_p(wm, "m", 128, 128, 1), JQ.qc2psa_a, TB.C2PSA,
              TQ.qc2psa_a, 128),
    "det_head_lv": (_head_p, lambda ctx, p, x: JQ.qdet_head_lv(ctx, p["q"], p["r"], x),
                    lambda p: _head_modules(p["q"], p["r"]),
                    lambda ctx, m, x: TQ.qdet_head_lv(ctx, m[0], m[1], x), 64),
}


@pytest.mark.parametrize("name", sorted(QBLOCKS))
def test_chain_block_matches_jax(name):
    build, jblock, module, tblock, cin = QBLOCKS[name]
    p = build(JaxRWM(seed=3, scale=0.1))
    x = np.random.default_rng(1).normal(size=(2, 6, 5, cin)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    meta = {}

    def jtap(p, x):
        ctx = jqc.ChainCtx("tap", dtype=f32)
        jblock(ctx, p, ctx.quant_in(x))
        meta["dw"] = ctx.w_is_dw
        return ctx.taps, ctx.ws

    taps, ws = jax.jit(jtap)(jp, x)
    jscales = jnp.maximum(jnp.stack(taps) / 127.0, 1e-8)
    jwq, jsw = jqc.quantize_chain_weights([np.asarray(w) for w in ws], meta["dw"])

    def jrun(p, wq, scales, x):
        ctx = jqc.ChainCtx("run", scales=scales, wq=wq, sw=jsw, dtype=f32)
        return jblock(ctx, p, ctx.quant_in(x))

    exp = jax.jit(jrun)(jp, jwq, jscales, x)

    m = module(params_from_jax(p))
    tctx = tqc.ChainCtx("tap", dtype=torch.float32)
    with torch.inference_mode():
        tblock(tctx, m, tctx.quant_in(t(x)))
    assert tctx.n_scales == len(taps) and tctx.w_is_dw == meta["dw"]
    np.testing.assert_allclose(torch.stack(tctx.taps).numpy(), np.asarray(jnp.stack(taps)),
                               rtol=1e-5)
    twq, tsw = tqc.quantize_chain_weights(tctx.ws, tctx.w_is_dw)
    cwq, csw = chain_weights_from_jax(jwq, jsw)
    for a, b in zip(twq, cwq):               # the port quantizes the weights as JAX does
        assert torch.equal(a, b)
    ctx = tqc.ChainCtx("run", scales=t(jscales), wq=cwq, sw=csw, dtype=torch.float32)
    with torch.inference_mode():
        got = tblock(ctx, m, ctx.quant_in(t(x)))
    if name == "det_head_lv":
        for g, e in zip(got, exp):
            # float exits of int8 convs whose inputs may sit one step apart
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=0.05)
            assert np.mean(np.abs(g.numpy() - np.asarray(e)) > 1e-5) < 0.05
    else:
        assert float(got.s) == float(exp.s)
        lsb_ok(got.q.numpy(), exp.q)


# ---------------------------------------------------------------------------
# the slice: letterbox → float stem → int8 chain → decode, YOLO11n at 96²
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_run():
    """YOLO11n (random weights, seed 0), 96² input, float32 islands in both
    packages; 2 frames of true size (120, 100) and (80, 90) in a 120×100
    bucket; calibration on the full frames. Returns what both packages
    computed."""
    jcfg = dataclasses.replace(jy.Yolo11Cfg(), input_h=H, input_w=H, postprocess="raw")
    tcfg = ty.Yolo11Cfg(input_h=H, input_w=H, postprocess="raw")
    params = jy.build_params(JaxRWM(seed=0), jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 120, 100, 3), dtype=np.uint8)
    full_hw = np.array([[120, 100], [120, 100]], np.int32)
    src_hw = np.array([[120, 100], [80, 90]], np.int32)
    meta = {}

    def x4(frames, hw):
        return letterbox_s2d_batch(frames, hw, H, H, out_dtype=f32, factor=4)

    def jtap(p, frames, hw):
        ctx = jqc.ChainCtx("tap", dtype=f32, enter="m3")
        jy.apply_chain(p, x4(frames, hw), jcfg, ctx, f=1)
        meta["dw"] = ctx.w_is_dw
        return ctx.taps, ctx.ws

    taps, ws = jax.jit(jtap)(jp, frames, full_hw)
    jscales = np.maximum(np.asarray(jnp.stack(taps)) / np.float32(127.0), np.float32(1e-8))
    jwq, jsw = jqc.quantize_chain_weights([np.asarray(w) for w in ws], meta["dw"])

    def jrun(p, wq, scales, frames, hw):
        ctx = jqc.ChainCtx("run", scales=scales, wq=wq, sw=jsw, dtype=f32, enter="m3")
        return jy.apply_chain(p, x4(frames, hw), jcfg, ctx, f=1)

    exp = {k: np.asarray(v) for k, v in
           jax.jit(jrun)(jp, jwq, jnp.asarray(jscales), frames, src_hw).items()}

    eng = teng.Engine("yolo11", params_from_jax(params), tcfg, device="cpu")
    ce = ChainedInt8Engine(eng, dtype=torch.float32)
    tscales = ce.calibrate([frames])
    own_wq = ce.wq
    ce.wq, ce.sw = chain_weights_from_jax(jwq, jsw)
    ce.set_scales(jscales)
    got = {k: v.numpy() for k, v in ce(frames, src_hw).items()}
    return dict(jscales=jscales, tscales=tscales, n_w=len(jwq), ce=ce, exp=exp, got=got,
                own_wq=own_wq, frames=frames, src_hw=src_hw, tcfg=tcfg, params=params)


def test_slice_slots_and_scales_match_jax(slice_run):
    r = slice_run
    assert r["ce"].n_scales == len(r["jscales"]) == 95
    assert len(r["ce"].wq) == r["n_w"] == 74
    np.testing.assert_allclose(r["tscales"], r["jscales"], rtol=1e-5)
    for a, b in zip(r["own_wq"], r["ce"].wq):
        assert torch.equal(a, b)
    kinds = [(w.dtype, w.shape[1]) for w in r["ce"].wq]
    assert kinds.count((torch.int8, 3)) == 31 and kinds.count((torch.int8, 1)) == 37


def test_slice_raw_outputs_match_jax(slice_run):
    """With identical scales and weights the raw per-anchor outputs agree
    to conf 1e-4 and boxes 0.05 px, classes on ≥ 99 % of the anchors.
    Measured: conf 6e-8, boxes 6e-5 px, classes all equal — the int32
    sums are exact in both packages, so what is left is the float32
    rounding of the float stem (JAX runs it as s2d convs) and of the
    decode; the bounds leave room for a requant flip at a rounding tie
    (the bound above). Random weights make YOLO11n's scores nearly
    input-independent, so the scales and the block tests carry most of
    the signal; this test holds the slot order and the wiring of the
    whole slice."""
    exp, got = slice_run["exp"], slice_run["got"]
    assert got["boxes"].shape == exp["boxes"].shape == (2, 189, 4)
    assert np.isfinite(got["boxes"]).all()
    assert np.abs(got["conf"] - exp["conf"]).max() <= 1e-4
    assert np.abs(got["boxes"] - exp["boxes"]).max() <= 0.05
    assert (got["cls"] == exp["cls"]).mean() >= 0.99


def test_slice_serves_detections(slice_run):
    """The nms tail of the chained engine serves the detection dict that
    `present_detections` maps back to each image."""
    from tensorrtx_tpu_torch.core.runner import present_detections

    r = slice_run
    cfg = dataclasses.replace(r["tcfg"], postprocess="nms", conf_thresh=0.25)
    eng = teng.Engine("yolo11", params_from_jax(r["params"]), cfg, device="cpu")
    ce = ChainedInt8Engine(eng, dtype=torch.float32)
    ce.set_scales(r["jscales"])
    out = ce(r["frames"], r["src_hw"])
    assert set(out) == {"boxes", "scores", "classes", "valid", "count"}
    dets = present_detections(out, r["src_hw"], cfg)
    for d, (h, w) in zip(dets, r["src_hw"]):
        assert len(d["boxes"]) > 0 and (d["boxes"][:, 2] <= w).all() and (d["boxes"][:, 3] <= h).all()


# ---------------------------------------------------------------------------
# engine dirs, device default, imports
# ---------------------------------------------------------------------------

def test_chained_engine_dirs_cross_both_ways(tmp_path):
    jcfg = dataclasses.replace(jy.Yolo11Cfg(), input_h=64, input_w=64)
    params = jy.build_params(JaxRWM(seed=0), jcfg)
    je = JaxChained(JaxEngine("yolo11", jax.tree.map(jnp.asarray, params), jcfg, "fp32"),
                    fold=2, bgr_to_rgb=True)
    frames = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    je.calibrate([frames])
    je.save(str(tmp_path / "j"))
    te = ChainedInt8Engine.load(str(tmp_path / "j"), device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(te.act_scales, je.act_scales)
    assert (te.fold, te.enter, te.bgr_to_rgb) == (2, "m3", True)
    assert te.n_scales == je.n_scales
    out = te(frames)
    assert out["count"].shape == (2,)

    te.save(str(tmp_path / "t"))
    meta = json.loads((tmp_path / "t" / "int8chain.json").read_text())["meta"]
    assert meta == {"model": "yolo11", "tier": "chained", "fold": 2, "enter": "m3",
                    "bgr_to_rgb": True}
    je2 = JaxChained.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(je2.act_scales, te.act_scales)
    assert (je2.fold, je2.enter, je2.bgr_to_rgb) == (2, "m3", True)


def test_engines_default_to_the_card(monkeypatch, tmp_path):
    for fn in (teng.Engine.__init__, teng.Engine.load, teng.build_engine, teng.load_engine,
               ChainedInt8Engine.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    seen = {}

    class Fake:
        def save(self, path):
            seen["saved"] = path

    def fake_build(name, wts, precision="fp32", device="cuda", **kw):
        seen["device"] = device
        return Fake()

    monkeypatch.setattr(teng, "build_engine", fake_build)
    assert cli.main(["build", "yolo11", "-w", "x.wts", "-o", str(tmp_path / "e")]) == 0
    assert seen["device"] == "cuda"
    assert cli.main(["build", "yolo11", "-w", "x.wts", "-o", str(tmp_path / "e"),
                     "--device", "cpu"]) == 0
    assert seen["device"] == "cpu"


def test_chainctx_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        tqc.ChainCtx("tap", enter="stem")
    with pytest.raises(ValueError):
        tqc.ChainCtx("calibrate")
    assert ty.apply_chain.factor == jy.apply_chain.factor
    assert ty.apply_chain.supports(ty.Yolo11Cfg()) and not ty.apply_chain.supports(
        ty.Yolo11Cfg(task="seg"))


def test_chain_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['tensorrtx_tpu'] = None\n"
            "from tensorrtx_tpu_torch.core import quant\n"
            "from tensorrtx_tpu_torch.ops import qchain\n"
            "from tensorrtx_tpu_torch.ops.cuda import qconv\n"
            "from tensorrtx_tpu_torch.models import _yolo_qchain, yolo11\n"
            "from tensorrtx_tpu_torch.core.registry import get_model\n"
            "print(get_model('yolo11').apply_chain is yolo11.apply_chain)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"

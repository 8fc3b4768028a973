"""The float-resident tier's quantize fused into the int8 convs, on the CPU.

The kernels (the 1×1 of `csrc/qconv.cu`, and `csrc/quantize.cu`, which
makes the 3×3's int8 map) quantize by the division form without a division
per element (`csrc/quant_math.cuh`);
`ops/cuda/quantize.quantize_int8_div_free` is the same arithmetic in torch
float32 ops, and is held here to the division form
``clip(round(x / s), ±127)`` for every finite bf16 value at hundreds of
scales and on float32 values built on half-integers. The qconv wrappers'
float-source route on the CPU (their plain version) is held to quantizing
first, from contiguous maps and from channel slices read with their pixel
stride, and `quant_conv2d` on a channel slice to the JAX package's
`nn.conv2d` quant branch. `tests/test_torch_gpu.py` holds the CUDA kernels
to the same on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrtx_tpu.ops import nn as jnn
from tensorrtx_tpu.ops import quant_ctx as jqctx
from tensorrtx_tpu_torch.ops import quant_ctx as tqctx
from tensorrtx_tpu_torch.ops.cuda import qconv as qk
from tensorrtx_tpu_torch.ops.cuda import quantize as qz


def finite_bf16() -> torch.Tensor:
    """Every finite bfloat16 value once (65,280)."""
    b = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return b[torch.isfinite(b.float())]


def _scale_groups():
    """≥ 200 scales in eight groups: random (log-uniform), powers of two,
    and |x|max / 127 of random activations (the calibrated kind)."""
    rng = np.random.default_rng(0)
    rand = list(10.0 ** rng.uniform(-6, 1, 96)) + [-0.0413, 1e-33, 2e-40, 3.3e38]
    pow2 = [2.0 ** e for e in range(-24, 8)]
    absmax = [float(np.abs(rng.normal(0, rng.uniform(0.01, 30), 4096)).max() / 127.0)
              for _ in range(96)]
    scales = rand + pow2 + absmax
    return [scales[i::8] for i in range(8)]


@pytest.mark.parametrize("scales", _scale_groups(), ids=lambda s: f"{len(s)}scales")
def test_div_free_quantize_equals_division_on_every_bf16(scales):
    x = finite_bf16()
    for s in scales:
        st = torch.tensor(s, dtype=torch.float32)
        got = qz.quantize_int8_div_free(x, st)
        want = qz.quantize_int8_plain(x, st, divide=True)
        assert torch.equal(got, want), (s, int((got != want).sum()))


def _ulp_steps(t, k):
    """t moved |k| ulp towards the sign of k (|k| ≤ 4)."""
    for i in range(4):
        t = torch.where(k.abs() > i, torch.nextafter(t, torch.sign(k) * float("inf")), t)
    return t


def near_half_integers(rng, s, n):
    """float32 values x whose x / s lies within 1–4 ulp of a half-integer
    (both signs, in and just past ±127.5), and values x within 0–3 ulp of
    fl(h·s) for half-integers h, whose quotients round onto h or next to it
    (the exact path's ties)."""
    h = torch.from_numpy(rng.integers(-131, 131, n).astype(np.float32)) + 0.5
    k = torch.from_numpy(rng.integers(1, 5, n) * rng.choice([-1, 1], n)).float()
    on = torch.from_numpy(rng.integers(-3, 4, n)).float()
    return torch.cat([_ulp_steps(h, k) * s, _ulp_steps(h * s, on)])


@pytest.mark.parametrize("s", [0.0371, 1.7e-3, 0.25, 3.1e-5, 0.9, -0.0413, 1e-33, 2e-40])
def test_div_free_quantize_equals_division_on_float32(s):
    """2·10⁶ random values a scale (1.6·10⁷ over the eight) and 2·10⁶ built
    on half-integers, at ordinary, negative, tiny (|s| < 2⁻¹⁰⁰: the exact
    path's scaling) and subnormal scales. Off powers of two the exact path
    is what makes these equal (an unguarded x·(1/s) differs on thousands of
    them); at a power of two x·(1/s) is x / s, and the form takes no guard."""
    rng = np.random.default_rng(int(abs(s) * 1e6))
    st = torch.tensor(s, dtype=torch.float32)
    near = near_half_integers(rng, st, 10 ** 6)
    rand = torch.from_numpy(rng.normal(0, 60 * abs(s), 2 * 10 ** 6).astype(np.float32))
    for x in (near, rand):
        got = qz.quantize_int8_div_free(x, st)
        want = qz.quantize_int8_plain(x, st, divide=True)
        assert torch.equal(got, want), int((got != want).sum())
    unguarded = torch.clamp(torch.round(near * (torch.ones_like(st) / st)), -127, 127)
    differ = int((unguarded.to(torch.int8) != qz.quantize_int8_plain(near, st, True)).sum())
    assert (differ == 0) == (np.log2(abs(s)) == np.round(np.log2(abs(s))))


# (k, stride, B, H, W, C, Co, source dtype, pixel stride / C)
CPU_CASES = [
    (3, 1, 2, 9, 7, 16, 8, torch.bfloat16, 1),
    (3, 2, 1, 11, 9, 16, 24, torch.bfloat16, 2),
    (3, 1, 1, 8, 6, 3, 16, torch.float32, 1),
    (3, 2, 2, 7, 10, 32, 16, torch.float32, 2),
    (1, 1, 2, 5, 7, 32, 16, torch.bfloat16, 2),
    (1, 1, 1, 6, 6, 24, 40, torch.float32, 1),
]


def slice_input(rng, b, h, w, c, ps, dtype):
    """The last C channels of a ``channels_last`` NCHW map ps·C wide, viewed
    as NHWC: pixel stride ps·C, no copy."""
    wide = torch.from_numpy(rng.normal(0, 3, (b, ps * c, h, w)).astype(np.float32)).to(dtype)
    wide = wide.contiguous(memory_format=torch.channels_last)
    x = wide[:, (ps - 1) * c:].permute(0, 2, 3, 1)
    assert x.stride(2) == ps * c and x.stride(3) == 1
    return x


@pytest.mark.parametrize("case", CPU_CASES, ids=str)
def test_fused_qconv_cpu_route_is_quantize_then_conv(case):
    k, stride, b, h, w, c, co, dtype, ps = case
    rng = np.random.default_rng(sum(case[2:7]))
    x = slice_input(rng, b, h, w, c, ps, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (co, k, k, c), dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32))
    sx = torch.tensor(0.031, dtype=torch.float32)
    kw = dict(act=None, out_float=True, out_dtype=torch.float32)
    if k == 3:
        kw["stride"] = stride
    fn = qk.qconv3x3 if k == 3 else qk.qconv1x1
    counts = lambda: (qk.launches_3x3, qk.launches_1x1_fq, qz.launches)  # noqa: E731
    before = counts()
    got = fn(x, wq, scale, bias, None, sx=sx, **kw)
    assert counts() == before   # the CPU route launches nothing
    xq = qz.quantize_int8_plain(x.contiguous(), sx, divide=True)
    assert torch.equal(got, qk.qconv_plain(xq, wq, scale, bias, None, **kw))
    assert torch.equal(got, fn(xq, wq, scale, bias, None, **kw))   # the int8-source route


def test_fused_qconv_refuses_what_it_cannot_take():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    wq = torch.zeros((8, 3, 3, 16), dtype=torch.int8)
    ones = torch.ones(8)
    fq = dict(sx=0.1, act=None, out_float=True)
    with pytest.raises(TypeError):          # fp16: no kernel takes it
        qk.qconv3x3(x.half(), wq, ones, None, None, **fq)
    with pytest.raises(TypeError):          # an int8 source takes no scale
        qk.qconv3x3(x.to(torch.int8), wq, ones, None, None, **fq)
    with pytest.raises(TypeError):          # a float source needs one
        qk.qconv3x3(x, wq, ones, None, 0.1)
    for fn, w in ((qk.qconv3x3, wq), (qk.qconv1x1, wq[:, 1:2, 1:2].contiguous())):
        with pytest.raises(ValueError):     # a float source takes no activation
            fn(x, w, ones, None, None, sx=0.1, act="silu", out_float=True)
    nchw = torch.zeros((1, 16, 4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError):         # channels not at stride 1: no copy is made
        qk.qconv3x3(nchw.permute(0, 2, 3, 1), wq, ones, None, None, **fq)
    w1 = torch.zeros((8, 1, 1, 16), dtype=torch.int8)
    every_other_row = torch.zeros((1, 8, 4, 16))[:, ::2]
    with pytest.raises(ValueError):         # rows not W pixels apart
        qk.qconv1x1(every_other_row, w1, ones, None, None, **fq)
    every_other_pixel = torch.zeros((1, 4, 8, 16))[:, :, ::2]     # pixel stride 32: taken
    y = qk.qconv1x1(every_other_pixel, w1, ones, None, None, **fq)
    assert y.shape == (1, 4, 4, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("divide", [True, False])
def test_quantize_int8_reads_a_channel_slice_where_it_lies(dtype, divide):
    """`quantize_int8` takes the NHWC view of a channel slice (rows of C
    channels one pixel stride apart, the 3×3's float input on the tier) and
    returns the contiguous int8 map of its values; a layout that is not
    such rows is refused, not copied."""
    rng = np.random.default_rng(3)
    x = slice_input(rng, 2, 5, 7, 16, 2, dtype)
    assert not x.is_contiguous()
    s = torch.tensor(0.0213, dtype=torch.float32)
    got = qz.quantize_int8(x, s, divide=divide)
    assert got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got, qz.quantize_int8_plain(x.contiguous(), s, divide=divide))
    with pytest.raises(ValueError):         # channels not at stride 1
        qz.quantize_int8(x.permute(0, 3, 1, 2), s, divide=divide)
    with pytest.raises(ValueError):         # rows not W pixels apart
        qz.quantize_int8(x[:, ::2], s, divide=divide)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_quant_conv2d_on_a_channel_slice_matches_jax(k, stride):
    """`quant_conv2d` on the second half of a C3k2-style split (a channel
    slice of a ``channels_last`` map) against JAX's `nn.conv2d` quant branch
    on the same values, weights and scales."""
    rng = np.random.default_rng(10 * k + stride)
    b, h, w, c, co = 2, 10, 9, 16, 24
    x = slice_input(rng, b, h, w, c, 2, torch.float32).permute(0, 3, 1, 2)   # NCHW view
    w_hwio = rng.normal(0, 0.1, (k, k, c, co)).astype(np.float32)
    wq_hwio = rng.integers(-127, 128, (k, k, c, co), dtype=np.int8)
    sw = rng.uniform(1e-3, 3e-3, co).astype(np.float32)
    bias = rng.normal(0, 0.1, co).astype(np.float32)
    sx = 0.0213
    st = jqctx.QuantState("quant", act_scales=[sx], w_scales=[jnp.asarray(sw)],
                          wq=[jnp.asarray(wq_hwio)])
    with jqctx.quant_context(st):
        want = np.asarray(jnn.conv2d(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                     jnp.asarray(w_hwio), jnp.asarray(bias), stride=stride,
                                     padding=k // 2))
    wq_ohwi = torch.from_numpy(np.ascontiguousarray(wq_hwio.transpose(3, 0, 1, 2)))
    got = tqctx.quant_conv2d(x, wq_ohwi, torch.from_numpy(np.float32(sx) * sw),
                             torch.tensor(sx, dtype=torch.float32), torch.from_numpy(bias), stride)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)

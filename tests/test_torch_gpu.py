"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and nvcc; every test here is marked ``gpu`` and skips
without them. It imports neither JAX nor the JAX package, so on a machine
without JAX run it without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from tensorrtx_tpu_torch.ops import nms as tn
from tensorrtx_tpu_torch.ops.cuda import nms_mask as kern

THRESH = 0.45


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def candidates(seed, b, n=300, nc=3):
    """Sorted NMS candidates with exact score ties, duplicated boxes and an
    invalid tail."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(0, 100, (2, b, n))
    w, h = rng.uniform(5, 40, (2, b, n))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes[:, 1::4] = boxes[:, 0::4][:, : boxes[:, 1::4].shape[1]]
    scores = rng.choice(np.linspace(0.3, 0.9, 7), (b, n))
    classes = rng.integers(0, nc, (b, n))
    o = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, o[..., None], 1)
    scores = np.take_along_axis(scores, o, 1)
    scores[:, n - n // 8:] = 0.0
    return [torch.from_numpy(a.astype(np.float32)) for a in
            (boxes, scores, np.take_along_axis(classes, o, 1))]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 32])
def test_nms_mask_kernel_bit_equal_to_plain(cuda, b):
    host = candidates(b, b)
    args = [t.to(cuda) for t in host]
    before = kern.launches
    keep = kern.keep_mask(*args, THRESH)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert keep.dtype == torch.bool and keep.shape == args[1].shape
    assert torch.equal(keep, kern.keep_mask_plain(*args, THRESH))
    assert torch.equal(keep.cpu(), kern.keep_mask(*host, THRESH))


def edge_candidates(seed, b, n, kind):
    """NMS candidates of one kind: "ties" (every score equal), "invalid"
    (every slot ≤ 0), "one_class", or "unsorted" (sorted candidates in a
    random order)."""
    boxes, scores, classes = candidates(seed, b, n)
    rng = np.random.default_rng(seed)
    if kind == "ties":
        scores = torch.full_like(scores, 0.5)
    elif kind == "invalid":
        scores = -torch.from_numpy(rng.choice(np.float32([0.0, 0.25]), (b, n)))
    elif kind == "one_class":
        classes = torch.zeros_like(classes)
    else:
        o = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(b)]))
        boxes = torch.take_along_dim(boxes, o[..., None], 1).contiguous()
        scores, classes = (torch.take_along_dim(t, o, 1).contiguous() for t in (scores, classes))
    return boxes, scores, classes


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ties", "invalid", "one_class", "unsorted"])
@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 300, 2048])
def test_nms_mask_kernel_bit_equal_at_edges(cuda, n, b, kind):
    # a warp per row, 32 candidates a step: N around the warp width, the
    # main path's 300 and MAX_N (the kernel's shared-memory opt-in)
    host = edge_candidates(1000 * n + b, b, n, kind)
    args = [t.to(cuda) for t in host]
    before = kern.launches
    keep = kern.keep_mask(*args, THRESH)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.equal(keep, kern.keep_mask_plain(*args, THRESH))
    if kind == "invalid":
        assert not keep.any()
    if b * n <= 32 * 300:
        assert torch.equal(keep.cpu(), kern.keep_mask(*host, THRESH))


@pytest.mark.gpu
def test_nms_mask_kernel_rejects_what_it_cannot_take(cuda):
    boxes, scores, classes = (t.to(cuda) for t in candidates(0, 1))
    with pytest.raises(ValueError):   # float4 loads need 16-byte alignment
        kern.keep_mask(boxes.reshape(-1)[1:1197].reshape(1, 299, 4), scores[:, :299],
                       classes[:, :299], THRESH)
    big = kern.MAX_N + 1
    with pytest.raises(ValueError):
        kern.keep_mask(torch.zeros(1, big, 4, device=cuda), torch.zeros(1, big, device=cuda),
                       torch.zeros(1, big, device=cuda), THRESH)


@pytest.mark.gpu
def test_select_and_nms_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    b, n = 4, 8400
    boxes = candidates(6, b, n)[0]
    scores = torch.from_numpy(rng.choice(np.float32([0.2, 0.3, 0.3, 0.5, 0.7]), (b, n)))
    classes = torch.from_numpy(rng.integers(0, 3, (b, n)).astype(np.float32))
    got = tn.select_and_nms(boxes.to(cuda), scores.to(cuda), classes.to(cuda),
                            0.25, THRESH, 300).as_dict()
    exp = tn.select_and_nms(boxes, scores, classes, 0.25, THRESH, 300).as_dict()
    for k in exp:
        assert torch.equal(got[k].cpu(), exp[k]), k


# --- int8 convs of the chained tier (csrc/qconv.cu) -------------------------

def qconv_inputs(seed, b, h, w, c, co, k, stride=1, residual=False):
    """int8 activations and weights, float32 scale/bias and scalar scales
    as the chain hands them to the kernels."""
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (co, k, k, c), dtype=np.int8))
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, co) / (127.0 * 127.0 * k * k * c ** 0.5)
                              * 8).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, co).astype(np.float32))
    kw = {"s_out": torch.tensor(0.02, dtype=torch.float32)}
    if residual:
        p = k // 2
        ho, wo = (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1
        kw["residual"] = torch.from_numpy(rng.integers(-127, 128, (b, ho, wo, co), dtype=np.int8))
        kw["res_scale"] = torch.tensor(0.01, dtype=torch.float32)
    return xq, wq, scale, bias, kw


QCONV_CASES = [
    # (k, stride, B, H, W, C, Co, act, residual, out_float)
    (3, 1, 1, 20, 20, 128, 128, "silu", False, False),
    (3, 2, 32, 80, 80, 64, 64, "silu", False, False),
    (3, 2, 1, 11, 9, 16, 32, "silu", False, False),
    (3, 1, 1, 173, 16, 128, 128, "silu", False, False),
    (3, 1, 2, 8, 16, 128, 128, "relu", True, False),
    (3, 1, 2, 40, 40, 80, 80, None, False, True),
    # the 3×3 tensor-core GEMM's staging paths and tails: C = 3 byte by byte
    # (the tier's stem, stride 2 on an odd map), C = 8 in 8-byte copies,
    # Co = 8 and 16 (one and two n8 fragments), K = 9·48 and N = 40 tails
    (3, 2, 2, 33, 25, 3, 16, None, False, True),
    (3, 2, 1, 33, 25, 3, 16, "silu", False, False),
    (3, 1, 2, 20, 20, 8, 16, "silu", False, False),
    (3, 1, 32, 40, 40, 16, 8, "silu", False, False),
    (3, 1, 1, 9, 11, 48, 40, "relu", True, False),
    (1, 1, 32, 40, 40, 256, 128, "silu", False, False),
    (1, 1, 1, 13, 7, 6, 10, "relu", True, False),
    (1, 1, 2, 20, 20, 80, 80, None, False, True),
    # the 1×1 tensor-core GEMM's tails: K (C = 48, 80), N (Co = 32, 80),
    # M (2·5·7 = 70; 9·11 = 99) and the byte-wise path (C = 6)
    (1, 1, 2, 5, 7, 48, 32, "silu", False, False),
    (1, 1, 2, 5, 7, 80, 80, "silu", True, False),
    (1, 1, 1, 9, 11, 512, 256, "silu", True, False),
    (1, 1, 2, 5, 7, 48, 32, None, False, True),
    (1, 1, 1, 13, 7, 6, 10, "silu", False, True),
]

# 1×1 shapes for the GEMM-exact check: (B, H, W, C, Co, byte offset of xq)
GEMM_CASES = [
    (1, 20, 20, 512, 256, 0),
    (32, 20, 20, 80, 80, 0),
    (2, 5, 7, 48, 32, 0),
    (1, 9, 11, 384, 256, 0),
    (1, 13, 7, 6, 10, 0),
    (1, 8, 8, 64, 64, 4),       # 4-byte aligned only: the byte-wise path
    (2, 80, 80, 64, 80, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", QCONV_CASES, ids=str)
def test_qconv_kernels_match_plain(cuda, case):
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    k, stride, b, h, w, c, co, act, residual, out_float = case
    xq, wq, scale, bias, kw = qconv_inputs(sum(case[2:7]), b, h, w, c, co, k, stride,
                                           residual)
    fn = qk.qconv3x3 if k == 3 else qk.qconv1x1
    extra = {"stride": stride} if k == 3 else {}
    common = dict(act=act, out_float=out_float, out_dtype=torch.float32, **extra)
    dev = {n: (v.to(cuda) if torch.is_tensor(v) else v) for n, v in kw.items()}
    counter = "launches_3x3" if k == 3 else "launches_1x1"
    before = getattr(qk, counter)
    got = fn(xq.to(cuda), wq.to(cuda), scale.to(cuda), bias.to(cuda), **dev, **common)
    torch.cuda.synchronize()
    assert getattr(qk, counter) == before + 1
    plain = qk.qconv_plain(xq.to(cuda), wq.to(cuda), scale.to(cuda), bias.to(cuda),
                           **dev, **common).cpu()
    host = fn(xq, wq, scale, bias, **kw, **common)
    assert getattr(qk, counter) == before + 1      # the CPU route is the plain version
    got = got.cpu()
    assert got.shape == plain.shape == host.shape
    if out_float:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), host.numpy(), rtol=1e-6, atol=1e-6)
        return
    for ref in (plain, host):
        d = (got.int() - ref.int()).abs()
        assert int(d.max()) <= 1
        assert float((d > 0).float().mean()) < 1e-3
        assert float((ref.int().abs() == 127).float().mean()) < 0.5   # not all saturated


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMM_CASES, ids=str)
def test_qconv1x1_kernel_gemm_is_exact(cuda, case):
    """With a float32 exit, scale 1, no bias and no activation the output
    is the int32 sum itself (|acc| ≤ 127²·512 < 2²⁴): bit-equal to the
    plain version's exact sum."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    b, h, w, c, co, offset = case
    xq, wq, _, _, _ = qconv_inputs(sum(case), b, h, w, c, co, 1)
    buf = torch.empty(xq.numel() + offset, dtype=torch.int8, device=cuda)
    xd = buf[offset:].view(xq.shape)
    xd.copy_(xq)
    assert (xd.data_ptr() % 16 == 0) == (offset == 0)
    ones = torch.ones(co, dtype=torch.float32)
    common = dict(act=None, out_float=True, out_dtype=torch.float32)
    before = qk.launches_1x1
    got = qk.qconv1x1(xd, wq.to(cuda), ones.to(cuda), None, None, **common)
    torch.cuda.synchronize()
    assert qk.launches_1x1 == before + 1
    exact = (xq.reshape(-1, c).long() @ wq.reshape(co, c).long().t()).reshape(b, h, w, co)
    assert torch.equal(got.cpu(), exact.float())
    assert torch.equal(got, qk.qconv_plain(xd, wq.to(cuda), ones.to(cuda), None, None, **common))


# 3×3 shapes for the GEMM-exact check: (stride, B, H, W, C, Co, byte offset
# of xq). Offset 8 leaves the 16-byte copies for 8-byte ones; 4 and 1 send
# the operands byte by byte.
GEMM3_CASES = [
    (2, 1, 17, 13, 3, 16, 0),
    (2, 32, 33, 25, 3, 16, 0),
    (1, 1, 12, 10, 8, 16, 0),
    (1, 2, 7, 9, 16, 8, 0),
    (2, 1, 10, 8, 16, 32, 0),
    (1, 1, 5, 7, 48, 40, 0),
    (2, 2, 11, 9, 48, 16, 0),
    (1, 2, 80, 80, 64, 64, 0),
    (2, 2, 80, 80, 64, 64, 0),
    (1, 1, 173, 16, 128, 128, 0),
    (1, 1, 20, 20, 256, 256, 0),
    (1, 1, 8, 8, 64, 64, 8),
    (1, 1, 8, 8, 64, 64, 4),
    (2, 1, 9, 7, 32, 16, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMM3_CASES, ids=str)
def test_qconv3x3_kernel_gemm_is_exact(cuda, case):
    """With a float32 exit, scale 1, no bias and no activation the output
    is the int32 sum itself (random int8 sums stay far below 2²⁴): bit-equal
    to the exact sums of the (tap, c)-ordered implicit GEMM."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    stride, b, h, w, c, co, offset = case
    xq, wq, _, _, _ = qconv_inputs(sum(case), b, h, w, c, co, 3)
    buf = torch.empty(xq.numel() + offset, dtype=torch.int8, device=cuda)
    xd = buf[offset:].view(xq.shape)
    xd.copy_(xq)
    ones = torch.ones(co, dtype=torch.float32)
    common = dict(act=None, out_float=True, out_dtype=torch.float32, stride=stride)
    before = qk.launches_3x3
    got = qk.qconv3x3(xd, wq.to(cuda), ones.to(cuda), None, None, **common)
    torch.cuda.synchronize()
    assert qk.launches_3x3 == before + 1
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = torch.nn.functional.pad(xq.long(), (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + stride * (ho - 1) + 1:stride,
                           kx:kx + stride * (wo - 1) + 1:stride]
                        for ky in range(3) for kx in range(3)], 3).reshape(-1, 9 * c)
    exact = (cols @ wq.reshape(co, 9 * c).long().t()).reshape(b, ho, wo, co)
    assert int(exact.abs().max()) < 2 ** 24
    assert torch.equal(got.cpu(), exact.float())
    assert torch.equal(got, qk.qconv_plain(xd, wq.to(cuda), ones.to(cuda), None, None, **common))


@pytest.mark.gpu
def test_qconv_kernels_reject_what_they_cannot_take(cuda):
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    xq, wq, scale, bias, kw = qconv_inputs(0, 1, 8, 8, 16, 16, 3)
    xq, wq, scale, bias = (t.to(cuda) for t in (xq, wq, scale, bias))
    with pytest.raises(ValueError):        # NCHW view of the payload
        qk.qconv3x3(xq.permute(0, 3, 1, 2), wq, scale, bias, 0.02)
    with pytest.raises(TypeError):
        qk.qconv3x3(xq.float(), wq, scale, bias, 0.02)
    with pytest.raises(ValueError):
        qk.qconv3x3(xq, wq, scale, bias, 0.02, stride=3)


# --- the int8 convs from a float source, quantized in the kernel ------------

def finite_bf16():
    """Every finite bfloat16 value once (65,280)."""
    b = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return b[torch.isfinite(b.float())]


def nonzero_int8(rng, shape):
    """Random int8 weights with no zero: every flipped input moves a sum."""
    w = rng.integers(1, 128, shape) * rng.choice([-1, 1], shape)
    return torch.from_numpy(w.astype(np.int8))


# (k, stride, B, H, W, C, Co, source dtype, pixel stride / C, element offset of x):
# the vector paths (C % 16, C % 8 with float32 4-element pieces), the element
# paths (the C = 3 stem; C = 6; an unaligned x), channel slices read where
# they lie (pixel stride 2C, 3C)
FUSED_CASES = [
    (3, 2, 2, 33, 25, 3, 16, torch.bfloat16, 1, 0),
    (3, 2, 1, 41, 39, 3, 16, torch.float32, 1, 0),
    (3, 1, 2, 20, 20, 16, 16, torch.bfloat16, 1, 0),
    (3, 2, 2, 21, 17, 16, 32, torch.bfloat16, 2, 0),
    (3, 1, 1, 12, 10, 24, 40, torch.float32, 1, 0),
    (3, 1, 2, 9, 11, 32, 64, torch.bfloat16, 2, 0),
    (3, 1, 2, 40, 40, 64, 64, torch.float32, 2, 0),
    (3, 1, 1, 20, 20, 128, 128, torch.bfloat16, 3, 0),
    (3, 1, 1, 8, 8, 16, 16, torch.bfloat16, 1, 2),
    (1, 1, 2, 20, 20, 64, 64, torch.bfloat16, 1, 0),
    (1, 1, 2, 20, 20, 32, 32, torch.bfloat16, 2, 0),
    (1, 1, 32, 20, 20, 64, 128, torch.float32, 2, 0),
    (1, 1, 1, 9, 11, 6, 10, torch.bfloat16, 1, 0),
    (1, 1, 2, 5, 7, 24, 40, torch.float32, 1, 0),
    (1, 1, 1, 20, 20, 256, 64, torch.bfloat16, 1, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FUSED_CASES, ids=str)
def test_fused_quantize_gemm_is_exact(cuda, case):
    """From a float source with a float32 exit, scale 1, no bias and no
    activation the output is the int32 sum of the staged int8 values:
    bit-equal to the exact sums of conv(quantize_int8_plain(x, sx, divide),
    w), with weights that have no zero."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    k, stride, b, h, w, c, co, dtype, ps, offset = case
    rng = np.random.default_rng(sum(case[2:7]))
    sx = torch.tensor(0.0371, dtype=torch.float32)
    x = (torch.from_numpy(rng.normal(0, 50, (b, h, w, c)).astype(np.float32)) * sx).to(dtype)
    wide = torch.zeros((b, h, w, ps * c + offset), dtype=dtype, device=cuda)
    xd = wide[..., offset + (ps - 1) * c:offset + ps * c]
    xd.copy_(x)
    assert xd.stride(2) == ps * c + offset and (ps * c + offset == c) == xd.is_contiguous()
    wq = nonzero_int8(rng, (co, k, k, c))
    ones = torch.ones(co, dtype=torch.float32)
    fn = qk.qconv3x3 if k == 3 else qk.qconv1x1
    common = dict(act=None, out_float=True, out_dtype=torch.float32,
                  **({"stride": stride} if k == 3 else {}))
    # the 3×3: quantize_int8 of x where it lies, then the int8-source kernel;
    # the 1×1: one launch that quantizes while it stages
    counts = lambda: (qz.launches, qk.launches_3x3, qk.launches_1x1, qk.launches_1x1_fq)  # noqa: E731
    before = counts()
    got = fn(xd, wq.to(cuda), ones.to(cuda), None, None, sx=sx.to(cuda), **common)
    torch.cuda.synchronize()
    added = (1, 1, 0, 0) if k == 3 else (0, 0, 0, 1)
    assert counts() == tuple(b + a for b, a in zip(before, added))
    xq = qz.quantize_int8_plain(x, sx, divide=True)
    exact = qk.qconv_plain(xq, wq, ones, None, None, **common)
    assert int(exact.abs().max()) < 2 ** 24
    assert torch.equal(got.cpu(), exact)
    assert torch.equal(fn(x, wq, ones, None, None, sx=sx, **common), exact)  # the CPU route


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.0371, 1.7e-3, 2.0 ** -5, 0.11, 2.0 ** 3, 1e-33])
def test_fused_quantize_equals_division_for_every_bf16(cuda, scale):
    """An identity 1×1 (C = Co = 16, scale 1, float32 exit) returns the
    staged int8 values themselves; with every finite bf16 value as input
    they equal quantize_int8_plain(x, s, divide=True), and so do those of a
    center-tap identity 3×3 and of the C = 3 stem's element path, each from
    a contiguous map and (C = 16) from a channel slice of a map 2C wide. At
    1e-33 (under 2^-100) every value takes the exact path, scaled."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    x = torch.zeros(64 * 342 * 3, dtype=torch.bfloat16)
    x[:65280] = finite_bf16()
    s = torch.tensor(scale, dtype=torch.float32)
    want = qz.quantize_int8_plain(x, s, divide=True).float()
    common = dict(act=None, out_float=True, out_dtype=torch.float32, sx=s.to(cuda))
    for k, shape, ps in ((1, (1, 64, 64, 16), 1), (1, (1, 64, 64, 16), 2),
                         (3, (1, 64, 64, 16), 1), (3, (1, 64, 64, 16), 2),
                         (3, (1, 64, 342, 3), 1)):
        c = shape[3]
        wq = torch.zeros((c, k, k, c), dtype=torch.int8)
        wq[torch.arange(c), k // 2, k // 2, torch.arange(c)] = 1
        fn = qk.qconv3x3 if k == 3 else qk.qconv1x1
        wide = torch.zeros((*shape[:3], ps * c), dtype=torch.bfloat16, device=cuda)
        xd = wide[..., (ps - 1) * c:]
        xd.copy_(x[:int(np.prod(shape))].reshape(shape))
        got = fn(xd, wq.to(cuda), torch.ones(c, device=cuda), None, None, **common)
        assert torch.equal(got.cpu().reshape(-1), want[:xd.numel()]), (k, shape, ps)


@pytest.mark.gpu
def test_fused_qconv_refuses_what_it_cannot_take(cuda):
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk

    x = torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16, device=cuda)
    wq = torch.zeros((16, 3, 3, 16), dtype=torch.int8, device=cuda)
    ones = torch.ones(16, device=cuda)
    with pytest.raises(TypeError):          # fp16: no kernel takes it
        qk.qconv3x3(x[..., :16].half(), wq, ones, None, None, sx=0.1)
    with pytest.raises(TypeError):          # int8 source with a scale
        qk.qconv3x3(x[..., :16].to(torch.int8), wq, ones, None, None, sx=0.1)
    with pytest.raises(TypeError):          # float source without one
        qk.qconv3x3(x[..., :16], wq, ones, None, 0.1)
    with pytest.raises(ValueError):         # a float source takes no activation
        qk.qconv3x3(x[..., :16], wq, ones, None, None, sx=0.1, act="silu")
    nchw = torch.zeros((1, 16, 8, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):         # channels not at stride 1: no copy is made
        qk.qconv3x3(nchw.permute(0, 2, 3, 1), wq, ones, None, None, sx=0.1, act=None)


# --- quantize kernels (csrc/quantize.cu) -------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 4099, 2 * 80 * 80 * 64])
def test_quantize_int8_kernel_bit_equal_to_plain(cuda, dtype, n):
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    gen = torch.Generator().manual_seed(n)
    x = (torch.randn(n, generator=gen) * 40).to(dtype)
    for s in (torch.tensor(0.25), torch.tensor(0.0371)):     # exact ties, then not
        for divide in (False, True):
            before = qz.launches
            got = qz.quantize_int8(x.to(cuda), s.to(cuda), divide=divide)
            torch.cuda.synchronize()
            assert qz.launches == before + 1 and got.dtype == torch.int8
            assert torch.equal(got.cpu(), qz.quantize_int8_plain(x, s, divide=divide))
            assert torch.equal(got, qz.quantize_int8_plain(x.to(cuda), s.to(cuda), divide))
    # an unaligned view takes the element-wise path
    xv = x.to(cuda)[1:]
    assert torch.equal(qz.quantize_int8(xv, 0.05).cpu(), qz.quantize_int8_plain(x[1:], 0.05))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_stochastic_kernel_bit_equal_to_plain(cuda, dtype):
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    x = (torch.randn(3, 50, 17, generator=torch.Generator().manual_seed(1)) * 3).to(dtype)
    s = torch.tensor(0.05)
    before = qz.launches_stochastic
    got = qz.quantize_int8_stochastic(x.to(cuda), s.to(cuda), 2 ** 33 + 5)
    torch.cuda.synchronize()
    assert qz.launches_stochastic == before + 1
    assert torch.equal(got.cpu(), qz.quantize_int8_stochastic_plain(x, s, 2 ** 33 + 5))
    assert torch.equal(got, qz.quantize_int8_stochastic(x.to(cuda), s.to(cuda), 2 ** 33 + 5))
    assert not torch.equal(got, qz.quantize_int8_stochastic(x.to(cuda), s.to(cuda), 6))


# --- planar convs (csrc/conv_planar.cu) --------------------------------------

PLANAR_CASES = [
    # (k, B, H, C, W, Co, act, residual)
    (3, 1, 40, 3, 200, 16, "silu", False),
    (3, 2, 16, 20, 130, 8, "relu", True),
    (3, 1, 9, 40, 33, 40, None, False),
    (1, 2, 16, 48, 160, 64, "silu", True),
    (1, 1, 5, 17, 300, 3, None, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PLANAR_CASES, ids=str)
def test_planar_conv_kernels_match_plain(cuda, case, dtype):
    from tensorrtx_tpu_torch.ops.cuda import conv_planar as cp

    k, b, h, c, w, co, act, res = case
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(sum(case[1:6]))
    x = torch.randn((b, h, c, w), generator=gen).to(dtype)
    wt = torch.randn((k, k, c, co), generator=gen) / (k * k * c) ** 0.5
    bias = torch.randn((co,), generator=gen) * 0.1
    r = torch.randn((b, h, co, w), generator=gen).to(dtype) if res else None
    fn = cp.conv3x3_planar if k == 3 else cp.conv1x1_planar
    counter = "launches_3x3" if k == 3 else "launches_1x1"
    before = getattr(cp, counter)
    dev = [None if v is None else v.to(cuda) for v in (x, wt, bias, r)]
    got = fn(dev[0], dev[1], dev[2], residual=dev[3], act=act)
    torch.cuda.synchronize()
    assert getattr(cp, counter) == before + 1
    ref = cp.conv_planar_plain(*dev, act, k)
    host = fn(x, wt, bias, residual=r, act=act)
    assert getattr(cp, counter) == before + 1      # the CPU route is the plain version
    tol = (1e-4 if dtype == torch.float32 else 2 ** -7) * (1 + float(ref.float().abs().max()))
    for want in (ref.cpu(), host):
        assert got.shape == want.shape and got.dtype == dtype
        assert float((got.cpu().float() - want.float()).abs().max()) <= tol


# (B, H, C, W, Co) of the 1×1 at its edges
PLANAR_1X1_EDGES = [
    (1, 7, 17, 33, 72),       # ragged rows (W·itemsize % 16 ≠ 0), two Co tiles
    (2, 5, 1, 130, 96),       # one input channel, ragged rows, two Co tiles
    (1, 4801, 17, 300, 3),    # B·H prime and over one wave: runs of R rows, a short last one
    (1, 3, 48, 640, 64),      # 3 (float32) or 4 (bf16) column tiles; 2 channel stages a row in float32
    (2, 3, 200, 96, 24),      # 3 (float32) or 2 (bf16) channel stages a row
]


# (B, H, C, W, Co) of the 3×3 at its edges
PLANAR_3X3_EDGES = [
    (1, 1, 3, 64, 16),        # one row: both halo rows outside the map
    (2, 2, 5, 40, 3),         # two rows an image; a ragged channel group (Co = 3)
    (1, 4801, 3, 40, 8),      # H prime and over one wave: runs of R rows, a short last one
    (2, 301, 4, 64, 16),      # two images, runs that would cross the boundary between them
    (1, 7, 3, 33, 16),        # W = 33: rows not 16-byte multiples
    (2, 6, 1, 130, 24),       # C = 1, W = 130: rows not 16-byte multiples
    (1, 3, 3, 640, 24),       # two column tiles: halo columns from the neighbouring tile
    (1, 3, 2, 1002, 24),      # 3 (CUDA cores) or 2 (tensor cores) column tiles of unaligned rows
    (1, 4, 17, 48, 72),       # 2 (CUDA cores) or 5 (tensor cores) Co tiles, a ragged one
    (2, 3, 200, 96, 24),      # several channel stages a row
    (1, 5, 33, 64, 16),       # C = 33: bf16 just past the tensor-core form (9 C > 288)
]


def planar_edge_inputs(k, case, act, res, dtype):
    b, h, c, w, co = case
    gen = torch.Generator().manual_seed(sum(case) + 7 * len(str(act)) + res)
    x = torch.randn((b, h, c, w), generator=gen).to(dtype)
    wt = (torch.randn((c, co), generator=gen) / c ** 0.5 if k == 1
          else torch.randn((3, 3, c, co), generator=gen) / (9 * c) ** 0.5)
    bias = torch.randn((co,), generator=gen) * 0.1
    r = torch.randn((b, h, co, w), generator=gen).to(dtype) if res else None
    return x, wt, bias, r


def check_planar(cuda, k, x, wt, bias, r, act, dtype):
    from tensorrtx_tpu_torch.ops.cuda import conv_planar as cp

    torch.backends.cudnn.allow_tf32 = False
    counter = "launches_3x3" if k == 3 else "launches_1x1"
    before = getattr(cp, counter)
    got = (cp.conv3x3_planar if k == 3 else cp.conv1x1_planar)(x, wt, bias, residual=r, act=act)
    torch.cuda.synchronize()
    assert getattr(cp, counter) == before + 1
    ref = cp.conv_planar_plain(x, wt, bias, r, act, k)
    tol = (1e-4 if dtype == torch.float32 else 2 ** -7) * (1 + float(ref.float().abs().max()))
    assert got.shape == ref.shape and got.dtype == dtype
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["silu", "relu", None])
@pytest.mark.parametrize("case", PLANAR_1X1_EDGES, ids=str)
def test_conv1x1_planar_kernel_matches_plain_at_edges(cuda, case, act, res, dtype):
    x, wt, bias, r = planar_edge_inputs(1, case, act, res, dtype)
    check_planar(cuda, 1, x.to(cuda), wt.to(cuda), bias.to(cuda),
                 None if r is None else r.to(cuda), act, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", ["silu", "relu", None])
@pytest.mark.parametrize("case", PLANAR_3X3_EDGES, ids=str)
def test_conv3x3_planar_kernel_matches_plain_at_edges(cuda, case, act, res, dtype):
    x, wt, bias, r = planar_edge_inputs(3, case, act, res, dtype)
    check_planar(cuda, 3, x.to(cuda), wt.to(cuda), bias.to(cuda),
                 None if r is None else r.to(cuda), act, dtype)


def shifted(t, device):
    """A contiguous copy of t on device, 4 bytes past an allocation."""
    k = 4 // t.element_size()
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=device)
    v = buf[k:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1x1_planar_kernel_takes_unaligned_rows(cuda, dtype):
    # contiguous views 4 bytes past an allocation: rows of 16-byte multiples
    # that cannot be read by 16-byte pieces, and an output pointer that
    # takes vector stores beside a residual that does not
    x, wt, bias, r = planar_edge_inputs(1, (2, 9, 48, 160, 64), "silu", True, dtype)
    check_planar(cuda, 1, shifted(x, cuda), wt.to(cuda), bias.to(cuda), shifted(r, cuda), "silu",
                 dtype)
    check_planar(cuda, 1, shifted(x, cuda), wt.to(cuda), None, None, None, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_planar_kernel_takes_unaligned_rows(cuda, dtype):
    # as the 1×1's: x and the residual 4 bytes past an allocation, staged
    # element by element; two column tiles (W = 640, Co = 24) whose halo
    # columns come from the neighbouring tile
    for case in ((2, 9, 16, 160, 16), (1, 3, 3, 640, 24)):
        x, wt, bias, r = planar_edge_inputs(3, case, "silu", True, dtype)
        check_planar(cuda, 3, shifted(x, cuda), wt.to(cuda), bias.to(cuda), shifted(r, cuda),
                     "silu", dtype)
        check_planar(cuda, 3, shifted(x, cuda), wt.to(cuda), None, None, None, dtype)


@pytest.mark.gpu
def test_planar_conv_kernels_reject_what_they_cannot_take(cuda):
    from tensorrtx_tpu_torch.ops.cuda import conv_planar as cp

    x = torch.zeros((1, 8, 4, 16), device=cuda)
    w = torch.zeros((3, 3, 4, 8), device=cuda)
    with pytest.raises(ValueError):         # NHWC view, not planar memory
        cp.conv3x3_planar(x.permute(0, 1, 3, 2), torch.zeros((3, 3, 16, 8), device=cuda))
    with pytest.raises(TypeError):
        cp.conv3x3_planar(x.half(), w)
    with pytest.raises(ValueError):
        cp.conv1x1_planar(x, w)


# --- the float-resident int8 tier --------------------------------------------

@pytest.mark.gpu
def test_int8_tier_forward_launches_its_kernels(cuda):
    from tensorrtx_tpu_torch.core.convert import params_from_jax
    from tensorrtx_tpu_torch.core.engine import Engine
    from tensorrtx_tpu_torch.core.quant import QuantizedEngine, calibrate
    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
    from tensorrtx_tpu_torch.models.yolo11 import Yolo11Cfg, build_params
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    torch.backends.cudnn.allow_tf32 = False
    cfg = Yolo11Cfg(input_h=96, input_w=96, postprocess="raw")
    params = params_from_jax(build_params(RandomWeightMap(seed=0), cfg))
    x = torch.rand((2, 96, 96, 3), generator=torch.Generator().manual_seed(0))
    scales = calibrate(Engine("yolo11", params, cfg, device="cpu"), [x], "percentile")
    got_scales = calibrate(Engine("yolo11", params, cfg, device=cuda), [x], "percentile")
    np.testing.assert_allclose(got_scales, scales, rtol=1e-5)
    qe = QuantizedEngine(Engine("yolo11", params, cfg, device=cuda), scales)
    counters = ("launches", "launches_3x3", "launches_1x1", "launches_1x1_fq")
    mods = (qz, qk, qk, qk)
    before = [getattr(m, n) for m, n in zip(mods, counters)]
    out = qe(x)
    torch.cuda.synchronize()
    # each 3×3: a quantize of its float input where it lies, then the int8
    # 3×3; each 1×1 quantizes its own float input in its kernel
    assert [getattr(m, n) - b for m, n, b in zip(mods, counters, before)] == [35, 35, 0, 45]
    ref = QuantizedEngine(Engine("yolo11", params, cfg, device="cpu"), scales)(x)
    assert float((out["conf"].cpu() - ref["conf"]).abs().max()) <= 1e-4
    assert float((out["boxes"].cpu() - ref["boxes"]).abs().max()) <= 0.05


# --- the serving runner as captured CUDA graphs (core/runner.py) -------------

BUCKET = (120, 100)


def frame_set(seed, b):
    """b random uint8 frames in the bucket, each with its own true size."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, *BUCKET, 3), dtype=np.uint8)
    src_hw = np.stack([rng.integers(40, BUCKET[0] + 1, b),
                       rng.integers(40, BUCKET[1] + 1, b)], 1).astype(np.int32)
    return frames, src_hw


@pytest.fixture(scope="module")
def serving_paths():
    """The three YOLO11n serving paths at 96², bf16 (float, the chained int8
    tier, the float-resident int8 tier): name → (the captured call, its
    eager device function, the object that serves it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from tensorrtx_tpu_torch.core.convert import params_from_jax
    from tensorrtx_tpu_torch.core.engine import Engine
    from tensorrtx_tpu_torch.core.quant import ChainedInt8Engine, QuantizedEngine, calibrate
    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
    from tensorrtx_tpu_torch.core.runner import ServingPipeline
    from tensorrtx_tpu_torch.models.yolo11 import Yolo11Cfg, build_params

    dev = torch.device("cuda", 0)
    cfg = Yolo11Cfg(input_h=96, input_w=96, conf_thresh=0.25)
    params = params_from_jax(build_params(RandomWeightMap(seed=0), cfg))
    pipe = ServingPipeline(Engine("yolo11", params, cfg, "bf16", dev), *BUCKET)
    ce = ChainedInt8Engine(Engine("yolo11", params, cfg, "bf16", dev))
    ce.calibrate([frame_set(1, 4)[0]])
    eng = Engine("yolo11", params, cfg, "bf16", dev)
    x = torch.rand((2, 96, 96, 3), generator=torch.Generator().manual_seed(0))
    tier = ServingPipeline(QuantizedEngine(eng, calibrate(eng, [x], "absmax")), *BUCKET)
    return {"float": (pipe, pipe.fused, pipe), "chain": (ce, ce.raw_serve, ce),
            "tier": (tier, tier.fused, tier)}


def eager(fn, frames, src_hw):
    dev = torch.device("cuda", 0)
    return fn(torch.from_numpy(frames).to(dev), torch.from_numpy(src_hw).to(dev))


def assert_same(got, ref, what):
    assert set(got) == set(ref), what
    for k in ref:
        assert torch.equal(got[k], ref[k]), f"{what}: {k} differs"


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("path", ["float", "chain", "tier"])
def test_graph_replay_bit_equal_to_eager(serving_paths, path, b):
    # frames and their true sizes change from call to call; each call's
    # output is read after every later call, so none overwrites another
    call, fn, _ = serving_paths[path]
    sets = [frame_set(10 * b + i, b) for i in range(3)]
    outs = [call(*s) for s in sets]
    for i, s in enumerate(sets):
        assert_same(outs[i], eager(fn, *s), f"{path} b{b} set {i}")
    assert outs[0]["count"].shape == (b,)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["float", "tier"])
def test_detect_images_ignores_pixels_outside_images(serving_paths, path):
    # the pinned buffer keeps the last call's pixels outside each image
    pipe = serving_paths[path][2]
    big, _ = frame_set(40, 2)
    pipe.detect_images(list(big))
    frames, src_hw = frame_set(41, 2)
    images = [f[:h, :w] for f, (h, w) in zip(frames, src_hw)]
    got = pipe.detect_images(images)
    padded = np.zeros_like(frames)
    for i, im in enumerate(images):
        padded[i, :im.shape[0], :im.shape[1]] = im
    from tensorrtx_tpu_torch.core.runner import present_detections

    ref = present_detections(eager(pipe.fused, padded, src_hw), src_hw, pipe.engine.cfg)
    for g, r in zip(got, ref):
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])


@pytest.mark.gpu
def test_chain_graph_follows_set_scales(serving_paths):
    ce = serving_paths["chain"][2]
    frames, src_hw = frame_set(50, 2)
    old = ce.act_scales.copy()
    before = ce(frames, src_hw)
    try:
        ce.set_scales(old * 1.5)
        after = ce(frames, src_hw)
        assert_same(after, eager(ce.raw_serve, frames, src_hw), "chain after set_scales")
        assert not all(torch.equal(after[k], before[k]) for k in before)
    finally:
        ce.set_scales(old)
    assert_same(ce(frames, src_hw), before, "chain with its scales back")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["float", "chain", "tier"])
def test_stream_fn_bit_equal_to_b1_forwards(serving_paths, path):
    _, fn, owner = serving_paths[path]
    frames, src_hw = frame_set(60, 4)
    run = owner.stream_fn(4)
    got = run(frames, src_hw)
    again = run(*frame_set(61, 4))
    for i in range(4):
        ref = eager(fn, frames[i:i + 1], src_hw[i:i + 1])
        assert_same({k: v[i] for k, v in got.items()}, ref, f"{path} stream frame {i}")
    assert got["boxes"].shape[:2] == (4, 1) and again["boxes"].shape[:2] == (4, 1)
    with pytest.raises(ValueError):
        run(*frame_set(62, 3))


@pytest.fixture(scope="module")
def task_paths():
    """The four other yolo11 tasks at a small size (96², cls 64²), bf16:
    task → its `ServingPipeline`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from tensorrtx_tpu_torch.core.convert import params_from_jax
    from tensorrtx_tpu_torch.core.engine import Engine
    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
    from tensorrtx_tpu_torch.core.runner import ServingPipeline
    from tensorrtx_tpu_torch.models.yolo11 import Yolo11Cfg, build_params

    dev = torch.device("cuda", 0)
    out = {}
    for task, nc, size in (("seg", 80, 96), ("pose", 1, 96), ("obb", 15, 96), ("cls", 1000, 64)):
        cfg = Yolo11Cfg(task=task, num_classes=nc, input_h=size, input_w=size, conf_thresh=0.25)
        params = params_from_jax(build_params(RandomWeightMap(seed=0), cfg))
        out[task] = ServingPipeline(Engine("yolo11", params, cfg, "bf16", dev), *BUCKET)
    return out


def as_dict(out):
    return {"logits": out} if torch.is_tensor(out) else out


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("task", ["seg", "pose", "obb", "cls"])
def test_task_graph_replay_bit_equal_to_eager(task_paths, task, b):
    # seg's masks and cls's logits come out of the graph as they come out
    # of the eager forward, for frames whose true sizes change call to call
    pipe = task_paths[task]
    sets = [frame_set(70 + 10 * b + i, b) for i in range(3)]
    outs = [as_dict(pipe(*s)) for s in sets]
    for i, s in enumerate(sets):
        assert_same(outs[i], as_dict(eager(pipe.fused, *s)), f"{task} b{b} set {i}")
    if task == "seg":
        assert outs[0]["masks"].shape == (b, 189, 24, 24)
    if task == "cls":
        assert outs[0]["logits"].shape == (b, 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["seg", "cls"])
def test_task_stream_fn_bit_equal_to_b1_forwards(task_paths, task):
    pipe = task_paths[task]
    frames, src_hw = frame_set(90, 4)
    got = as_dict(pipe.stream_fn(4)(frames, src_hw))
    for i in range(4):
        ref = as_dict(eager(pipe.fused, frames[i:i + 1], src_hw[i:i + 1]))
        assert_same({k: v[i] for k, v in got.items()}, ref, f"{task} stream frame {i}")


@pytest.mark.gpu
def test_task_detect_images_refuses_cls(task_paths):
    frames, src_hw = frame_set(91, 1)
    with pytest.raises(ValueError, match="cls"):
        task_paths["cls"].detect_images([frames[0, :src_hw[0, 0], :src_hw[0, 1]]])


# --- yolov8, yolov10 and yolo26 through the same captured graphs -----------

# this slice's paths at 96² (cls 64²): name → (model, cfg fields)
NEW_PATHS = {
    "v8_det": ("yolov8", {}), "v8_seg": ("yolov8", {"task": "seg"}),
    "v8_pose": ("yolov8", {"task": "pose", "num_classes": 1}),
    "v8_obb": ("yolov8", {"task": "obb", "num_classes": 15}),
    "v8_cls": ("yolov8", {"task": "cls", "num_classes": 1000, "input_h": 64, "input_w": 64}),
    "v8_p2": ("yolov8", {"variant": "p2"}), "v8_5u": ("yolov8", {"variant": "5u"}),
    "v10_det": ("yolov10", {}), "y26_det": ("yolo26", {}),
    "y26_obb": ("yolo26", {"task": "obb", "num_classes": 15}),
    "y26_cls": ("yolo26", {"task": "cls", "num_classes": 1000, "input_h": 64, "input_w": 64}),
}


def new_engine(model, dev, **over):
    import dataclasses

    from tensorrtx_tpu_torch.core.convert import params_from_jax
    from tensorrtx_tpu_torch.core.engine import Engine
    from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
    from tensorrtx_tpu_torch.core.registry import get_model

    md = get_model(model)
    cfg = dataclasses.replace(md.default_cfg(), **{"input_h": 96, "input_w": 96,
                                                   "conf_thresh": 0.25, **over})
    return Engine(model, params_from_jax(md.build_params(RandomWeightMap(seed=0), cfg)), cfg,
                  "bf16", dev)


@pytest.fixture(scope="module")
def new_paths():
    """Every path of this slice at a small size, bf16: NEW_PATHS as
    `ServingPipeline`s, and YOLOv8n det's chained int8 engine ("v8_chain")
    and float-resident tier ("v8_tier"): name → (the captured call, its
    eager device function)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from tensorrtx_tpu_torch.core.quant import ChainedInt8Engine, QuantizedEngine, calibrate
    from tensorrtx_tpu_torch.core.runner import ServingPipeline

    dev = torch.device("cuda", 0)
    out = {}
    for name, (model, over) in NEW_PATHS.items():
        pipe = ServingPipeline(new_engine(model, dev, **over), *BUCKET)
        out[name] = (pipe, pipe.fused)
    ce = ChainedInt8Engine(new_engine("yolov8", dev))
    ce.calibrate([frame_set(1, 4)[0]])
    out["v8_chain"] = (ce, ce.raw_serve)
    eng = new_engine("yolov8", dev)
    x = torch.rand((2, 96, 96, 3), generator=torch.Generator().manual_seed(0))
    tier = ServingPipeline(QuantizedEngine(eng, calibrate(eng, [x], "absmax")), *BUCKET)
    out["v8_tier"] = (tier, tier.fused)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("path", [*NEW_PATHS, "v8_chain", "v8_tier"])
def test_new_path_graph_replay_bit_equal_to_eager(new_paths, path, b):
    call, fn = new_paths[path]
    sets = [frame_set(100 + 10 * b + i, b) for i in range(3)]
    outs = [as_dict(call(*s)) for s in sets]
    for i, s in enumerate(sets):
        assert_same(outs[i], as_dict(eager(fn, *s)), f"{path} b{b} set {i}")
    lead = outs[0]["logits" if path.endswith("cls") else "count"].shape[0]
    assert lead == b


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["v8_chain", "v8_tier"])
def test_v8_int8_qconv_launches_match_plain(new_paths, path):
    """One b2 forward of YOLOv8n det's int8 path with every qconv launch
    recomputed by its plain version on the same inputs (the chain's int8
    outputs within 1 LSB on under 0.1 % of the elements, float exits
    within 1e-5 relative (bf16: 2^-7)), and the launches the path makes:
    35 qconv3x3 + 22 qconv1x1 on the chain; 39 quantize_int8 + 39 qconv3x3
    and 24 qconv1x1 quantizing their own float inputs on the tier."""
    from tensorrtx_tpu_torch.ops.cuda import qconv as qk
    from tensorrtx_tpu_torch.ops.cuda import quantize as qz

    owner, fn = new_paths[path]
    real = {"qconv3x3": qk.qconv3x3, "qconv1x1": qk.qconv1x1}
    calls = {"qconv3x3": 0, "qconv1x1": 0}

    def wrap(name):
        def run(*args, **kw):
            got = real[name](*args, **kw)
            kw = dict(kw)
            sx = kw.pop("sx", None)
            x = args[0] if sx is None else qz.quantize_int8_plain(args[0], sx, divide=True)
            ref = qk.qconv_plain(x, *args[1:], **kw)
            if kw.get("out_float"):
                rel = 2 ** -7 if ref.dtype == torch.bfloat16 else 1e-5
                tol = rel * (1 + float(ref.float().abs().max()))
                assert float((got.float() - ref.float()).abs().max()) <= tol, name
            else:
                d = (got.int() - ref.int()).abs()
                assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3, name
            calls[name] += 1
            return got
        return run

    counters = {"quantize_int8": (qz, "launches"), "qconv3x3": (qk, "launches_3x3"),
                "qconv1x1": (qk, "launches_1x1"), "qconv1x1_fq": (qk, "launches_1x1_fq")}
    before = {k: getattr(m, a) for k, (m, a) in counters.items()}
    for name in real:
        setattr(qk, name, wrap(name))
    try:
        out = eager(fn, *frame_set(120, 2))
    finally:
        for name, f in real.items():
            setattr(qk, name, f)
    torch.cuda.synchronize()
    made = {k: getattr(m, a) - before[k] for k, (m, a) in counters.items()}
    if path == "v8_chain":
        assert calls == {"qconv3x3": 35, "qconv1x1": 22}
        assert made == {"quantize_int8": 0, "qconv3x3": 35, "qconv1x1": 22, "qconv1x1_fq": 0}
    else:
        assert calls == {"qconv3x3": 39, "qconv1x1": 24}
        assert made == {"quantize_int8": 39, "qconv3x3": 39, "qconv1x1": 0, "qconv1x1_fq": 24}
    assert out["count"].shape == (2,)


# last in this file: it makes two captures fail on purpose
@pytest.mark.gpu
@pytest.mark.parametrize("unsafe", ["h2d", "d2h"])
def test_capture_of_a_host_copy_raises(cuda, unsafe):
    from tensorrtx_tpu_torch.core.runner import capture_graph

    fns = {"h2d": lambda x: x + torch.tensor(1.0, device=x.device),
           "d2h": lambda x: x * x.sum().item()}
    x = torch.ones(8, device=cuda)
    with pytest.raises(RuntimeError):
        capture_graph(fns[unsafe], (x,))
    torch.cuda.synchronize()
    graph, out = capture_graph(lambda v: v * 2, (x,))
    graph.replay()
    assert torch.equal(out, torch.full_like(x, 2.0))

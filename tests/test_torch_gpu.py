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
    (1, 1, 32, 40, 40, 256, 128, "silu", False, False),
    (1, 1, 1, 13, 7, 6, 10, "relu", True, False),
    (1, 1, 2, 20, 20, 80, 80, None, False, True),
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

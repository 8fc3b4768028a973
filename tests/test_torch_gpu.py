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

"""Port ops (tensorrtx_tpu_torch.ops.nn / .preprocess) against their JAX
counterparts on the same numpy inputs, float32, atol 1e-5.

The port keeps feature maps NCHW (channels_last memory) with OIHW kernels;
the JAX package NHWC with HWIO. The tests move between the two with plain
transposes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tensorrtx_tpu.ops import nn as jnn
from tensorrtx_tpu.ops import preprocess as jpre
from tensorrtx_tpu_torch.ops import nn as tnn
from tensorrtx_tpu_torch.ops import preprocess as tpre

ATOL = 1e-5


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("k,stride,cin,cout,groups", [
    (3, 1, 8, 16, 1), (3, 2, 8, 16, 1), (1, 1, 16, 24, 1), (1, 2, 16, 8, 1),
    (3, 1, 16, 16, 16), (3, 2, 8, 8, 8)])
def test_conv2d(k, stride, cin, cout, groups, rng):
    x = rng.normal(size=(2, 11, 9, cin)).astype(np.float32)
    w = rng.normal(0, 0.2, (k, k, cin // groups, cout)).astype(np.float32)  # HWIO
    b = rng.normal(size=(cout,)).astype(np.float32)
    exp = np.asarray(jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                stride=stride, padding=k // 2, groups=groups))
    got = tnn.conv2d(to_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     torch.from_numpy(b), stride=stride, padding=k // 2)
    np.testing.assert_allclose(to_nhwc(got), exp, atol=ATOL)


def test_silu_max_pool_upsample(rng):
    x = rng.normal(size=(2, 7, 10, 5)).astype(np.float32)
    np.testing.assert_allclose(to_nhwc(tnn.silu(to_nchw(x))),
                               np.asarray(jnn.silu(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_array_equal(to_nhwc(tnn.max_pool(to_nchw(x), 5, 1, 2)),
                                  np.asarray(jnn.max_pool(jnp.asarray(x), 5, 1, 2)))
    np.testing.assert_array_equal(to_nhwc(tnn.upsample_nearest(to_nchw(x))),
                                  np.asarray(jnn.upsample_nearest(jnp.asarray(x))))


def test_dfl(rng):
    x = rng.normal(0, 3, (2, 37, 64)).astype(np.float32)
    got = tnn.dfl(torch.from_numpy(x), 16)
    assert got.shape == (2, 37, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jnn.dfl(jnp.asarray(x), 16)),
                               atol=ATOL)
    # half-precision logits decode in float32 too
    assert tnn.dfl(torch.from_numpy(x).bfloat16(), 16).dtype == torch.float32


@pytest.mark.parametrize("src_hw,bucket,dst,bgr", [
    ((37, 53), (40, 60), (64, 64), False),    # smaller than its bucket
    ((60, 41), (60, 41), (48, 80), True),     # non-square, BGR→RGB
    ((90, 30), (96, 32), (64, 64), False),    # tall: horizontal border
])
def test_letterbox(src_hw, bucket, dst, bgr, rng):
    img = rng.integers(0, 256, (*bucket, 3), dtype=np.uint8)
    exp = np.asarray(jpre.letterbox(jnp.asarray(img), src_hw[0], src_hw[1], *dst,
                                    bgr_to_rgb=bgr))
    got = tpre.letterbox(torch.from_numpy(img), src_hw[0], src_hw[1], *dst,
                         bgr_to_rgb=bgr)
    assert got.shape == (*dst, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, atol=ATOL)


def test_letterbox_batch_matches_per_image(rng):
    imgs = rng.integers(0, 256, (2, 50, 70, 3), dtype=np.uint8)
    src_hw = np.array([[50, 70], [33, 47]], np.int32)
    got = tpre.letterbox_batch(torch.from_numpy(imgs), src_hw, 64, 64).numpy()
    exp = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), jnp.asarray(src_hw), 64, 64,
                                          method="gather"))
    np.testing.assert_allclose(got, exp, atol=ATOL)
    # the serving path's matmul letterbox agrees to float rounding
    exp_mm = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), jnp.asarray(src_hw), 64, 64))
    np.testing.assert_allclose(got, exp_mm, atol=ATOL)


def test_scale_boxes_back(rng):
    boxes = rng.uniform(-10, 650, (17, 4)).astype(np.float32)
    for h, w in [(480, 640), (720, 405), (640, 640)]:
        exp = np.asarray(jpre.scale_boxes_back(jnp.asarray(boxes), h, w, 640, 640))
        got = tpre.scale_boxes_back(torch.from_numpy(boxes), h, w, 640, 640).numpy()
        np.testing.assert_allclose(got, exp, atol=ATOL, rtol=1e-6)

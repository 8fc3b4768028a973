"""Port NMS (tensorrtx_tpu_torch.ops.nms + the CUDA keep-mask kernel's
wrapper) against the JAX package: keep masks and top-k indices bit-equal,
select_and_nms field for field.

Inputs are adversarial for ordering: scores drawn from a few levels (many
exact ties), duplicated boxes (IoU exactly 1), near-threshold overlaps, a
tail of invalid slots and 3 classes, at the main path's N = max_det = 300.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tensorrtx_tpu.ops.nms import (box_iou_matrix as jax_iou, nms_mask as jax_nms_mask,
                                   select_and_nms as jax_select, topk_hier)
from tensorrtx_tpu.ops.pallas.nms_pallas import nms_mask_pallas
from tensorrtx_tpu_torch.ops import nms as tn
from tensorrtx_tpu_torch.ops.cuda import nms_mask as kern

N = 300
THRESH = 0.45


def adversarial_candidates(seed, b=4, n=N, nc=3, n_invalid=40):
    """(b, n, 4) boxes sorted by descending score, (b, n) scores with ties
    and a zero tail, (b, n) float class ids."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 100, (b, n))
    cy = rng.uniform(0, 100, (b, n))
    w = rng.uniform(5, 40, (b, n))
    h = rng.uniform(5, 40, (b, n))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    # exact duplicates and near-threshold shifted copies of earlier boxes
    boxes[:, 1::7] = boxes[:, 0:-1:7][:, : boxes[:, 1::7].shape[1]]
    shift = rng.uniform(0.05, 0.5, (b, boxes[:, 2::5].shape[1], 1))
    boxes[:, 2::5] = boxes[:, 1:-1:5][:, : boxes[:, 2::5].shape[1]] + shift * w[:, 2::5, None]
    boxes = boxes.astype(np.float32)
    scores = rng.choice(np.linspace(0.3, 0.9, 7), (b, n)).astype(np.float32)
    classes = rng.integers(0, nc, (b, n)).astype(np.float32)
    o = np.argsort(-scores, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(a, o, 1)
    boxes = np.take_along_axis(boxes, o[..., None], 1)
    scores, classes = take(scores), take(classes)
    scores[:, n - n_invalid:] = 0.0
    return boxes, scores, classes


@pytest.mark.parametrize("seed,n,n_invalid,equal", [
    pytest.param(0, N, 40, False, id="0"),
    pytest.param(1, N, 40, False, id="1"),
    # around the CUDA kernel's 32-candidate warp steps: one past a step, one
    # past eight, with every valid score equal (priority by index alone)
    pytest.param(2, 33, 5, False, id="n33"),
    pytest.param(3, 257, 30, False, id="n257"),
    pytest.param(4, 257, 30, True, id="n257-equal"),
])
def test_keep_mask_bit_equal_to_jax_and_pallas(seed, n, n_invalid, equal):
    boxes, scores, classes = adversarial_candidates(seed, n=n, n_invalid=n_invalid)
    if equal:
        scores[scores > 0] = 0.5
    got = kern.keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), THRESH).numpy()
    assert got.dtype == np.bool_ and got.shape == scores.shape
    assert 0 < got.sum() < (scores > 0).sum()  # NMS had work
    for i in range(boxes.shape[0]):
        exp = np.asarray(jax_nms_mask(jax_iou(jnp.asarray(boxes[i])),
                                      jnp.asarray(scores[i]), jnp.asarray(classes[i]),
                                      THRESH, jnp.asarray(scores[i] > 0)))
        pal = np.asarray(nms_mask_pallas(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                         jnp.asarray(classes[i]), THRESH,
                                         interpret=True))
        np.testing.assert_array_equal(got[i], exp)
        np.testing.assert_array_equal(got[i], pal)


def test_iou_matrix_matches_jax():
    boxes, _, _ = adversarial_candidates(2, b=1)
    got = tn.box_iou_matrix(torch.from_numpy(boxes[0])).numpy()
    exp = np.asarray(jax_iou(jnp.asarray(boxes[0])))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("n,k", [(8400, 300), (1000, 300), (200, 300)])
def test_topk_indices_bit_equal_on_ties(n, k):
    rng = np.random.default_rng(n)
    x = rng.choice(np.float32([0.25, 0.5, 0.5000001, 0.75]), (2, n))
    x = np.where(rng.uniform(size=(2, n)) < 0.5, x, np.float32(-1.0)).astype(np.float32)
    kk = min(k, n)
    v, i = tn.topk_exact(torch.from_numpy(x), kk)
    jv, ji = jax.vmap(lambda r: topk_hier(r, kk))(jnp.asarray(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_select_and_nms_matches_jax(impl, monkeypatch):
    # the JAX package's select_and_nms(impl="pallas") calls the kernel
    # without interpret=True; on the CPU it runs in interpret mode
    import functools

    import tensorrtx_tpu.ops.pallas.nms_pallas as pallas_mod

    monkeypatch.setattr(pallas_mod, "nms_mask_pallas",
                        functools.partial(nms_mask_pallas, interpret=True))
    rng = np.random.default_rng(7)
    b, n = 2, 1200
    boxes, _, _ = adversarial_candidates(3, b=b, n=n, n_invalid=0)
    scores = rng.choice(np.float32([0.1, 0.3, 0.3, 0.5, 0.7]), (b, n)).astype(np.float32)
    classes = rng.integers(0, 3, (b, n)).astype(np.float32)
    kern.launches = 0
    got = tn.select_and_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes), 0.25, THRESH, N).as_dict()
    assert kern.launches == 0  # CPU tensors take the plain version
    exp = jax_select(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                     0.25, THRESH, N, impl=impl).as_dict()
    assert set(got) == set(exp)
    for key in exp:
        e = np.asarray(exp[key])
        g = got[key].numpy()
        assert g.dtype == e.dtype and g.shape == e.shape, key
        np.testing.assert_array_equal(g, e, err_msg=key)
    assert (got["count"].numpy() > 0).all()


def test_keep_mask_rejects_bad_input():
    boxes, scores, classes = adversarial_candidates(0, b=1)
    t = lambda a: torch.from_numpy(a)
    with pytest.raises(TypeError):
        kern.keep_mask(t(boxes).double(), t(scores), t(classes), THRESH)
    with pytest.raises(ValueError):
        kern.keep_mask(t(boxes)[..., :3], t(scores), t(classes), THRESH)
    with pytest.raises(ValueError):
        kern.keep_mask(t(boxes), t(scores)[:, :-1], t(classes), THRESH)
    # a tensor off the CPU gets the kernel or an error, never the plain version
    meta = [t(a).to("meta") for a in (boxes, scores, classes)]
    with pytest.raises(ValueError):
        kern.keep_mask(*meta, THRESH)


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    from tensorrtx_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["nms_mask"])
    assert not list(tmp_path.iterdir())

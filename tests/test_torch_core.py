"""Port core (tensorrtx_tpu_torch.core) against the JAX package: .wts I/O,
BN folding, random weights, the engine-dir format in both directions, the
CLI, and the package's independence from JAX."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tensorrtx_tpu.core import engine as jeng
from tensorrtx_tpu.core.params import WeightMap as JaxWeightMap
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.core.wts import load_wts as jax_load_wts, save_wts as jax_save_wts
from tensorrtx_tpu.models import yolo11 as jy
from tensorrtx_tpu_torch import cli
from tensorrtx_tpu_torch.core import engine as teng
from tensorrtx_tpu_torch.core.convert import params_from_jax, params_to_jax
from tensorrtx_tpu_torch.core.params import WeightMap
from tensorrtx_tpu_torch.core.random_weights import RandomWeightMap
from tensorrtx_tpu_torch.core.wts import load_wts, save_wts
from tensorrtx_tpu_torch.models import yolo11 as ty

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 64


def leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]
    return [(jax.tree_util.keystr(p), v) for p, v in flat]


def assert_trees_byte_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None, k
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


def conv_bn_tensors(rng, prefix="c", o=6, i=4, k=3, conv_bias=False):
    t = {f"{prefix}.conv.weight": rng.normal(size=(o, i, k, k)),
         f"{prefix}.bn.weight": rng.uniform(0.5, 1.5, o),
         f"{prefix}.bn.bias": rng.normal(size=o),
         f"{prefix}.bn.running_mean": rng.normal(size=o),
         f"{prefix}.bn.running_var": rng.uniform(0.5, 1.5, o)}
    if conv_bias:
        t[f"{prefix}.conv.bias"] = rng.normal(size=o)
    return {k: v.astype(np.float32) for k, v in t.items()}


def test_wts_roundtrip_byte_equal(tmp_path, rng):
    tensors = conv_bn_tensors(rng) | {"special": np.float32([-0.0, np.inf, -3.5])}
    ours, theirs = tmp_path / "a.wts", tmp_path / "b.wts"
    save_wts(str(ours), tensors)
    jax_save_wts(str(theirs), tensors)
    assert ours.read_bytes() == theirs.read_bytes()
    a, b = load_wts(str(ours)), jax_load_wts(str(theirs))
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("conv_bias", [False, True])
def test_conv_bn_fold_equal(conv_bias, rng):
    raw = conv_bn_tensors(rng, conv_bias=conv_bias)
    got = WeightMap(dict(raw)).conv_bn("c.conv", "c.bn", 6, 4, (3, 3), eps=1e-3)
    exp = JaxWeightMap(dict(raw)).conv_bn("c.conv", "c.bn", 6, 4, (3, 3), eps=1e-3)
    assert_trees_byte_equal(got, exp)
    # depthwise kernels fold per output channel too
    dw = conv_bn_tensors(rng, "d", o=5, i=1)
    got = WeightMap(dw).conv_bn("d.conv", "d.bn", 5, 5, (3, 3), groups=5, eps=1e-5)
    exp = JaxWeightMap(dw).conv_bn("d.conv", "d.bn", 5, 5, (3, 3), groups=5, eps=1e-5)
    assert_trees_byte_equal(got, exp)


@pytest.mark.parametrize("scale", ["n", "s"])
def test_random_weight_trees_byte_equal(scale):
    cfg = ty.Yolo11Cfg(scale=scale)
    got = ty.build_params(RandomWeightMap(seed=0), cfg)
    exp = jy.build_params(JaxRWM(seed=0), dataclasses.replace(jy.Yolo11Cfg(), scale=scale))
    assert_trees_byte_equal(got, exp)


def test_module_names_mirror_param_tree():
    cfg = ty.Yolo11Cfg(input_h=H, input_w=H)
    tree = ty.build_params(RandomWeightMap(seed=0), cfg)
    eng = teng.Engine("yolo11", params_from_jax(tree), cfg, device="cpu")
    names = dict(eng.module.named_buffers())
    assert "neck.m10.m.0.attn.qkv.w" in names and "head.cv2.0.a.w" in names
    flat_tree = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]
    paths = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
             for p, v in flat_tree}
    flat, none_paths = params_to_jax(eng.module)
    assert set(none_paths) == {k for k, v in paths.items() if v is None}
    assert set(flat) == {k for k, v in paths.items() if v is not None}
    for k, v in flat.items():
        assert v.tobytes() == paths[k].tobytes(), k  # OIHW → HWIO restores the tree


def _raw_cfgs():
    over = dict(input_h=H, input_w=H, postprocess="raw")
    return dataclasses.replace(jy.Yolo11Cfg(), **over), ty.Yolo11Cfg(**over)


def test_engine_saved_by_jax_loads_in_port(tmp_path, rng):
    jcfg, _ = _raw_cfgs()
    params = jax.tree.map(jnp.asarray, jy.build_params(JaxRWM(seed=0), jcfg))
    je = jeng.Engine("yolo11", params, jcfg, "fp32")
    je.save(str(tmp_path / "e"))
    te = teng.load_engine(str(tmp_path / "e"), device="cpu")
    assert te.cfg == ty.Yolo11Cfg(**dataclasses.asdict(jcfg))
    x = rng.uniform(0, 1, (1, H, H, 3)).astype(np.float32)
    exp, got = je(jnp.asarray(x)), te(x)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(exp["conf"]), atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(exp["boxes"]), atol=1e-3)


def test_engine_saved_by_port_loads_in_jax(tmp_path, rng):
    _, tcfg = _raw_cfgs()
    te = teng.Engine("yolo11", params_from_jax(ty.build_params(RandomWeightMap(seed=0), tcfg)),
                     tcfg, "bf16", device="cpu")
    te.save(str(tmp_path / "e"))
    meta = json.loads((tmp_path / "e" / "meta.json").read_text())
    assert meta["format_version"] == 1 and len(meta["none_paths"]) == 6
    je = jeng.load_engine(str(tmp_path / "e"))
    assert je.precision == "bf16"
    # the bf16 weights the port holds are what JAX loads back
    j_leaves = dict(leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), je.params)))
    flat, _ = params_to_jax(te.module)
    assert len(flat) == sum(v is not None for v in j_leaves.values())
    # and the port's own reload serves the same detections
    te2 = teng.load_engine(str(tmp_path / "e"), device="cpu")
    x = rng.uniform(0, 1, (1, H, H, 3)).astype(np.float32)
    a, b = te(x), te2(x)
    for k in a:
        assert np.array_equal(a[k].float().numpy(), b[k].float().numpy()), k


def test_cli_build_run_list(tmp_path, capsys):
    from PIL import Image

    wm = RandomWeightMap(seed=0)
    ty.build_params(wm, ty.Yolo11Cfg())
    save_wts(str(tmp_path / "y.wts"), wm.raw)
    assert cli.main(["build", "yolo11", "-w", str(tmp_path / "y.wts"), "-o",
                     str(tmp_path / "y.engine"), "--set", f"input_h={H}",
                     f"input_w={H}", "conf_thresh=0.25", "--device", "cpu"]) == 0
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(50, 70), (64, 40)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
    capsys.readouterr()
    assert cli.main(["run", str(tmp_path / "y.engine"), str(imgs), "--batch", "2",
                     "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [os.path.basename(d["image"]) for d in lines] == ["0.png", "1.png"]
    assert all(d["detections"] for d in lines)
    assert cli.main(["list"]) == 0
    assert capsys.readouterr().out.startswith("yolo11")


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['tensorrtx_tpu'] = None\n"
            "import tensorrtx_tpu_torch, tensorrtx_tpu_torch.cli\n"
            "from tensorrtx_tpu_torch.core import runner, engine, convert\n"
            "from tensorrtx_tpu_torch.ops.cuda import nms_mask, build\n"
            "from tensorrtx_tpu_torch.models import yolo11\n"
            "print(tensorrtx_tpu_torch.list_models())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "yolo11" in out.stdout

"""The port's serving runner and profiler (tensorrtx_tpu_torch.core.runner,
core.profiler) against the JAX package's on the CPU: `stream_fn`, the
eager route of `ServingPipeline` and `ChainedInt8Engine`, the bench
helpers and `StageProfiler`. float32, 96² YOLO11n, weights from one
`RandomWeightMap` seed (the packages draw byte-equal trees). The captured
CUDA-graph route is held on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrtx_tpu.core import profiler as jprof
from tensorrtx_tpu.core import runner as jrun
from tensorrtx_tpu.core.engine import Engine as JaxEngine
from tensorrtx_tpu.core.random_weights import RandomWeightMap as JaxRWM
from tensorrtx_tpu.models import yolo11 as jy
from tensorrtx_tpu_torch.core import profiler as tprof
from tensorrtx_tpu_torch.core import runner as trun
from tensorrtx_tpu_torch.core.convert import params_from_jax
from tensorrtx_tpu_torch.core.engine import Engine
from tensorrtx_tpu_torch.core.quant import ChainedInt8Engine
from tensorrtx_tpu_torch.models import yolo11 as ty

H = 96
BUCKET = (120, 100)
OVER = dict(input_h=H, input_w=H, conf_thresh=0.25, max_det=300)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    return jy.build_params(JaxRWM(seed=0), dataclasses.replace(jy.Yolo11Cfg(), **OVER))


@pytest.fixture(scope="module")
def pipe(params):
    eng = Engine("yolo11", params_from_jax(params), ty.Yolo11Cfg(**OVER), device="cpu")
    return trun.ServingPipeline(eng, *BUCKET)


def three_sizes(seed):
    """Three uint8 frames in the bucket and three different true sizes."""
    frames = np.random.default_rng(seed).integers(0, 256, (3, *BUCKET, 3), dtype=np.uint8)
    return frames, np.array([[120, 100], [80, 90], [57, 100]], np.int32)


def as_tensors(frames, src_hw):
    return torch.from_numpy(frames), torch.from_numpy(src_hw)


def test_stream_fn_matches_jax(params, pipe):
    """`stream_fn(3)` of the port (the eager loop of three batch-1
    forwards) against JAX's scan over the same frames: the same leaves and
    shapes (k, 1, ...), detections at `test_serving_pipeline_matches_jax`'s
    bars."""
    frames, src_hw = three_sizes(1)
    jeng = JaxEngine("yolo11", jax.tree.map(jnp.asarray, params),
                     dataclasses.replace(jy.Yolo11Cfg(), **OVER), "fp32")
    jpipe = jrun.ServingPipeline(jeng, *BUCKET, donate=False)
    exp = {k: np.asarray(v) for k, v in
           jpipe.stream_fn(3)(jpipe._params, jnp.asarray(frames), jnp.asarray(src_hw)).items()}
    got = {k: v.numpy() for k, v in pipe.stream_fn(3)(frames, src_hw).items()}
    assert set(got) == set(exp)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in exp.items()}
    assert got["count"].shape == (3, 1) and (exp["count"] > 0).all()
    for k in ("count", "valid", "classes"):
        np.testing.assert_array_equal(got[k], exp[k])
    np.testing.assert_allclose(got["scores"], exp["scores"], atol=1e-5)
    np.testing.assert_allclose(got["boxes"], exp["boxes"], atol=1e-3)


def test_stream_fn_stacks_batch1_forwards(pipe):
    frames, src_hw = three_sizes(2)
    got = pipe.stream_fn(3)(frames, src_hw)
    for i in range(3):
        ref = pipe.fused(*as_tensors(frames[i:i + 1], src_hw[i:i + 1]))
        for k in ref:
            assert torch.equal(got[k][i], ref[k]), k
    with pytest.raises(ValueError):
        pipe.stream_fn(2)(frames, src_hw)


def test_fused_equals_call_on_cpu(pipe):
    frames, src_hw = three_sizes(3)
    got = pipe(frames, src_hw)
    ref = pipe.fused(*as_tensors(frames, src_hw))
    assert set(got) == {"boxes", "scores", "classes", "valid", "count"}
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    full = pipe(frames)              # no src_hw: each frame at its full size
    ref = pipe.fused(*as_tensors(frames, np.array([BUCKET] * 3, np.int32)))
    for k in ref:
        assert torch.equal(full[k], ref[k]), k


def test_pixels_outside_images_do_not_change_results(pipe):
    """The letterbox reads only each image's (h, w) corner of its frame, so
    `detect_images` may leave the rest of a reused staging buffer as it
    was."""
    frames, src_hw = three_sizes(4)
    other = np.random.default_rng(5).integers(0, 256, frames.shape, dtype=np.uint8)
    for i, (h, w) in enumerate(src_hw):
        other[i, :h, :w] = frames[i, :h, :w]
    assert not np.array_equal(other, frames)
    a, b = pipe(frames, src_hw), pipe(other, src_hw)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    dets = pipe.detect_images([f[:h, :w] for f, (h, w) in zip(other, src_hw)])
    ref = trun.present_detections(a, src_hw, pipe.engine.cfg)
    assert [len(d["boxes"]) for d in dets] == a["count"].tolist()
    for d, r in zip(dets, ref):
        for k in r:
            np.testing.assert_array_equal(d[k], r[k])


@pytest.fixture(scope="module")
def chained(params):
    eng = Engine("yolo11", params_from_jax(params), ty.Yolo11Cfg(**OVER), device="cpu")
    ce = ChainedInt8Engine(eng, dtype=torch.float32)
    ce.calibrate([three_sizes(6)[0]])
    return ce


def test_chained_call_is_raw_serve_on_cpu(chained):
    frames, src_hw = three_sizes(7)
    got = chained(frames, src_hw)
    ref = chained.raw_serve(*as_tensors(frames, src_hw))
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    stream = chained.stream_fn(3)(frames, src_hw)
    for i in range(3):
        one = chained.raw_serve(*as_tensors(frames[i:i + 1], src_hw[i:i + 1]))
        for k in one:
            assert torch.equal(stream[k][i], one[k]), k


def test_chained_set_scales_writes_in_place(chained):
    """A CUDA graph captured before `set_scales` reads the scale table where
    it lies, so the table is overwritten in place."""
    old = chained.act_scales.copy()
    table = chained._scales
    ptr = table.data_ptr()
    try:
        chained.set_scales(old * 2)
        assert chained._scales is table and table.data_ptr() == ptr
        np.testing.assert_array_equal(table.numpy(), old * 2)
    finally:
        chained.set_scales(old)
    np.testing.assert_array_equal(table.numpy(), old)


@pytest.mark.parametrize("shape", [(3, 120, 100), (0, 120, 100, 3), (1, 120, 100, 4)])
def test_entry_points_refuse_frames_of_another_shape(pipe, chained, shape):
    """The pipeline's and the chained engine's `__call__` and the chain's
    calibration share one check that frames are (B, H, W, 3), B >= 1."""
    frames = np.zeros(shape, np.uint8)
    for call in (pipe, chained, lambda f: chained.calibrate([f])):
        with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
            call(frames)


def test_bench_helpers_return_jax_keys():
    x = np.arange(6, dtype=np.float32)
    jloop = jrun.bench_loop(lambda v: {"a": v * 2}, [(jnp.asarray(x),)], iters=3, warmup=1)
    tloop = trun.bench_loop(lambda v: {"a": v * 2}, [(torch.from_numpy(x),)], iters=3, warmup=1)
    assert set(tloop) == set(jloop) == {"mean_ms", "p50_ms", "p99_ms"}
    assert all(v >= 0 for v in tloop.values())
    jm = jrun.bench_marginal(lambda v: v + 1, [(jnp.asarray(x),)], n_small=2, n_large=4)
    tm = trun.bench_marginal(lambda v: v + 1, [(torch.from_numpy(x),)], n_small=2, n_large=4)
    assert set(tm) == set(jm) == {"iter_ms"}


def test_stage_profiler_table_matches_jax():
    jp, tp = jprof.StageProfiler(), tprof.StageProfiler()
    for name, s in (("decode", 0.0012), ("run", 0.0153), ("decode", 0.0009)):
        jp.record(name, s)
        tp.record(name, s)
    assert tp.table() == jp.table()
    with tp.stage("post"):
        pass
    assert tp.table().splitlines()[0] == jp.table().splitlines()[0]
    assert len(tp.times["post"]) == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_device_times_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError):
        tprof.device_p50_ms(lambda: None, [()], iters=2)
    with pytest.raises(RuntimeError):
        tprof.queued_ms(lambda: None)


def test_runner_and_profiler_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['tensorrtx_tpu'] = None\n"
            "from tensorrtx_tpu_torch.core import profiler, runner\n"
            "print(runner.ServingPipeline.stream_fn.__name__, profiler.device_p50_ms.__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["stream_fn", "device_p50_ms"]

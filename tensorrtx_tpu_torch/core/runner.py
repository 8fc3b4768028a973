"""Serving runner — the inference driver loop on the card.

The reference's loop (yolo11/yolo11_det.cpp:218-252) is imread →
pinned-host staging → H2D → preprocess kernel → enqueue → decode/NMS
kernels → D2H → CPU finishing. Here the host hands over raw uint8 frames
and gets back the fixed-size detection buffer; letterbox, network, decode,
top-k and NMS all run on the engine's device, the NMS keep mask in the
hand-written CUDA kernel.

On the card the whole device side is ONE program, as in the JAX package,
where it is one jitted XLA program: a CUDA graph captured once per frames
shape (`jax.jit` also compiles once per shape) and replayed for every
later call. Frames cross to the card from a reused pinned host buffer.
On the CPU (``device="cpu"``, as the tests ask) the same function runs
eagerly.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tensorrtx_tpu_torch.core.engine import Engine
from tensorrtx_tpu_torch.ops.preprocess import letterbox_batch, scale_boxes_back

__all__ = ["ServingPipeline", "GraphRunner", "capture_graph", "check_frames", "serve",
           "serve_filled", "stream_runner", "present_detections", "load_image",
           "read_files_in_dir", "cuda_event_ms", "bench_loop", "bench_marginal"]

# warm-up calls before a capture: they load the kernels' libraries, run
# their one-time device setup (shared-memory opt-ins, SM counts), fill the
# model's per-device constants and let cuDNN pick its algorithms
_WARMUP_CALLS = 2


def capture_graph(fn: Callable, args: tuple, pool=None):
    """Run ``fn(*args)`` _WARMUP_CALLS times on a side stream, then capture one
    call into a `torch.cuda.CUDAGraph` (memory from ``pool``, a
    `torch.cuda.graph_pool_handle()`, or the graph's own). Returns (graph,
    the call's outputs: the static tensors every replay rewrites). args
    are device tensors the replays read in place. Anything the capture
    refuses (a host copy or sync inside fn) raises; nothing falls back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(_WARMUP_CALLS):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn(*args)
    return graph, out


def _on_host(a, dtype) -> np.ndarray:
    return (a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)).astype(dtype, copy=False)


def check_frames(shape) -> tuple:
    """A frames shape as ints, checked to be (B, H, W, 3) with B >= 1."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != 4 or shape[-1] != 3 or shape[0] < 1:
        raise ValueError(f"expected (B, H, W, 3) uint8 frames with B >= 1, got shape {shape}")
    return shape


class _Staged:
    """One frames shape's captured program: pinned host buffers for the
    frames and their (h, w), the static device buffers the graph reads,
    the graph and its static outputs."""

    def __init__(self, fn: Callable, shape: tuple, device: torch.device, pool):
        b, h, w = shape[:3]
        self.host_frames = torch.zeros(shape, dtype=torch.uint8, pin_memory=True)
        self.host_hw = torch.tensor([[h, w]] * b, dtype=torch.int32).pin_memory()
        self.frames_np, self.hw_np = self.host_frames.numpy(), self.host_hw.numpy()
        self.frames = self.host_frames.to(device)
        self.src_hw = self.host_hw.to(device)
        self.staged = torch.cuda.Event()   # the last H2D out of the pinned buffers is done
        self.staged.record()
        t0 = time.perf_counter()
        self.graph, self.out = capture_graph(fn, (self.frames, self.src_hw), pool)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def host(self):
        """The pinned buffers' numpy views (frames, src_hw), once the card
        has copied out what the last call wrote there."""
        self.staged.synchronize()
        return self.frames_np, self.hw_np

    def launch(self):
        """Copy the pinned buffers to the card (asynchronously, on the
        current stream), replay the graph, and return copies of its outputs
        (a dict of tensors, or cls's logits tensor), which the next replay
        does not overwrite."""
        self.frames.copy_(self.host_frames, non_blocking=True)
        self.src_hw.copy_(self.host_hw, non_blocking=True)
        self.staged.record()
        self.graph.replay()
        if torch.is_tensor(self.out):
            return self.out.clone()
        return {k: v.clone() for k, v in self.out.items()}


class GraphRunner:
    """``fn(frames, src_hw)`` of device tensors (uint8 (B, H, W, 3), int32
    (B, 2)) → a dict of device tensors or one tensor, served on the card as
    one CUDA graph per frames shape: the first call for a shape warms fn and
    captures it (`capture_graph`); every call stages the frames through
    that shape's pinned buffers and replays. The graphs share one memory
    pool, which is safe because replays run one after another on the
    current stream and return copies of the outputs."""

    def __init__(self, fn: Callable, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.fn = fn
        self.device = device
        with torch.cuda.device(device):
            self._pool = torch.cuda.graph_pool_handle()
        self._staged: Dict[tuple, _Staged] = {}

    def staged(self, shape) -> _Staged:
        """The captured program for frames of ``shape`` (B, H, W, 3),
        captured now if it is new."""
        shape = check_frames(shape)
        st = self._staged.get(shape)
        if st is None:
            with torch.cuda.device(self.device):
                st = _Staged(self.fn, shape, self.device, self._pool)
            self._staged[shape] = st
        return st

    def run(self, shape, fill: Callable):
        """One replay for frames of ``shape``: ``fill(frames, src_hw)``
        writes the call's inputs into the numpy views of that shape's
        pinned buffers, which are then copied to the card."""
        st = self.staged(shape)
        fill(*st.host())
        with torch.cuda.device(self.device):
            return st.launch()

    def __call__(self, frames, src_hw):
        return self.run(frames.shape, _copy_in(frames, src_hw))


def _copy_in(frames, src_hw) -> Callable:
    """A ``fill`` (`GraphRunner.run`) that copies these frames and src_hw."""
    def fill(fr, hw):
        fr[...] = _on_host(frames, np.uint8)
        hw[...] = _on_host(src_hw, np.int32)
    return fill


def serve_filled(fn: Callable, graphs: Optional[GraphRunner], device: torch.device, shape,
                 fill: Callable):
    """One call of the device function fn on frames of ``shape`` (B, H, W,
    3) uint8 and their src_hw (B, 2), which ``fill(frames, src_hw)`` writes
    into numpy buffers: on the card the pinned staging buffers of a replay
    from ``graphs``, elsewhere new zeroed arrays that fn then reads on
    ``device``."""
    shape = check_frames(shape)
    if graphs is not None:
        return graphs.run(shape, fill)
    frames, src_hw = np.zeros(shape, np.uint8), np.zeros((shape[0], 2), np.int32)
    fill(frames, src_hw)
    return fn(torch.from_numpy(frames).to(device), torch.from_numpy(src_hw).to(device))


def serve(fn: Callable, graphs: Optional[GraphRunner], device: torch.device, frames,
          src_hw=None):
    """One call of fn on host frames (B, H, W, 3) uint8 and src_hw (B, 2)
    (None: each frame's full (H, W)) by `serve_filled`."""
    shape = check_frames(frames.shape)
    if src_hw is None:
        src_hw = np.tile([shape[1:3]], (shape[0], 1))
    return serve_filled(fn, graphs, device, shape, _copy_in(frames, src_hw))


def stream_runner(fn: Callable, k: int, device: torch.device) -> Callable:
    """``run(frames (k, H, W, 3) uint8, src_hw (k, 2))`` → fn's outputs for
    each frame at batch 1, stacked (leaves (k, 1, ...); cls's logits
    (k, 1, nc)), as the JAX package's `stream_fn` scan stacks them. On the card the k calls are one
    CUDA graph (a `GraphRunner`); elsewhere they run eagerly."""
    def body(frames, src_hw):
        if frames.shape[0] != k:
            raise ValueError(f"this stream function takes {k} frames, got {frames.shape[0]}")
        outs = [fn(frames[i:i + 1], src_hw[i:i + 1]) for i in range(k)]
        if torch.is_tensor(outs[0]):
            return torch.stack(outs)
        return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    if device.type == "cuda":
        return GraphRunner(body, device)
    return lambda frames, src_hw: serve(body, None, device, frames, src_hw)


class ServingPipeline:
    """uint8 frames → detections on the engine's device.

    Frames share one static source bucket (src_h, src_w); an image smaller
    than the bucket sits in its frame's top-left corner with its true
    (h, w) passed as data. ``engine`` is an `Engine` or a
    `core.quant.QuantizedEngine` (the float-resident int8 tier), whose
    module runs the int8 convs in place of the float ones.

    On a CUDA engine `__call__` replays one captured CUDA graph of `fused`
    per frames shape (`GraphRunner`); a capture or replay that fails
    raises. On a CPU engine it runs `fused` eagerly."""

    def __init__(self, engine: Engine, src_h: int, src_w: int,
                 bgr_to_rgb: bool = False):
        self.engine = engine
        self.src_h, self.src_w = src_h, src_w
        self.bgr_to_rgb = bgr_to_rgb
        # the captured programs on the card (None on the CPU)
        self.graphs = (GraphRunner(self.fused, engine.device)
                       if engine.device.type == "cuda" else None)

    def fused(self, frames: torch.Tensor, src_hw: torch.Tensor):
        """The device side: frames (B, H, W, 3) uint8 and src_hw (B, 2) int32
        on the engine's device → letterbox → the engine's module → the
        detection dict, or cls's logits (the JAX package's traceable
        ``_fused``)."""
        eng = self.engine
        with torch.inference_mode():
            x = letterbox_batch(frames, src_hw, eng.cfg.input_h, eng.cfg.input_w,
                                bgr_to_rgb=self.bgr_to_rgb)
            return eng.module(x.to(eng.dtype))

    def __call__(self, frames, src_hw=None):
        """frames (B, H, W, 3) uint8, src_hw (B, 2) [h, w] → the detection
        dict of device tensors (cls: the (B, num_classes) logits)."""
        return serve(self.fused, self.graphs, self.engine.device, frames, src_hw)

    def stream_fn(self, k: int) -> Callable:
        """``fn(frames (k, H, W, 3) uint8, src_hw (k, 2))`` → the detection
        dict of each frame served at batch 1, stacked (leaves (k, 1, …)):
        the JAX package's scan over k frames; on the card one CUDA graph of
        k batch-1 forwards."""
        return stream_runner(self.fused, k, self.engine.device)

    def warmup(self, batch: int = 1):
        """Serve a batch of zero frames; on the card this captures that
        batch's graph."""
        out = self(np.zeros((batch, self.src_h, self.src_w, 3), np.uint8))
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        return out

    def detect_images(self, images: Sequence[np.ndarray]) -> List[dict]:
        """List of HWC uint8 images (each within the bucket) → per-image
        detections mapped back to original pixel coords. Each image is
        written straight into its frame of the staging buffer (on the card
        the pinned one); the pixels of a frame outside its image keep
        whatever they held, which the letterbox never reads. A cls engine
        has no detections: serve it by ``__call__``."""
        if getattr(self.engine.cfg, "task", "det") == "cls":   # yolov10's cfg has no task
            raise ValueError("detect_images serves detection tasks; a cls engine returns "
                             "logits: call the pipeline instead")
        src_hw = np.array([im.shape[:2] for im in images], np.int32).reshape(-1, 2)

        def fill(frames, hw):
            for i, im in enumerate(images):
                frames[i, :im.shape[0], :im.shape[1]] = im
            hw[...] = src_hw

        out = serve_filled(self.fused, self.graphs, self.engine.device,
                           (len(images), self.src_h, self.src_w, 3), fill)
        return present_detections(out, src_hw, self.engine.cfg)


def present_detections(out: dict, src_hw, cfg) -> List[dict]:
    """Detection buffer (boxes/scores/classes/count) → per-image host dicts
    of numpy arrays, boxes mapped back to original pixel coords. Boxes,
    scores and classes only, as the JAX package presents them; obb's
    (cx, cy, w, h) go through the same xyxy mapping there too."""
    d = {k: out[k].cpu() for k in ("boxes", "scores", "classes", "count")}
    results = []
    for i in range(d["count"].shape[0]):
        n = int(d["count"][i])
        bx = scale_boxes_back(d["boxes"][i][:n], int(src_hw[i][0]),
                              int(src_hw[i][1]), cfg.input_h, cfg.input_w)
        results.append({
            "boxes": bx.numpy(),
            "scores": d["scores"][i][:n].numpy(),
            "classes": d["classes"][i][:n].numpy(),
        })
    return results


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_files_in_dir(path: str, exts=(".jpg", ".jpeg", ".png", ".bmp", ".pgm", ".ppm")):
    """Reference utils.h read_files_in_dir analog."""
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.lower().endswith(exts))


def cuda_event_ms(fn: Callable[[], object], iters: int = 20,
                  warmup: int = 3) -> List[float]:
    """Milliseconds of each of ``iters`` calls of fn, read from CUDA events
    recorded on the current stream before and after the call, after
    ``warmup`` untimed calls. A call that waits for the device (as
    `detect_images` does for its result) is timed whole."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _leaves(out) -> list:
    """The tensors of a result (a dict in key order, as `jax.tree.leaves`
    orders one, a list or tuple, or a tensor)."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return []


def _force(out):
    """Materialize a result: fetch a (tiny) leaf to the host, which waits for
    the work that made it."""
    leaf = _leaves(out)[-1]
    (leaf[..., :1] if leaf.dim() else leaf).cpu()


def bench_loop(fn, args_list, iters: int = 100, warmup: int = 5) -> dict:
    """Per-call latency: each call is fetched before the next starts
    (reference convention: wall-clock around enqueue + D2H,
    yolo11_det.cpp:91-109; warmup excluded)."""
    for i in range(warmup):
        _force(fn(*args_list[i % len(args_list)]))
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        _force(fn(*args_list[i % len(args_list)]))
        times.append(time.perf_counter() - t0)
    t = np.array(times)
    return {
        "mean_ms": float(t.mean() * 1e3),
        "p50_ms": float(np.percentile(t, 50) * 1e3),
        "p99_ms": float(np.percentile(t, 99) * 1e3),
    }


def bench_marginal(fn, args_list, n_small: int = 20, n_large: int = 120) -> dict:
    """Steady-state device throughput: queue N calls (distinct inputs),
    force one final fetch, and take the marginal time per extra call
    between two queue depths — cancels the fixed host round trip, so the
    number reflects what the card sustains while serving a request
    stream."""
    _force(fn(*args_list[0]))  # capture + warm

    def run(n):
        t0 = time.perf_counter()
        out = None
        for i in range(n):
            out = fn(*args_list[i % len(args_list)])
        _force(out)
        return time.perf_counter() - t0

    run(n_small)  # warm the queue path
    t_small = run(n_small)
    t_large = run(n_large)
    per_iter = (t_large - t_small) / (n_large - n_small)
    return {"iter_ms": per_iter * 1e3}

"""INT8 serving: both int8 tiers of the JAX package's
`tensorrtx_tpu/core/quant.py`, with their calibration and scale cache.

Analog of the reference's INT8 build (yolo11/src/calibrator.cpp:9-74,
Int8EntropyCalibrator2 feeding the builder): calibration batches stream
through the float network, activation statistics give per-tensor scales,
and the table is cached beside the engine (``int8calib.table`` there; here
``int8calib.json`` and ``int8chain.json`` in the JAX package's format, so
an engine dir crosses between the packages).

- Float-resident tier (`calibrate`, `QuantizedEngine`): activations stay
  float between layers; every non-grouped conv quantizes its input, runs
  int8×int8→int32 and dequantizes (`ops/quant_ctx.py`). Scales come from
  entropy (TensorRT-style KL), percentile or absmax calibration.
- Int8-resident tier (`ChainedInt8Engine`): activations stay int8 between
  the convs of a chain mirror (`ops/qchain.py`); absmax calibration.

Both tiers serve the det task (`check_int8_task`; yolo11 and yolov8 det,
the chained tier where the model has an `apply_chain`): the other tasks'
extra convs have no slot order held against the JAX package's scale table.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Iterable, List, Optional

import numpy as np
import torch

from tensorrtx_tpu_torch.core.engine import Engine
from tensorrtx_tpu_torch.core.runner import GraphRunner, check_frames, serve, stream_runner
from tensorrtx_tpu_torch.models._yolo_blocks import Conv
from tensorrtx_tpu_torch.ops.preprocess import letterbox_batch
from tensorrtx_tpu_torch.ops.qchain import ChainCtx, quantize_chain_weights
from tensorrtx_tpu_torch.ops.quant_ctx import ConvSlot, Taps

__all__ = ["check_int8_task", "calibrate", "entropy_scale", "percentile_scale",
           "save_scale_cache", "load_scale_cache", "QuantizedEngine", "ChainedInt8Engine",
           "weight_scales", "conv_weights", "HIST_BINS", "QUANT_BINS"]

HIST_BINS = 2048
QUANT_BINS = 128
METHODS = ("entropy", "percentile", "absmax")

_CHAIN_FILE = "int8chain.json"
_CALIB_FILE = "int8calib.json"


def entropy_scale(hist: np.ndarray, absmax: float) -> float:
    """TensorRT-style KL-divergence threshold search over a 2048-bin
    histogram of |x| with range [0, absmax]; returns scale = T / 127."""
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0 or absmax == 0:
        return max(absmax / 127.0, 1e-8)
    bin_w = absmax / HIST_BINS
    best_kl, best_i = np.inf, HIST_BINS
    for i in range(QUANT_BINS, HIST_BINS + 1, 8):
        p = hist[:i].copy()
        outliers = hist[i:].sum()
        p[-1] += outliers
        if p.sum() == 0:
            continue
        # quantize p into QUANT_BINS chunks (`np.array_split`'s: the first
        # i % QUANT_BINS one bin longer), then expand back: each nonzero bin
        # takes its chunk's mean over the nonzero bins. The counts are
        # whole numbers, so the chunk sums are exact in any order.
        sizes = np.full(QUANT_BINS, i // QUANT_BINS)
        sizes[:i % QUANT_BINS] += 1
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        sums = np.add.reduceat(p, starts)
        nz = np.add.reduceat((p > 0).astype(np.int64), starts)
        mean = np.divide(sums, nz, out=np.zeros_like(sums), where=nz > 0)
        q = np.where(p > 0, np.repeat(mean, sizes), 0.0)
        pm = p / p.sum()
        qm = q / max(q.sum(), 1e-12)
        mask = pm > 0
        kl = float(np.sum(pm[mask] * np.log(pm[mask] / np.maximum(qm[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_i = kl, i
    threshold = (best_i + 0.5) * bin_w
    return max(threshold / 127.0, 1e-8)


def percentile_scale(hist: np.ndarray, absmax: float, pct: float = 99.99) -> float:
    c = np.cumsum(hist.astype(np.float64))
    if c[-1] == 0:
        return max(absmax / 127.0, 1e-8)
    idx = int(np.searchsorted(c, c[-1] * pct / 100.0))
    return max((idx + 0.5) * absmax / HIST_BINS / 127.0, 1e-8)


def _slotted_copy(engine: Engine, dtype) -> tuple:
    """A copy of the engine's module in `dtype` whose every `Conv` holds a
    `ConvSlot`, indexed by the order in which one forward on zeros calls
    them (forward pre-hooks, the counterpart of the JAX weight spy
    `_conv_weights`). Returns (module, the Convs in that order)."""
    module = copy.deepcopy(engine.module).to(dtype)
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, args: calls.append((m, args[0].shape[1])))
             for m in module.modules() if isinstance(m, Conv)]
    h, w, c = engine.model.input_shape(engine.cfg)
    try:
        with torch.inference_mode():
            module(torch.zeros((1, h, w, c), dtype=dtype, device=engine.device))
    finally:
        for hk in hooks:
            hk.remove()
    if len({id(m) for m, _ in calls}) != len(calls):
        raise ValueError(f"{engine.name}: a Conv runs twice in one forward; the int8 "
                         "tier's slots are one per Conv")
    for i, (m, c_in) in enumerate(calls):
        m.slot = ConvSlot(i, depthwise=c_in != m.w.shape[1])
    return module, [m for m, _ in calls]


def conv_weights(engine: Engine) -> List[np.ndarray]:
    """Conv weights in trace order as float32 HWIO arrays (the JAX
    package's `_conv_weights`, upcast from the engine's dtype)."""
    _, convs = _slotted_copy(engine, engine.dtype)
    return [_hwio(m.w) for m in convs]


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().float().permute(2, 3, 1, 0).cpu().numpy()


def weight_scales(engine: Engine,
                  ws: Optional[List[np.ndarray]] = None) -> List[np.ndarray]:
    """Per-conv per-output-channel |w|max/127 in conv trace order."""
    if ws is None:
        ws = conv_weights(engine)
    return [np.maximum(np.abs(w.astype(np.float32)).max(axis=(0, 1, 2)) / 127.0,
                       1e-8) for w in ws]


def check_int8_task(engine: Engine) -> None:
    """Refuse an engine whose task is not det. A seg, pose or obb network
    has convs (cv4, proto) whose place among the int8 slots was never held
    against the JAX package's scale table, so a table from either package
    could load onto the wrong convs without an error; cls has no detection
    tail."""
    task = getattr(engine.cfg, "task", "det")
    if task != "det":
        raise NotImplementedError(f"{engine.name}: the int8 tiers serve the det task, "
                                  f"not {task!r}")


def calibrate(engine: Engine, batches: Iterable, method: str = "entropy") -> np.ndarray:
    """Run calibration batches through the float32 graph; return per-conv
    input scales (trace order, one per conv, depthwise included).
    ``batches``: NHWC float arrays or tensors, already preprocessed, as the
    reference streams them (calibrator.cpp:33-56). Two passes, as in the
    JAX package: |x|max of every conv input over all batches, then (entropy
    and percentile) 2048-bin histograms of |x| over [0, |x|max]."""
    check_int8_task(engine)
    if method not in METHODS:
        raise ValueError(f"unknown calibration method {method!r}; one of {METHODS}")
    batches = list(batches)
    if not batches:
        raise ValueError("calibrate() received no batches")
    module, convs = _slotted_copy(engine, torch.float32)

    def tap_pass(ranges) -> List[List[np.ndarray]]:
        out = []
        for b in batches:
            taps = Taps(len(convs), ranges, HIST_BINS)
            x = torch.as_tensor(b).to(device=engine.device, dtype=torch.float32)
            for m in convs:
                m.slot.taps = taps
            try:
                with torch.inference_mode():
                    module(x)
            finally:
                for m in convs:
                    m.slot.taps = None
            out.append([v.cpu().numpy() for v in taps.values])
        return out

    # pass 1: absmax per layer across all batches
    absmax = None
    for taps in tap_pass(None):
        cur = np.array(taps)
        absmax = cur if absmax is None else np.maximum(absmax, cur)
    if method == "absmax":
        return np.maximum(absmax / 127.0, 1e-8)

    # pass 2: histograms at fixed ranges
    hists = None
    for taps in tap_pass(absmax):
        hists = taps if hists is None else [h + t for h, t in zip(hists, taps)]

    chooser = entropy_scale if method == "entropy" else percentile_scale
    return np.array([chooser(h, float(a)) for h, a in zip(hists, absmax)],
                    np.float32)


def save_scale_cache(path: str, act_scales, meta: dict = None):
    """The int8calib.table analog (calibrator.cpp:58-74)."""
    with open(path, "w") as f:
        json.dump({"format": "tensorrtx-tpu-int8-v1",
                   "act_scales": np.asarray(act_scales, np.float32).tolist(),
                   "meta": meta or {}}, f)


def load_scale_cache(path: str) -> np.ndarray:
    with open(path) as f:
        d = json.load(f)
    return np.asarray(d["act_scales"], np.float32)


# (kernel size, stride) of the convs the tier's int8 kernels take
_INT8_CONVS = ((3, 1), (3, 2), (1, 1))


class QuantizedEngine:
    """Engine whose non-grouped convs run the int8 path; depthwise convs
    stay in float.

    The int8 convs' weights are quantized once here, per output channel at
    |w|max/127 (round half to even), and kept on the device as OHWI int8
    in each conv's slot (`slots()`). Every
    non-grouped conv then quantizes its input at its calibrated scale sx
    (``x / sx``, the `quantize_int8` kernel), runs int8×int8→int32 with a
    float exit ``acc·(sx·sw) + b`` in the engine's dtype (the `qconv3x3` /
    `qconv1x1` kernels) and applies its SiLU in float. `ServingPipeline`
    serves it as it serves an `Engine` (``module``, ``dtype``, ``device``,
    ``cfg``). fp32 and bf16 engines are served; fp16 raises, the int8
    kernels having no fp16 float exit. Serializes beside the float engine
    (``int8calib.json``, ``meta["int8"]``), so `load_engine` and the JAX
    package's `load_engine` reload it.
    """

    def __init__(self, engine: Engine, act_scales):
        check_int8_task(engine)
        if engine.dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"the int8 tier serves fp32 and bf16 engines; "
                                      f"{engine.precision} has no int8 float exit")
        self.engine = engine
        self.model, self.cfg, self.name = engine.model, engine.cfg, engine.name
        self.precision = "int8"
        self.dtype, self.device = engine.dtype, engine.device
        self.module, convs = _slotted_copy(engine, engine.dtype)
        s = np.asarray(act_scales, np.float32)
        if s.shape != (len(convs),):
            raise ValueError(f"{self.name}: the network has {len(convs)} conv slots, "
                             f"the scale table {s.shape}")
        self.act_scales = s
        ws = [_hwio(m.w) for m in convs]
        # every slot has a weight scale, so the table lines up with the
        # JAX package's; only the int8 convs' weights are quantized
        self.w_scales = weight_scales(engine, ws)
        for m, w, sw in zip(convs, ws, self.w_scales):
            if m.slot.depthwise:
                continue
            if (w.shape[0], m.stride) not in _INT8_CONVS:
                raise NotImplementedError(f"no int8 kernel for a {w.shape[0]}×{w.shape[1]} "
                                          f"conv at stride {m.stride}")
            wq = np.clip(np.round(w / sw[None, None, None, :]), -127, 127).astype(np.int8)
            sx = self.act_scales[m.slot.index]
            m.slot.set_run(torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
                           .to(self.device),
                           torch.from_numpy(sx * sw).to(self.device),
                           torch.tensor(sx, device=self.device),
                           None if m.b is None else m.b.float())

    def slots(self) -> List[ConvSlot]:
        """The conv slots in trace order, depthwise ones included."""
        return sorted((m.slot for m in self.module.modules() if isinstance(m, Conv)),
                      key=lambda sl: sl.index)

    def __call__(self, x):
        """x: (B, H, W, C) NHWC frames, preprocessed (numpy or tensor)."""
        x = torch.as_tensor(x).to(self.device)
        if x.is_floating_point():
            x = x.to(self.dtype)
        with torch.inference_mode():
            return self.module(x)

    def save(self, path: str) -> None:
        self.engine.save(path)
        save_scale_cache(os.path.join(path, _CALIB_FILE), self.act_scales,
                         {"model": self.engine.name})
        # flag the engine dir as int8 so load_engine reconstructs this class
        meta_path = os.path.join(path, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["int8"] = True
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=1)

    @staticmethod
    def load(path: str, device="cuda") -> "QuantizedEngine":
        eng = Engine.load(path, device)
        return QuantizedEngine(eng, load_scale_cache(os.path.join(path, _CALIB_FILE)))


class ChainedInt8Engine:
    """Int8-resident serving engine: activations between the convs are
    int8 on the device.

    Built on a model's `apply_chain` mirror (ops/qchain.py): every conv is
    int8×int8→int32 with a fused dequant + bias + act + requant epilogue,
    in the CUDA kernels of `ops/cuda/qconv.py` on the card. The serving
    contract is `ServingPipeline`'s: uint8 frames → letterbox → chain →
    the detection dict.

    One tap pass on zeros at construction collects the conv weights, which
    are quantized per output channel; `calibrate()` then streams uint8
    frame batches through the tap pass to set the activation scales
    (absmax/127 per production point). `dtype` is the float islands' type
    (bfloat16 as in the JAX package; float32 for parity checks): the
    modules the chain calls in float (``apply_chain.float_modules``) run in
    it, the rest keep the engine's precision for their biases.

    ``fold`` is the JAX package's batch-fold factor. It is recorded, so
    engine dirs cross between the packages, but the port computes
    unfolded: any batch ≥ 1 serves, as the JAX package's fold 1 does.
    """

    def __init__(self, engine: Engine, bgr_to_rgb: bool = False, fold: int = 2,
                 enter: str = ChainCtx.DEFAULT_ENTER, dtype=torch.bfloat16):
        check_int8_task(engine)
        model, cfg = engine.model, engine.cfg
        chain = model.apply_chain
        if chain is None or not chain.supports(cfg):
            raise ValueError(f"{engine.name}: no chained int8 path for this cfg")
        self.engine = engine
        self.model, self.cfg, self.name = model, cfg, engine.name
        self.chain = chain
        self.precision = "int8_chained"
        self.bgr_to_rgb = bgr_to_rgb
        folds = getattr(chain, "folds", (1, 2))
        self.fold = fold if fold in folds else max(folds)
        self.enter = enter
        self.dtype = dtype
        self.device = engine.device
        self.module = copy.deepcopy(engine.module)
        for name in chain.float_modules:
            self.module.get_submodule(name).to(dtype)
        h, w, _ = model.input_shape(cfg)
        self._dst = (h, w)

        ctx = self._ctx("tap")
        with torch.inference_mode():
            chain(self.module, torch.zeros((1, h, w, 3), dtype=dtype, device=self.device),
                  cfg, ctx)
        self.n_scales = ctx.n_scales
        wq, sw = quantize_chain_weights(ctx.ws, ctx.w_is_dw)
        self.wq = [t.to(self.device) for t in wq]
        self.sw = [t.to(self.device) for t in sw]
        self.act_scales: Optional[np.ndarray] = None
        self._scales: Optional[torch.Tensor] = None
        # the captured programs of `raw_serve` on the card (None on the CPU)
        self.graphs = (GraphRunner(self.raw_serve, self.device)
                       if self.device.type == "cuda" else None)

    def _ctx(self, mode: str, **kw) -> ChainCtx:
        return ChainCtx(mode, dtype=self.dtype, enter=self.enter, **kw)

    def _letterbox(self, frames: torch.Tensor, src_hw: torch.Tensor) -> torch.Tensor:
        return letterbox_batch(frames, src_hw, *self._dst,
                               bgr_to_rgb=self.bgr_to_rgb).to(self.dtype)

    def _input(self, frames) -> torch.Tensor:
        """Host frames (B, H, W, 3) uint8, each image the whole frame → the
        letterboxed chain input on the device (the calibration batches)."""
        frames = torch.as_tensor(frames, dtype=torch.uint8)
        b, h, w, _ = check_frames(frames.shape)
        src_hw = torch.tensor([[h, w]] * b, dtype=torch.int32)
        return self._letterbox(frames.to(self.device), src_hw.to(self.device))

    def calibrate(self, frame_batches: Iterable[np.ndarray]) -> np.ndarray:
        """frame_batches: uint8 (B, H, W, 3) arrays (true size = frame
        size). Returns and keeps the (n_scales,) float32 scales."""
        absmax = None
        for fr in frame_batches:
            ctx = self._ctx("tap")
            with torch.inference_mode():
                self.chain(self.module, self._input(fr), self.cfg, ctx)
            cur = torch.stack(ctx.taps).cpu().numpy().astype(np.float32)
            absmax = cur if absmax is None else np.maximum(absmax, cur)
        if absmax is None:
            raise ValueError("calibrate() received no frame batches — pass at least "
                             "one uint8 (B, H, W, 3) array")
        self.set_scales(np.maximum(absmax / np.float32(127.0), np.float32(1e-8)))
        return self.act_scales

    def set_scales(self, act_scales) -> None:
        """Install a calibrated scale table (one float32 per slot). A table
        already installed is overwritten in place, so the CUDA graphs
        captured before read the new scales."""
        s = np.asarray(act_scales, np.float32)
        if s.shape != (self.n_scales,):
            raise ValueError(f"{self.name}: the chain has {self.n_scales} scale slots, "
                             f"the table {s.shape}")
        self.act_scales = s
        if self._scales is None:
            self._scales = torch.from_numpy(s.copy()).to(self.device)
        else:
            self._scales.copy_(torch.from_numpy(s.copy()))

    def raw_serve(self, frames: torch.Tensor, src_hw: torch.Tensor) -> dict:
        """The device side: frames (B, H, W, 3) uint8 and src_hw (B, 2) int32
        on the engine's device → letterbox → the int8 chain → the detection
        dict (the JAX package's traceable ``raw_serve``)."""
        if self._scales is None:
            raise ValueError("call calibrate() (or load a calibrated dir) first")
        ctx = self._ctx("run", scales=self._scales, wq=self.wq, sw=self.sw)
        with torch.inference_mode():
            return self.chain(self.module, self._letterbox(frames, src_hw), self.cfg, ctx)

    def __call__(self, frames, src_hw=None):
        """frames (B, H, W, 3) uint8 in one bucket, src_hw (B, 2) [h, w] of
        each image in its frame's top-left corner → the detection dict of
        device tensors (`core.runner.present_detections` maps it back). On
        the card: one captured CUDA graph of `raw_serve` per frames shape,
        the frames staged through a pinned buffer (`core.runner.GraphRunner`);
        on the CPU, `raw_serve` eagerly."""
        if self._scales is None:
            raise ValueError("call calibrate() (or load a calibrated dir) first")
        return serve(self.raw_serve, self.graphs, self.device, frames, src_hw)

    def stream_fn(self, k: int):
        """``fn(frames (k, H, W, 3) uint8, src_hw (k, 2))`` → each frame
        served at batch 1, the outputs stacked (`ServingPipeline.stream_fn`);
        on the card one CUDA graph of k batch-1 chain forwards."""
        return stream_runner(self.raw_serve, k, self.device)

    def save(self, path: str) -> None:
        if self.act_scales is None:
            raise ValueError("save() before calibrate(): the chained engine "
                             "has no activation scales to serialize")
        self.engine.save(path)
        save_scale_cache(os.path.join(path, _CHAIN_FILE), self.act_scales,
                         {"model": self.name, "tier": "chained", "fold": self.fold,
                          "enter": self.enter, "bgr_to_rgb": self.bgr_to_rgb})

    @staticmethod
    def load(path: str, device="cuda", dtype=torch.bfloat16) -> "ChainedInt8Engine":
        eng = Engine.load(path, device)
        with open(os.path.join(path, _CHAIN_FILE)) as fh:
            meta = json.load(fh).get("meta", {})
        ce = ChainedInt8Engine(eng, bgr_to_rgb=meta.get("bgr_to_rgb", False),
                               fold=meta.get("fold", 2),
                               enter=meta.get("enter", ChainCtx.DEFAULT_ENTER),
                               dtype=dtype)
        ce.set_scales(load_scale_cache(os.path.join(path, _CHAIN_FILE)))
        return ce

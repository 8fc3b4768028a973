"""Chained int8 serving: the int8-resident tier of the JAX package's
`tensorrtx_tpu/core/quant.py` (`ChainedInt8Engine`, the scale cache).

Analog of the reference's INT8 build (yolo11/src/calibrator.cpp:9-74,
Int8EntropyCalibrator2 feeding the builder): calibration batches stream
through the float chain, each production point keeps its |x|max, scales
are absmax/127, and the table is cached beside the engine
(``int8calib.table`` there, ``int8chain.json`` here, in the JAX package's
format so an engine dir crosses between the packages).

The float-resident tier (`QuantizedEngine`, entropy/percentile
calibration) is not ported.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Iterable, Optional

import numpy as np
import torch

from tensorrtx_tpu_torch.core.engine import Engine
from tensorrtx_tpu_torch.ops.preprocess import letterbox_batch
from tensorrtx_tpu_torch.ops.qchain import ChainCtx, quantize_chain_weights

__all__ = ["save_scale_cache", "load_scale_cache", "ChainedInt8Engine"]

_CHAIN_FILE = "int8chain.json"


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

    def _ctx(self, mode: str, **kw) -> ChainCtx:
        return ChainCtx(mode, dtype=self.dtype, enter=self.enter, **kw)

    def _input(self, frames, src_hw) -> torch.Tensor:
        frames = torch.as_tensor(frames, dtype=torch.uint8)
        if frames.dim() != 4 or frames.shape[-1] != 3 or frames.shape[0] < 1:
            raise ValueError(f"expected (B, H, W, 3) uint8 frames with B >= 1, got "
                             f"shape {tuple(frames.shape)}")
        b = frames.shape[0]
        if src_hw is None:
            src_hw = np.tile([[frames.shape[1], frames.shape[2]]], (b, 1))
        src_hw = torch.as_tensor(np.asarray(src_hw, np.int32)).to(self.device)
        x = letterbox_batch(frames.to(self.device), src_hw, *self._dst,
                            bgr_to_rgb=self.bgr_to_rgb)
        return x.to(self.dtype)

    def calibrate(self, frame_batches: Iterable[np.ndarray]) -> np.ndarray:
        """frame_batches: uint8 (B, H, W, 3) arrays (true size = frame
        size). Returns and keeps the (n_scales,) float32 scales."""
        absmax = None
        for fr in frame_batches:
            ctx = self._ctx("tap")
            with torch.inference_mode():
                self.chain(self.module, self._input(fr, None), self.cfg, ctx)
            cur = torch.stack(ctx.taps).cpu().numpy().astype(np.float32)
            absmax = cur if absmax is None else np.maximum(absmax, cur)
        if absmax is None:
            raise ValueError("calibrate() received no frame batches — pass at least "
                             "one uint8 (B, H, W, 3) array")
        self.set_scales(np.maximum(absmax / np.float32(127.0), np.float32(1e-8)))
        return self.act_scales

    def set_scales(self, act_scales) -> None:
        """Install a calibrated scale table (one float32 per slot)."""
        s = np.asarray(act_scales, np.float32)
        if s.shape != (self.n_scales,):
            raise ValueError(f"{self.name}: the chain has {self.n_scales} scale slots, "
                             f"the table {s.shape}")
        self.act_scales = s
        self._scales = torch.from_numpy(s.copy()).to(self.device)

    def __call__(self, frames, src_hw=None):
        """frames (B, H, W, 3) uint8 in one bucket, src_hw (B, 2) [h, w] of
        each image in its frame's top-left corner → the detection dict of
        device tensors (`core.runner.present_detections` maps it back)."""
        if self._scales is None:
            raise ValueError("call calibrate() (or load a calibrated dir) first")
        ctx = self._ctx("run", scales=self._scales, wq=self.wq, sw=self.sw)
        with torch.inference_mode():
            return self.chain(self.module, self._input(frames, src_hw), self.cfg, ctx)

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

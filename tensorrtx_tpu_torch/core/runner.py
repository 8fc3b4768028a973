"""Serving runner — the inference driver loop on the card.

The reference's loop (yolo11/yolo11_det.cpp:218-252) is imread → H2D →
preprocess kernel → enqueue → decode/NMS kernels → D2H → CPU finishing.
Here the host hands over raw uint8 frames and gets back the fixed-size
detection buffer; letterbox, network, decode, top-k and NMS all run on the
engine's device, the NMS keep mask in the hand-written CUDA kernel.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tensorrtx_tpu_torch.core.engine import Engine
from tensorrtx_tpu_torch.ops.preprocess import letterbox_batch, scale_boxes_back

__all__ = ["ServingPipeline", "present_detections", "load_image",
           "read_files_in_dir", "cuda_event_ms"]


class ServingPipeline:
    """uint8 frames → detections on the engine's device.

    Frames share one static source bucket (src_h, src_w); an image smaller
    than the bucket sits in its frame's top-left corner with its true
    (h, w) passed as data. ``engine`` is an `Engine` or a
    `core.quant.QuantizedEngine` (the float-resident int8 tier), whose
    module runs the int8 convs in place of the float ones."""

    def __init__(self, engine: Engine, src_h: int, src_w: int,
                 bgr_to_rgb: bool = False):
        self.engine = engine
        self.src_h, self.src_w = src_h, src_w
        self.bgr_to_rgb = bgr_to_rgb

    def __call__(self, frames, src_hw: Optional[np.ndarray] = None):
        """frames (B, src_h, src_w, 3) uint8, src_hw (B, 2) [h, w] → the
        detection dict of device tensors."""
        eng = self.engine
        b = frames.shape[0]
        if src_hw is None:
            src_hw = np.tile([[frames.shape[1], frames.shape[2]]], (b, 1))
        frames = torch.as_tensor(frames, dtype=torch.uint8).to(eng.device)
        src_hw = torch.as_tensor(np.asarray(src_hw, np.int32)).to(eng.device)
        with torch.inference_mode():
            x = letterbox_batch(frames, src_hw, eng.cfg.input_h, eng.cfg.input_w,
                                bgr_to_rgb=self.bgr_to_rgb)
            return eng.module(x.to(eng.dtype))

    def warmup(self, batch: int = 1):
        out = self(np.zeros((batch, self.src_h, self.src_w, 3), np.uint8))
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        return out

    def detect_images(self, images: Sequence[np.ndarray]) -> List[dict]:
        """List of HWC uint8 images (each within the bucket) → per-image
        detections mapped back to original pixel coords."""
        b = len(images)
        frames = np.zeros((b, self.src_h, self.src_w, 3), np.uint8)
        src_hw = np.zeros((b, 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            frames[i, :h, :w] = im
            src_hw[i] = (h, w)
        out = self(frames, src_hw)
        return present_detections(out, src_hw, self.engine.cfg)


def present_detections(out: dict, src_hw, cfg) -> List[dict]:
    """Detection buffer (boxes/scores/classes/count) → per-image host dicts
    of numpy arrays, boxes mapped back to original pixel coords."""
    d = {k: v.cpu() for k, v in out.items()}
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

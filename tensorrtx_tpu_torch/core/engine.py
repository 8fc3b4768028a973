"""Engine lifecycle: build ≙ `-s`, load+run ≙ `-d`.

Reference analog (SURVEY.md L3, yolo11/yolo11_det.cpp:16-60): .wts → weight
map → graph → serialized engine; then deserialize → execute.

Here: .wts → WeightMap → numpy HWIO param tree (BN folded) → module state
(OIHW, cast once to the engine's dtype) on an explicit device. An engine
dir holds ``params.npz`` (the flat HWIO tree) and ``meta.json`` in the JAX
package's format (``none_paths``, ``format_version: 1``), so a dir saved by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from tensorrtx_tpu_torch.core.convert import params_from_jax, params_to_jax
from tensorrtx_tpu_torch.core.params import WeightMap, resolve_dtype
from tensorrtx_tpu_torch.core.registry import get_model
from tensorrtx_tpu_torch.core.wts import load_wts

__all__ = ["Engine", "build_engine", "load_engine"]

_META_FILE = "meta.json"
_PARAMS_FILE = "params.npz"


class Engine:
    """A model's module with its config, precision and device."""

    def __init__(self, name: str, params, cfg, precision: str = "fp32",
                 device="cuda"):
        """params: OIHW tensor tree (`params_from_jax` of a param tree).
        The engine lives on the card unless the caller passes
        ``device="cpu"``."""
        self.name = name
        self.model = get_model(name)
        self.cfg = cfg
        self.precision = precision
        self.dtype = resolve_dtype(precision)
        self.device = torch.device(device)
        self.module = self.model.module(cfg, params).to(
            device=self.device, dtype=self.dtype,
            memory_format=torch.channels_last).eval()

    def __call__(self, x):
        """x: (B, H, W, C) NHWC frames (numpy or tensor). Floating inputs are
        cast to the engine's dtype (weights follow activations)."""
        x = torch.as_tensor(x).to(self.device)
        if x.is_floating_point():
            x = x.to(self.dtype)
        with torch.inference_mode():
            return self.module(x)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        flat, none_paths = params_to_jax(self.module)
        np.savez(os.path.join(path, _PARAMS_FILE), **flat)
        meta = {
            "name": self.name,
            "precision": self.precision,
            "cfg": dataclasses.asdict(self.cfg),
            "none_paths": none_paths,
            "format_version": 1,
        }
        with open(os.path.join(path, _META_FILE), "w") as f:
            json.dump(meta, f, indent=1)

    @staticmethod
    def load(path: str, device="cuda") -> "Engine":
        """The float engine of a dir (an int8 dir's too; `load_engine`
        rebuilds the int8 engine around it)."""
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        model = get_model(meta["name"])
        cfg = model.default_cfg()
        names = {f.name for f in dataclasses.fields(cfg)}
        cfg = dataclasses.replace(
            cfg, **{k: v for k, v in meta["cfg"].items() if k in names})
        with np.load(os.path.join(path, _PARAMS_FILE)) as data:
            tree = _unflatten(dict(data), meta.get("none_paths", ()))
        return Engine(meta["name"], params_from_jax(tree), cfg,
                      meta["precision"], device)


def _unflatten(flat: Dict[str, np.ndarray], none_paths=()):
    """Flat ``"a/b/0/w"`` keys (+ the paths of None leaves) → nested dicts,
    with all-digit levels as lists (the JAX package's `_unflatten`)."""
    root: Dict[str, Any] = {}
    for key in list(none_paths) + list(flat.keys()):
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat.get(key)

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def build_engine(name: str, wts_path: str, precision: str = "fp32", cfg=None,
                 device="cuda", **cfg_overrides) -> Engine:
    """.wts → Engine (the `-s` mode)."""
    model = get_model(name)
    if cfg is None:
        cfg = model.default_cfg()
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    tree = model.build_params(WeightMap(load_wts(wts_path)), cfg)
    return Engine(name, params_from_jax(tree), cfg, precision, device)


def load_engine(path: str, device="cuda"):
    """Load an engine dir; int8-flagged dirs come back as a
    `core.quant.QuantizedEngine`."""
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    if meta.get("int8"):
        from tensorrtx_tpu_torch.core.quant import QuantizedEngine

        return QuantizedEngine.load(path, device)
    return Engine.load(path, device)

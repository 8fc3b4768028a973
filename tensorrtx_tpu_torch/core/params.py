"""Weight map → structured numpy parameter trees.

The reference keeps weights as a flat ``map<string, Weights>`` and each graph
builder reshapes them at layer-insertion time (yolo11/src/block.cpp:10-38).
Like the JAX package, the builders here fold BatchNorm into the preceding
conv's weight and bias and return numpy arrays in HWIO, so a tree built here
is byte-equal to the JAX package's. `core.convert.params_from_jax` turns it
into the module state (OIHW torch tensors).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["WeightMap", "ConvParams", "resolve_dtype"]


def resolve_dtype(precision: str) -> torch.dtype:
    p = precision.lower()
    if p in ("fp32", "float32", "f32"):
        return torch.float32
    if p in ("bf16", "bfloat16"):
        return torch.bfloat16
    if p in ("fp16", "float16", "f16"):
        return torch.float16
    raise ValueError(f"unknown precision {precision!r}")


def ConvParams(w, b):
    """A folded conv: {'w': HWIO array, 'b': (O,) array or None}."""
    return {"w": w, "b": b}


class WeightMap:
    """Flat name→flat-float32 map with typed, shaped accessors returning
    numpy arrays."""

    def __init__(self, raw: Dict[str, np.ndarray]):
        self.raw = raw
        self.used: set = set()

    def __contains__(self, name: str) -> bool:
        return name in self.raw

    def get_flat(self, name: str) -> np.ndarray:
        if name not in self.raw:
            raise KeyError(
                f"weight {name!r} not found in .wts "
                f"(have {len(self.raw)} tensors; nearby: "
                f"{[k for k in self.raw if k.startswith(name.rsplit('.', 1)[0])][:8]})")
        self.used.add(name)
        return self.raw[name]

    def tensor(self, name: str, shape: Tuple[int, ...]) -> np.ndarray:
        flat = self.get_flat(name)
        if flat.size != int(np.prod(shape)):
            raise ValueError(f"{name}: expected {shape} ({int(np.prod(shape))}), got {flat.size}")
        return flat.reshape(shape)

    def conv2d(self, name: str, out_c: int, in_c: int, k: Tuple[int, int],
               groups: int = 1, bias: bool = True):
        """Plain conv. Weight ``{name}.weight`` OIHW → HWIO; optional bias."""
        w = self.tensor(f"{name}.weight", (out_c, in_c // groups, k[0], k[1]))
        w = np.transpose(w, (2, 3, 1, 0))
        b = None
        if bias and f"{name}.bias" in self.raw:
            b = self.tensor(f"{name}.bias", (out_c,))
        return ConvParams(w=w, b=b)

    def bn(self, name: str, ch: int, eps: float) -> Tuple[np.ndarray, np.ndarray]:
        """BatchNorm folded to (scale, shift): scale = gamma / sqrt(var + eps),
        shift = beta - mean * scale (yolo11/src/block.cpp:40-72)."""
        gamma = self.tensor(f"{name}.weight", (ch,))
        beta = self.tensor(f"{name}.bias", (ch,))
        mean = self.tensor(f"{name}.running_mean", (ch,))
        var = self.tensor(f"{name}.running_var", (ch,))
        scale = gamma / np.sqrt(var + eps)
        shift = beta - mean * scale
        return scale, shift

    def conv_bn(self, conv_name: str, bn_name: str, out_c: int, in_c: int,
                k: Tuple[int, int], groups: int = 1, eps: float = 1e-3):
        """Conv + BN folded into one conv weight/bias (a conv bias, when
        present in the checkpoint, folds through the BN: b' = b·s + shift)."""
        p = self.conv2d(conv_name, out_c, in_c, k, groups=groups, bias=True)
        scale, shift = self.bn(bn_name, out_c, eps)
        w = p["w"] * scale[None, None, None, :]
        b = shift if p["b"] is None else p["b"] * scale + shift
        return ConvParams(w=w, b=b)

    def linear(self, name: str, out_f: int, in_f: int, bias: bool = True) -> dict:
        """torch Linear: weight (out, in), stored transposed (in, out) as the
        JAX package stores it; optional bias."""
        w = self.tensor(f"{name}.weight", (out_f, in_f)).T.copy()
        b = self.tensor(f"{name}.bias", (out_f,)) if bias and f"{name}.bias" in self.raw else None
        return {"w": w, "b": b}

    def vec(self, name: str, n: int) -> np.ndarray:
        return self.tensor(name, (n,))

    def unused(self):
        return sorted(set(self.raw) - self.used)

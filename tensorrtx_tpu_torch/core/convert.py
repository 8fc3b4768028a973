"""The weight carrier between the two layouts.

Parameter trees are built (and engine dirs stored) as the JAX package
builds them: nested dicts and lists of numpy arrays with conv kernels in
HWIO. The modules hold PyTorch's OIHW. This module is the one place where
the layout changes hands, in both directions.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax", "params_to_jax", "chain_weights_from_jax"]


def _leaf_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":
        # bfloat16 leaves of a JAX tree come as an ml_dtypes extension type
        a = a.astype(np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO → OIHW
    return torch.from_numpy(np.ascontiguousarray(a))


def params_from_jax(tree):
    """Numpy HWIO tree (nested dicts/lists, None leaves kept) → the same
    structure of torch tensors with conv kernels in OIHW."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    return _leaf_to_torch(tree)


def params_to_jax(module: nn.Module) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Module state → (``"a/b/0/w"`` → float32 HWIO array, [paths of None
    leaves]): the flat form of the JAX param tree that engine dirs store."""
    flat: Dict[str, np.ndarray] = {}
    none_paths: List[str] = []
    for mname, m in module.named_modules():
        for bname, t in m._buffers.items():
            key = f"{mname}/{bname}".replace(".", "/").lstrip("/")
            if t is None:
                none_paths.append(key)
                continue
            a = t.detach().cpu().float().numpy()
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)  # OIHW → HWIO
            flat[key] = np.ascontiguousarray(a)
    return flat, none_paths


def chain_weights_from_jax(wq, sw):
    """The JAX package's quantized chain weights (`quantize_chain_weights`)
    → the port's: int8 HWIO → int8 OHWI (the qconv kernels' layout), and a
    depthwise conv's float HWIO (k, k, 1, C) → OIHW (C, 1, k, k) in
    bfloat16, the type both packages keep it in. Scales become float32
    tensors. Returns (wq, sw) as CPU tensors."""
    out_q, out_s = [], []
    for w, s in zip(wq, sw):
        w = np.asarray(w)
        if w.dtype == np.int8:
            out_q.append(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2))))
        else:
            w = np.ascontiguousarray(w.astype(np.float32).transpose(3, 2, 0, 1))
            out_q.append(torch.from_numpy(w).to(torch.bfloat16))
        out_s.append(torch.from_numpy(np.asarray(s, np.float32).copy()))
    return out_q, out_s

"""Model registry: name → ModelDef.

A ModelDef is pure data: a param builder (WeightMap → numpy HWIO tree, the
engine-dir format shared with the JAX package), a module factory
((cfg, OIHW tensor tree) → nn.Module whose forward takes NHWC frames) and,
where the model has one, its int8 chain mirror (`core.quant.ChainedInt8Engine`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

__all__ = ["ModelDef", "register", "get_model", "list_models"]

_REGISTRY: Dict[str, "ModelDef"] = {}


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    build_params: Callable[..., Any]          # (WeightMap, cfg) -> numpy tree
    module: Callable[..., Any]                # (cfg, tensor tree) -> nn.Module
    default_cfg: Callable[[], Any]            # () -> cfg dataclass
    input_shape: Callable[[Any], tuple]       # cfg -> (H, W, C)
    # (module, x, cfg, ctx) -> outputs: the int8-resident chain mirror
    apply_chain: Optional[Callable[..., Any]] = None
    doc: str = ""


def register(model_def: ModelDef) -> ModelDef:
    _REGISTRY[model_def.name] = model_def
    return model_def


def get_model(name: str) -> ModelDef:
    if name not in _REGISTRY:
        from tensorrtx_tpu_torch import models

        models.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models():
    from tensorrtx_tpu_torch import models

    models.load_all()
    return sorted(_REGISTRY)

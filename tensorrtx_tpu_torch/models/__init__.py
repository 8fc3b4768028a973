"""Model catalog. Each module registers its ModelDef on import."""

import importlib

# Modules that register models on import; the port grows this list slice
# by slice.
_MODULES = ["yolo11", "yolov8", "yolov10", "yolo26"]


def load_all():
    for m in _MODULES:
        importlib.import_module(f"tensorrtx_tpu_torch.models.{m}")

"""tensorrtx_tpu_torch — the PyTorch/CUDA port of tensorrtx_tpu for NVIDIA
Hopper (H100).

The JAX package `tensorrtx_tpu` stays as the reference; this package imports
neither it nor JAX. Same engine-dir format, same `.wts` weights, same
detection buffer; kernels the JAX package wrote in Pallas are hand-written
CUDA here (`csrc/`, built with nvcc at first use).
"""

from tensorrtx_tpu_torch.core.engine import Engine, build_engine, load_engine
from tensorrtx_tpu_torch.core.registry import get_model, list_models
from tensorrtx_tpu_torch.core.wts import load_wts, save_wts

__version__ = "0.1.0"

__all__ = [
    "Engine", "build_engine", "load_engine",
    "get_model", "list_models", "load_wts", "save_wts",
]

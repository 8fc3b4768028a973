"""Synthetic WeightMap that fabricates tensors on demand.

For benchmarks and smoke runs where no .wts checkpoint exists (latency does
not depend on the weights). It draws in the same order and from the same
numpy generator as the JAX package's ``RandomWeightMap``, so one seed gives
byte-equal arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from tensorrtx_tpu_torch.core.params import WeightMap


class RandomWeightMap(WeightMap):
    def __init__(self, seed: int = 0, scale: float = 0.05):
        super().__init__({})
        self.rng = np.random.default_rng(seed)
        self.scale = scale

    def get_flat(self, name: str) -> np.ndarray:
        raise KeyError("RandomWeightMap only supports shaped access")

    def __contains__(self, name: str) -> bool:
        return True

    def tensor(self, name, shape):
        shape = tuple(int(s) for s in shape)
        if name not in self.raw:
            if name.endswith(("running_var", ".w_2", "moving_variance",
                              "moving_var")):
                # BN variance must be positive
                t = self.rng.uniform(0.5, 1.5, shape)
            elif name.endswith("bn.weight") or name.endswith(".weight") and len(shape) == 1:
                t = self.rng.uniform(0.5, 1.5, shape)
            elif name.endswith("_gamma") and len(shape) == 1:
                t = self.rng.uniform(0.5, 1.5, shape)
            else:
                t = self.rng.normal(0.0, self.scale, shape)
            self.raw[name] = t.astype(np.float32)
        return self.raw[name].reshape(shape)

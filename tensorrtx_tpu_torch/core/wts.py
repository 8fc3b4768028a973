"""`.wts` plain-text weight interchange format.

Format (reference: tutorials/getting_started.md:107-131, lenet/gen_wts.py:83-96):

    <count>\n
    <name> <num_values> <hex32> <hex32> ...\n   (one line per tensor)

Each ``hex32`` token is the big-endian byte representation of a float32. Pure
Python reader/writer; the arrays are byte-equal to the JAX package's
``tensorrtx_tpu.core.wts.load_wts``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

__all__ = ["load_wts", "save_wts", "state_dict_to_wts"]


def load_wts(path: str) -> Dict[str, np.ndarray]:
    """Parse a .wts file into a flat ``{name: float32 1-D array}`` map."""
    weights: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        count = int(f.readline().strip())
        for _ in range(count):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated .wts file")
            parts = line.split()
            name, n, toks = parts[0], int(parts[1]), parts[2:]
            if len(toks) != n:
                raise ValueError(
                    f"{path}: tensor {name!r} declares {n} values, found {len(toks)}")
            buf = bytes.fromhex("".join(toks))
            weights[name] = np.frombuffer(buf, dtype=">f4").astype(np.float32)
    return weights


def save_wts(path: str, tensors: Mapping[str, np.ndarray]) -> None:
    """Write tensors in .wts format (used by exporters and test fixtures)."""
    with open(path, "w") as f:
        f.write(f"{len(tensors)}\n")
        for name, v in tensors.items():
            flat = np.asarray(v, dtype=np.float32).reshape(-1)
            # each value as " " + its 8 big-endian hex digits, built for
            # all values at once
            hexes = np.frombuffer(flat.astype(">f4").tobytes().hex().encode("ascii"),
                                  dtype=np.uint8).reshape(-1, 8)
            toks = np.full((flat.size, 9), ord(" "), np.uint8)
            toks[:, 1:] = hexes
            f.write(f"{name} {flat.size}{toks.tobytes().decode('ascii')}\n")


def state_dict_to_wts(path: str, state_dict: Mapping[str, object]) -> None:
    """Dump a torch state_dict (name -> tensor) to .wts, every entry
    flattened to float32 (the reference's per-model gen_wts.py scripts)."""
    tensors = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        tensors[k] = np.asarray(v, dtype=np.float32)
    save_wts(path, tensors)

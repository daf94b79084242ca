"""Node-feature encoders (counterpart of biomedkg_tpu/data/node_encoders.py).

Only ``RandomEncode`` is ported: the LM, GCL and KGE encoders read pickle
caches built by models not yet in the port (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import List

import numpy as np


def xavier_normal_np(rng: np.random.Generator, shape) -> np.ndarray:
    """torch.nn.init.xavier_normal_ semantics on a 2D shape."""
    fan_out, fan_in = shape[0], shape[1]
    std = np.sqrt(2.0 / (fan_in + fan_out))
    return (std * rng.standard_normal(shape)).astype(np.float32)


class RandomEncode:
    def __init__(self, embed_dim: int = 768, seed: int = 42):
        self.embed_dim = embed_dim
        self._rng = np.random.default_rng(seed)

    def __call__(self, lst_node: List[str]) -> np.ndarray:
        return xavier_normal_np(self._rng, (len(lst_node), self.embed_dim))

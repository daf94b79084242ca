"""Tensor-parallel layout of the model parameters over the mesh's tp axis
(counterpart of biomedkg_tpu/parallel/sharding.py's ``_spec_for`` and
``kge_param_shardings``).

Megatron-style, adapted to relational GNNs: the per-relation weight
stacks ``w_rel`` (R, din, dout) split their output columns, root and
linear weights (``w_root``, ``w``, a feature ``table``) theirs, biases
follow, the decoder's relation table ``rel_emb`` (R, d) splits its hidden
columns, RGAT's attention vectors their last dim; everything else is
replicated. The leaf's name is the last part of its dotted path, as JAX
reads the last key of the tree path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# leaf name → {ndim: dim split over tp}
_SPLITS = {"w_rel": {3: 2}, "rel_emb": {2: 1}, "w_root": {2: 1},
           "w": {2: 1}, "table": {2: 1}, "b": {1: 0}, "att_src": {3: 2},
           "att_dst": {3: 2}}


def shard_dim(name: str, ndim: int) -> Optional[int]:
    """The dim of leaf ``name`` (a dotted path) split over tp, or None
    (replicated)."""
    return _SPLITS.get(name.rsplit(".", 1)[-1], {}).get(ndim)


def param_shard_dims(named_params: Dict[str, torch.Tensor]
                     ) -> Dict[str, Optional[int]]:
    """{name: the dim it splits on over tp, or None} for named
    parameters (``module.named_parameters()`` or a flattened params
    tree)."""
    return {name: shard_dim(name, p.ndim) for name, p in named_params.items()}

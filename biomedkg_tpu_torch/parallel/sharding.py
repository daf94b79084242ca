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

Which dim a leaf splits on is JAX's; which of its columns each rank holds
(``param_layout``) follows what the rank computes with them:

* a hidden layer's output columns split in contiguous blocks (the
  dropout masks and the all-gather before the next layer read them so);
* RGAT's head-major ``w_rel`` (R, din, H·dout) gives rank t every head's
  block of dout columns, matching ``att_src`` / ``att_dst`` and ``b``, so
  each head's attention logits are a sum of the ranks' parts;
* with ComplEx or RotatE, whose features j and j + d/2 form a pair, the
  last layer's columns on rank t are the block t of each half, and so are
  ComplEx's ``rel_emb`` columns; RotatE's (R, d/2) phases take block t;
* a fuser's leaves (``fusion.``) split as JAX's, and the dp × tp step
  gathers them whole: the fuser runs alike on every rank.

``shard_params`` / ``gather_params`` (parallel/dp.py) apply a layout and
undo it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.decoders import ComplEx, RotatE
from ..models.encoders import RGAT

# leaf name → {ndim: dim split over tp}
_SPLITS = {"w_rel": {3: 2}, "rel_emb": {2: 1}, "w_root": {2: 1},
           "w": {2: 1}, "table": {2: 1}, "b": {1: 0}, "att_src": {3: 2},
           "att_dst": {3: 2}}
# leaves the dp × tp step gathers over tp and uses whole
WHOLE_PREFIX = "fusion."

# (dim, order): rank t holds ``order`` block t of the dim (None: the
# contiguous block t); None: replicated
ShardSpec = Optional[Tuple[int, Optional[torch.Tensor]]]


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


def paired_order(width: int, tp: int) -> torch.Tensor:
    """(width,) the columns rank 0 holds, then rank 1's, ...: block t of
    the first half, then block t of the second half."""
    half = width // 2
    if width % 2 or half % tp:
        raise ValueError(f"paired width {width} does not split into "
                         f"{tp} blocks of pairs")
    c = half // tp
    return torch.cat([torch.cat([torch.arange(t * c, (t + 1) * c),
                                 half + torch.arange(t * c, (t + 1) * c)])
                      for t in range(tp)])


def _head_order(order: Optional[torch.Tensor], dout: int, heads: int,
                tp: int) -> torch.Tensor:
    """RGAT's head-major (H·dout) columns: rank t takes each head's
    ``order`` block t of dout."""
    cols = order if order is not None else torch.arange(dout)
    blocks = cols.view(tp, -1)
    return torch.cat([torch.cat([h * dout + blocks[t] for h in range(heads)])
                      for t in range(tp)])


def param_layout(module, tp: int) -> Dict[str, ShardSpec]:
    """{name: (dim, order) or None} of a KGE or GCL module's parameters
    over ``tp`` ranks (the module docstring)."""
    named = dict(module.named_parameters())
    dims = param_shard_dims(named)
    orders: Dict[str, torch.Tensor] = {}
    model = module.model
    enc, dec = model.encoder, getattr(model, "decoder", None)
    paired = isinstance(dec, (ComplEx, RotatE))
    last = len(enc.layers) - 1
    for i, (_, dout) in enumerate(enc.dims):
        order = paired_order(dout, tp) if paired and i == last else None
        prefix = f"model.encoder.layers.{i}."
        if order is not None:
            for leaf in ("w_rel", "w_root", "att_src", "att_dst", "b"):
                orders[prefix + leaf] = order
        if isinstance(enc, RGAT):
            orders[prefix + "w_rel"] = _head_order(order, dout,
                                                   enc.num_heads, tp)
    if isinstance(dec, ComplEx):
        orders["model.decoder.rel_emb"] = paired_order(
            dec.rel_emb.shape[1], tp)
    out = {}
    for name, p in named.items():
        d = dims[name]
        if d is not None and p.shape[d] % tp:
            raise ValueError(f"{name}: dim {d} of {tuple(p.shape)} does not "
                             f"split over tp={tp}")
        out[name] = None if d is None else (d, orders.get(name))
    return out

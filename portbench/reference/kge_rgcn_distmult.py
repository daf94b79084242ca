"""Plain float32 reference of one Stage C training step: the RGCN encoder
(PyG RGCNConv with the per-relation mean) and the DistMult decoder over a
sampled batch, the masked BCE + 1e-2·L2 loss, its gradients by autograd,
and the optimizer (reference/optim.py). It follows the reference
package's equations (configs/model/kge.yaml, the GAE of kge_module.py):

    h_i' = h_i W_root + b + Σ_r (1/|N_r(i)|) Σ_{j∈N_r(i)} h_j W_r

ReLU and inverted dropout (rate 0.2, the injected keep masks) between
convs; score(s, r, t) = Σ z_s ⊙ w_r ⊙ z_t; negatives: slot (k, j) of the
"sorted" sampler scores (neg_src, neg_dst) under the relation of batch
edge (off_k + (j mod a)·(E/a) + j div a) mod E, a the largest divisor of
E up to √E, and counts where that edge is real. Only the batch's real
rows and edges enter: pads carry zero weight in every term.

Plain torch only, TF32 off by the caller; nothing of the program.
``dtype`` bfloat16 is the control: every product's operands rounded to
bf16, as a lower-precision step would compute them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

DROPOUT = 0.2


def mix_factor(e: int) -> int:
    """The largest divisor of e that is at most √e."""
    best = 1
    for d in range(1, math.isqrt(e) + 1):
        if e % d == 0:
            best = d
    return best


def negative_edges(off: torch.Tensor, e: int) -> torch.Tensor:
    """(K·E,) batch-edge index of each negative slot."""
    a = mix_factor(e)
    j = torch.arange(e, device=off.device)
    perm = (j % a) * (e // a) + j // a
    return ((perm[None, :] + off[:, None]) % e).reshape(-1)


def encode(x, src, dst, rel, params: Dict[str, torch.Tensor],
           keep: Optional[List[torch.Tensor]], num_layers: int,
           num_relations: int, dtype=torch.float32) -> torch.Tensor:
    """(n, d_out) float32 embeddings of the n real rows; ``keep`` None:
    no dropout."""
    n = x.shape[0]
    order = torch.argsort(rel, stable=True)
    src, dst, rel = src[order], dst[order], rel[order]
    sizes = torch.bincount(rel, minlength=num_relations).tolist()
    key = dst * num_relations + rel
    count = torch.zeros(n * num_relations, device=x.device).index_add_(
        0, key, torch.ones_like(key, dtype=torch.float32))
    norm = (1.0 / count[key])[:, None]
    h = x
    for i in range(num_layers):
        w_rel = params[f"model.encoder.layers.{i}.w_rel"]
        w_root = params[f"model.encoder.layers.{i}.w_root"]
        b = params[f"model.encoder.layers.{i}.b"]
        hd = h.to(dtype)
        msg = torch.cat([(part @ w_rel[r].to(dtype)).float()
                         for r, part in enumerate(torch.split(hd[src],
                                                              sizes))])
        agg = torch.zeros(n, w_rel.shape[-1], device=x.device).index_add(
            0, dst, msg * norm)
        h = (hd @ w_root.to(dtype)).float() + b + agg
        if i < num_layers - 1:
            h = torch.relu(h)
            if keep is not None:
                h = torch.where(keep[i], h / (1.0 - DROPOUT), 0.0)
    return h


def step_loss(batch: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
              num_layers: int, num_relations: int,
              dtype=torch.float32) -> torch.Tensor:
    """The loss of one step. ``batch``: x (n, d_in) real rows' features;
    src, dst, rel (E_real,) real edges in row indices; keep, the hidden
    convs' keep masks (n, hidden); the padded batch's edge_mask and
    edge_type (E_pad,); neg_src, neg_dst (K·E_pad,) row indices and off
    (K,)."""
    z = encode(batch["x"], batch["src"], batch["dst"], batch["rel"], params,
               batch["keep"], num_layers, num_relations, dtype)
    w = params["model.decoder.rel_emb"]
    zd, wd = z.to(dtype), w.to(dtype)
    pos = (zd[batch["src"]] * wd[batch["rel"]] * zd[batch["dst"]]).float() \
        .sum(1)
    e_pad = batch["edge_mask"].shape[0]
    idx = negative_edges(batch["off"], e_pad)
    real = batch["edge_mask"][idx]
    ns, nd = batch["neg_src"][real], batch["neg_dst"][real]
    nrel = batch["edge_type"][idx][real]
    neg = (zd[ns] * wd[nrel] * zd[nd]).float().sum(1)
    terms = torch.cat([F.softplus(-pos), F.softplus(neg)])
    bce = terms.sum() / max(terms.shape[0], 1)
    reg = (z ** 2).sum() / (z.shape[0] * z.shape[1]) + torch.mean(w ** 2)
    return bce + 1e-2 * reg


def _neg_terms(zd, wd, ns, nd, rel):
    return F.softplus((zd[ns] * wd[rel] * zd[nd]).float().sum(1)).sum()


def full_batch_loss(x, src, dst, rel, neg_src, neg_dst, params, num_layers,
                    num_relations, dtype=torch.float32,
                    chunk: int = 1 << 20) -> torch.Tensor:
    """The typed tables' full-batch loss over the whole graph: no
    dropout, the (K, E) iid negatives each scored under its column's
    relation, the mean BCE over every positive and negative, + 1e-2 ×
    (mean(z²) + mean(w²)). The negatives are scored in chunks, each
    recomputed in the backward, so their gathers never sit whole."""
    from torch.utils.checkpoint import checkpoint
    z = encode(x, src, dst, rel, params, None, num_layers, num_relations,
               dtype)
    w = params["model.decoder.rel_emb"]
    zd, wd = z.to(dtype), w.to(dtype)
    pos = (zd[src] * wd[rel] * zd[dst]).float().sum(1)
    k = neg_src.shape[0]
    ns, nd = neg_src.reshape(-1), neg_dst.reshape(-1)
    nrel = rel.repeat(k)
    neg = sum(checkpoint(_neg_terms, zd, wd, ns[s:s + chunk],
                         nd[s:s + chunk], nrel[s:s + chunk],
                         use_reentrant=False)
              for s in range(0, ns.shape[0], chunk))
    bce = (F.softplus(-pos).sum() + neg) / (pos.shape[0] + ns.shape[0])
    return bce + 1e-2 * (torch.mean(z ** 2) + torch.mean(w ** 2))

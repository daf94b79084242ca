"""Plain float32 reference of one Stage B GRACE step: two augmented views
(entrywise feature keep masks, edge keep masks) through the GCN (PyG
GCNConv: self-loops, symmetric D^-1/2 (A + I) D^-1/2 over the kept real
edges), the projection fc2(elu(fc1(z))), and PyGCL's
DualBranchContrast(InfoNCE(τ = 0.2), "L2L", intraview_negs=True) over the
real rows: cosine similarities, the positive on the inter-view diagonal,
every inter-view pair and every other intra-view pair as negatives, both
directions averaged. ReLU and inverted dropout (rate 0.2, the injected
keep masks) between convs.

The denominators are taken over row blocks, each recomputed in the
backward (``torch.utils.checkpoint``), so the (n, n) logits never sit in
memory whole. Plain torch only, TF32 off by the caller; nothing of the
program. ``dtype`` bfloat16 is the control: every product's operands
rounded to bf16.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DROPOUT = 0.2
TAU = 0.2
BLOCK = 2048


def gcn(x, src, dst, keep_edge, params: Dict[str, torch.Tensor],
        keep: List[torch.Tensor], num_layers: int, dtype) -> torch.Tensor:
    n = x.shape[0]
    w = keep_edge.float()
    deg = torch.zeros(n, device=x.device).index_add(0, dst, w) + 1.0
    dis = deg.rsqrt()
    norm = (dis[src] * dis[dst] * w)[:, None]
    h = x
    for i in range(num_layers):
        hw = (h.to(dtype) @ params[f"model.encoder.layers.{i}.w"].to(
            dtype)).float()
        agg = torch.zeros_like(hw).index_add(0, dst, hw[src] * norm)
        h = agg + hw / deg[:, None] + params[f"model.encoder.layers.{i}.b"]
        if i < num_layers - 1:
            h = torch.where(keep[i], torch.relu(h) / (1.0 - DROPOUT), 0.0)
    return h


def linear(x, params, name, dtype):
    return (x.to(dtype) @ params[name + ".w"].to(dtype)).float() \
        + params[name + ".b"]


def _block_denominators(a, bn, an, start, dtype):
    inter = (a.to(dtype) @ bn.T.to(dtype)).float() / TAU
    intra = (a.to(dtype) @ an.T.to(dtype)).float() / TAU
    rows = torch.arange(a.shape[0], device=a.device)
    intra = intra.index_put((rows, rows + start),
                            torch.tensor(float("-inf"), device=a.device))
    return torch.logaddexp(torch.logsumexp(inter, 1),
                           torch.logsumexp(intra, 1))


def direction(a, b, dtype) -> torch.Tensor:
    an = a / a.norm(dim=1, keepdim=True).clamp(min=1e-12)
    bn = b / b.norm(dim=1, keepdim=True).clamp(min=1e-12)
    pos = (an.to(dtype) * bn.to(dtype)).float().sum(1) / TAU
    denom = torch.cat([
        checkpoint(_block_denominators, an[s:s + BLOCK], bn, an, s, dtype,
                   use_reentrant=False)
        for s in range(0, an.shape[0], BLOCK)])
    return torch.mean(denom - pos)


def step_loss(batch: Dict, params: Dict[str, torch.Tensor], num_layers: int,
              dtype=torch.float32) -> torch.Tensor:
    """The loss of one step. ``batch``: x (n, d_in) real rows' features;
    src, dst (E_real,) real edges in row indices; feat_keep (2 views of
    (n, d_in)), edge_keep (2 views of (E_real,)), keep (2 views of the
    hidden convs' (n, hidden) masks)."""
    h = []
    for v in range(2):
        z = gcn(batch["x"] * batch["feat_keep"][v], batch["src"],
                batch["dst"], batch["edge_keep"][v], params,
                batch["keep"][v], num_layers, dtype)
        h.append(linear(F.elu(linear(z, params, "model.fc1", dtype)),
                        params, "model.fc2", dtype))
    return 0.5 * (direction(h[0], h[1], dtype) + direction(h[1], h[0],
                                                            dtype))

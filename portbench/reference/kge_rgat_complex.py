"""Plain float32 reference of one Stage C training step with the RGAT
encoder and the ComplEx decoder over a sampled batch: the masked BCE +
1e-2·L2 loss, whose gradients autograd takes and whose update the
optimizer makes (reference/optim.py). Per conv, head h, relation r and
real edge u → v (configs/model/kge.yaml: ``encoder_name: rgat``,
``num_heads: 2``):

    m_uv = x_u W_r[:, h],  n_uv = x_v W_r[:, h]
    e_uv = leaky_relu(a_src[r, h]·m_uv + a_dst[r, h]·n_uv, 0.2)
    α_uv = softmax of e over every real edge into v, across relations
    x_v' = mean over h of Σ_u α_uv m_uv, + b

ReLU and inverted dropout (rate 0.2, the injected keep masks) between
convs. ComplEx (Trouillon et al., arXiv:1606.06357): score(s, r, t) =
Re⟨z_s, w_r, conj z_t⟩ over the half-width real (first half) and
imaginary (second half) parts. Negatives: the "sorted" sampler's slots
(``kge_rgcn_distmult.negative_edges``), each scored under the relation
of its batch edge and counted where that edge is real.

Computed a way the program does not: each relation's x W_r over the
batch's real rows, then gathered at the edges' ends (the program
gathers per edge and multiplies in relation blocks); the softmax by
``scatter_reduce`` (amax, its shift detached: softmax does not depend on
it) and ``index_add``, over the real edges only (the program masks its
padded slots).

Departures from the published descriptions, as the port and the JAX
package make them (PARITY.md: the reference repository's own RGAT never
ran):
* the heads are averaged, not concatenated, so every conv keeps the
  stack's widths (768 → 256 → 256 → 256 → 256);
* the attention is GAT's additive form with one pair of vectors per
  relation and head, normalised across relations at each destination; not
  Busbridge et al.'s query and key kernels (arXiv:1904.05811) nor PyG's
  ``RGATConv``.

Plain torch only, TF32 off by the caller; nothing of the program.
``dtype`` bfloat16 is the control: the products' operands rounded to
bf16, as a lower-precision step would compute them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .kge_rgcn_distmult import negative_edges

DROPOUT = 0.2
SLOPE = 0.2


def conv(h, src, dst, rel, sizes: List[int], params: Dict[str, torch.Tensor],
         i: int, heads: int, dtype) -> torch.Tensor:
    """Conv ``i`` over the n real rows ``h`` and the real edges, grouped by
    relation (``sizes``: each relation's edge count)."""
    w_rel = params[f"model.encoder.layers.{i}.w_rel"]
    att_src = params[f"model.encoder.layers.{i}.att_src"]
    att_dst = params[f"model.encoder.layers.{i}.att_dst"]
    b = params[f"model.encoder.layers.{i}.b"]
    n, dout = h.shape[0], b.shape[0]
    hd = h.to(dtype)
    ends = []
    for r, (s, t) in enumerate(zip(torch.split(src, sizes),
                                   torch.split(dst, sizes))):
        if s.numel():
            proj = (hd @ w_rel[r].to(dtype)).float().reshape(n, heads, dout)
            ends.append((proj[s], proj[t]))
    m = torch.cat([a for a, _ in ends])
    nv = torch.cat([c for _, c in ends])
    logits = ((m * att_src[rel]).sum(-1)
              + (nv * att_dst[rel]).sum(-1))               # (E, heads)
    logits = F.leaky_relu(logits, SLOPE)
    index = dst[:, None].expand(-1, heads)
    top = torch.full((n, heads), float("-inf"), device=h.device)
    top = top.scatter_reduce(0, index, logits.detach(), "amax",
                             include_self=False)
    ex = torch.exp(logits - top[dst])
    denom = h.new_zeros(n, heads).index_add(0, dst, ex)
    alpha = ex / denom[dst]
    agg = h.new_zeros(n, heads, dout).index_add(0, dst, m * alpha[..., None])
    return agg.mean(1) + b


def encode(x, src, dst, rel, params: Dict[str, torch.Tensor],
           keep: Optional[List[torch.Tensor]], num_layers: int, heads: int,
           num_relations: int, dtype=torch.float32) -> torch.Tensor:
    """(n, d_out) float32 embeddings of the n real rows; ``keep`` None:
    no dropout."""
    order = torch.argsort(rel, stable=True)
    src, dst, rel = src[order], dst[order], rel[order]
    sizes = torch.bincount(rel, minlength=num_relations).tolist()
    h = x
    for i in range(num_layers):
        h = conv(h, src, dst, rel, sizes, params, i, heads, dtype)
        if i < num_layers - 1:
            h = torch.relu(h)
            if keep is not None:
                h = torch.where(keep[i], h / (1.0 - DROPOUT), 0.0)
    return h


def complex_scores(zd, wd, s, r, t) -> torch.Tensor:
    """Re⟨z_s, w_r, conj z_t⟩, summed in float32."""
    half = zd.shape[1] // 2
    h, w, u = zd[s], wd[r], zd[t]
    h_re, h_im = h[:, :half], h[:, half:]
    w_re, w_im = w[:, :half], w[:, half:]
    u_re, u_im = u[:, :half], u[:, half:]
    re = h_re * w_re - h_im * w_im
    im = h_re * w_im + h_im * w_re
    return (re * u_re + im * u_im).float().sum(1)


def step_loss(batch: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
              num_layers: int, heads: int, num_relations: int,
              dtype=torch.float32) -> torch.Tensor:
    """The loss of one step; ``batch`` as ``kge_rgcn_distmult.step_loss``
    takes it: x (n, d_in) real rows' features; src, dst, rel (E_real,) real
    edges in row indices; keep, the hidden convs' keep masks (n, hidden);
    the padded batch's edge_mask and edge_type (E_pad,); neg_src, neg_dst
    (K·E_pad,) row indices and off (K,)."""
    z = encode(batch["x"], batch["src"], batch["dst"], batch["rel"], params,
               batch["keep"], num_layers, heads, num_relations, dtype)
    w = params["model.decoder.rel_emb"]
    zd, wd = z.to(dtype), w.to(dtype)
    pos = complex_scores(zd, wd, batch["src"], batch["rel"], batch["dst"])
    e_pad = batch["edge_mask"].shape[0]
    idx = negative_edges(batch["off"], e_pad)
    real = batch["edge_mask"][idx]
    neg = complex_scores(zd, wd, batch["neg_src"][real],
                         batch["edge_type"][idx][real],
                         batch["neg_dst"][real])
    terms = torch.cat([F.softplus(-pos), F.softplus(neg)])
    bce = terms.sum() / max(terms.shape[0], 1)
    reg = (z ** 2).sum() / (z.shape[0] * z.shape[1]) + torch.mean(w ** 2)
    return bce + 1e-2 * reg

"""The typed-table SAINT step with the per-type tables row-sharded over
the ranks of the mesh's dp axis (counterpart of
biomedkg_tpu/parallel/typed_shard.py).

A type's (B_t, d) table splits into P row blocks of ceil(B_t / P) rows
(the last zero-padded); its ``counts`` rows follow, while the signature
blocks, the supervision edges and the parameters are replicated. Per
conv, each rank:

* all-gathers each source type's row blocks (the per-signature gather of
  the source rows then reads the whole table);
* aggregates the edges of every block whose (ascending) ``dst_local``
  falls in its own rows, on the sorted segment-sum (the CUDA kernel on
  the card), and writes only its rows.

The final tables are all-gathered once; each rank scores its slice of
the supervision edges and their negatives, and the masked BCE's
numerator and the L2 terms are summed over the ranks (psum) before the
same loss as training/typed_train.py's ``make_typed_batch_loss``. The
parameters' gradients are summed over the ranks and one replicated
optimizer step applies. The draws (dropout masks over the whole tables in
sorted type order, then the negatives) are those of the single-device
step for the same generator, so every rank seeds it alike.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.encoders import DROPOUT
from ..models.typed import _layers
from ..nn import dropout, dropout_mask
from ..ops.segment import take_rows
from ..ops.segsum import sorted_segment_sum
from ..sampling.typed_batch import TypedBatch, parse_sig
from ..training.stepping import param_grads
from ..training.typed_train import iid_negatives
from .collectives import all_gather, all_reduce_grads, psum_replicated
from .mesh import Mesh


class LocalTyped(NamedTuple):
    """One rank's row blocks of a TypedBatch, on its device."""
    sizes: Dict[str, int]                 # type → B_t
    block: Dict[str, int]                 # type → rows a rank holds
    row0: Dict[str, int]                  # type → this rank's first row
    x: Dict[str, torch.Tensor]            # type → (block, D)
    counts: Dict[str, torch.Tensor]       # type → (block, R)
    # (s_t, r, t_t, src_local, dst in this rank's rows int32, mask)
    blocks: List[Tuple]
    pos: torch.Tensor                     # (4, P) int64, replicated


def local_typed(batch: TypedBatch, mesh: Mesh, device) -> LocalTyped:
    """This rank's rows of ``batch`` (host numpy) on ``device``."""
    n, p = mesh.dp, mesh.dp_rank
    sizes, block, row0, xs, counts = {}, {}, {}, {}, {}
    for t, x in batch.x.items():
        b = x.shape[0]
        s = -(-b // n)
        lo, hi = min(p * s, b), min((p + 1) * s, b)
        sizes[t], block[t], row0[t] = b, s, lo
        for out, a in ((xs, x), (counts, batch.counts[t])):
            rows = np.zeros((s,) + a.shape[1:], np.float32)
            rows[:hi - lo] = a[lo:hi]
            out[t] = torch.as_tensor(rows, device=device)
    blocks = []
    for key, b in batch.sigs.items():
        s_t, r, t_t = parse_sig(key)
        dl = np.asarray(b[1])
        lo = np.searchsorted(dl, row0[t_t], side="left")
        hi = np.searchsorted(dl, row0[t_t] + block[t_t], side="left")
        blocks.append((
            s_t, r, t_t,
            torch.as_tensor(np.asarray(b[0][lo:hi]), device=device).long(),
            torch.as_tensor(dl[lo:hi] - row0[t_t], device=device).to(
                torch.int32),
            torch.as_tensor(np.asarray(b[2][lo:hi], np.float32),
                            device=device)))
    return LocalTyped(sizes, block, row0, xs, counts, blocks,
                      torch.as_tensor(batch.pos, device=device).long())


def _gather_table(x: torch.Tensor, size: int, group) -> torch.Tensor:
    return all_gather(x, group)[:size]


def _encode(layers, local: LocalTyped, group, *, training, drop_out,
            generator, dropout_masks) -> Dict[str, torch.Tensor]:
    """models/typed.py's ``_encode`` on this rank's rows."""
    xs = local.x
    for li, (w_rel, w_root, b) in enumerate(layers):
        # every rank gathers the same types in the same order
        full = {t: _gather_table(xs[t], local.sizes[t], group)
                for t in sorted({blk[0] for blk in local.blocks})}
        out = {t: x @ w_root + b for t, x in xs.items()}
        for s_t, r, t_t, sl, dl, m in local.blocks:
            msg = torch.matmul(take_rows(full[s_t], sl), w_rel[r])
            msg = msg * m[:, None]
            agg = sorted_segment_sum(msg, dl, local.block[t_t])
            cnt = local.counts[t_t][:, r]
            out[t_t] = out[t_t] + agg / cnt.clamp(min=1.0)[:, None]
        if li < len(layers) - 1:
            out = {t: torch.relu(v) for t, v in out.items()}
            if drop_out and training:
                for t in sorted(out):
                    lo, s = local.row0[t], local.block[t]
                    keep = (dropout_masks[li][t] if dropout_masks is not None
                            else dropout_mask(
                                (local.sizes[t], out[t].shape[1]), DROPOUT,
                                generator, out[t].device))
                    rows = torch.ones((s, out[t].shape[1]), dtype=torch.bool,
                                      device=out[t].device)
                    part = keep[lo:lo + s]
                    rows[:part.shape[0]] = part
                    out[t] = dropout(out[t], rows, DROPOUT)
        xs = out
    return xs


def make_typed_spmd_step(encoder, decoder, tx, mesh: Mesh,
                         template_batch: TypedBatch, neg_ratio: int = 4):
    """The typed SAINT training step with row-sharded tables. Returns
    ``step(params, opt_state, batch, flat_real, n_real, generator=None,
    negatives=None, dropout_masks=None) -> (opt_state, loss)``: ``params``
    (the encoder's and decoder's weights by name, updated in place) and
    the loss as training/typed_train.py's ``make_typed_batch_loss`` and
    ``typed_update`` take them; ``batch`` a host TypedBatch of
    ``template_batch``'s envelope; ``flat_real`` a device tensor."""
    group = mesh.dp_group
    types = list(template_batch.x)

    def step(params, opt_state, batch, flat_real, n_real, generator=None,
             negatives=None, dropout_masks=None):
        if generator is None and (negatives is None or (
                encoder.drop_out and dropout_masks is None)):
            raise ValueError("pass a torch.Generator or the draws "
                             "(negatives, dropout_masks)")
        local = local_typed(batch, mesh, flat_real.device)
        if list(local.sizes) != types:
            raise ValueError(f"batch types {list(local.sizes)} are not the "
                             f"template's {types}")
        tables = _encode(_layers(encoder), local, group, training=True,
                         drop_out=encoder.drop_out, generator=generator,
                         dropout_masks=dropout_masks)
        z = torch.cat([_gather_table(tables[t], local.sizes[t], group)
                       for t in types])
        src, dst, rel = local.pos[0], local.pos[1], local.pos[2]
        w = local.pos[3].float()
        if negatives is None:
            negatives = iid_negatives(generator, neg_ratio, rel.shape[0],
                                      n_real)
        js, jd = negatives
        # this rank's slice of the supervision edges
        c = -(-rel.shape[0] // mesh.dp)
        cols = slice(mesh.dp_rank * c, (mesh.dp_rank + 1) * c)
        pos = decoder.score(z, src[cols], dst[cols], rel[cols])
        neg = decoder.score_neg(z, flat_real[js[:, cols]],
                                flat_real[jd[:, cols]], rel[cols])
        wsum = w.sum().clamp(min=1.0) * (1 + neg_ratio)
        num = (torch.sum(-F.logsigmoid(pos) * w[cols])
               + torch.sum(-F.logsigmoid(-neg) * w[None, cols]))
        bce = psum_replicated(num, group) / wsum
        z_sq = sum(torch.sum(tables[t][:max(0, min(
            local.block[t], local.sizes[t] - local.row0[t]))] ** 2)
            for t in types)
        width = z.shape[1]
        mean_z2 = psum_replicated(z_sq, group) / (z.shape[0] * width)
        reg = sum(torch.mean(p ** 2) for p in decoder.parameters())
        # every rank computes the decoder's L2 alike: rank 0 carries it
        reg = psum_replicated(reg if mesh.dp_rank == 0 else reg * 0.0,
                              group)
        loss = bce + 1e-2 * (mean_z2 + reg)
        grads = all_reduce_grads(param_grads(loss, params), group)
        opt_state = tx.update(grads, opt_state, list(params.values()))
        return opt_state, loss.detach()

    return step

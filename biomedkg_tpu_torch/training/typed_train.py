"""Typed-table KGE training (counterpart of
biomedkg_tpu/training/typed_train.py): ``train_kge typed_tables=true``
routes here.

The typed RGCN (models/typed.py) encodes per-type tables, the module's
decoder scores the tables concatenated in global type-offset order, and
the loss is BCE over the positives and iid negatives + 1e-2·(mean(z²) +
Σ mean(leaf²) over the decoder's parameters), stepped by
clip-by-global-norm 1.0 then Adam at the module's constant learning rate
(optax's ``chain(clip_by_global_norm(1.0), adam(lr))``: the port's
Optimizer with a constant schedule). The train split's edges are both
message passing and supervision (the reference's protocol).

* ``typed_full_train``: full-batch on the train split's message-passing
  edges, (neg_ratio, E) negatives iid over all nodes, ``typed_steps``
  (300) × max(1, epochs) steps;
* ``typed_saint_train`` (``typed_loader=saint``): typed GraphSAINT
  sub-batches (sampling/typed_batch.py), masked BCE
  (``make_typed_batch_loss``) with negatives drawn over the batch's real
  rows, ``typed_steps`` batches an epoch.

Both test on the full-graph typed encode (``_typed_binary_test``: numpy
``default_rng(seed)`` negatives, ``BootstrappedBinaryMetrics``), print and
return the metrics, and write no checkpoint, as the JAX package does.
Random numbers come from a ``torch.Generator`` on the device; the loss
functions take injected negatives and dropout masks (the tests pass the
JAX package's).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.typed import (TypedGraph, concat_tables, to_typed,
                            typed_batch_to_device, typed_encode,
                            typed_encode_batch, typed_to_device)
from ..utils import profiling
from .metrics import BootstrappedBinaryMetrics
from .optim import Optimizer
from .stepping import param_grads


def train_split_typed(data_module) -> TypedGraph:
    """The typed view of the train split's message-passing edges."""
    return to_typed(data_module.train_data.graph,
                    data_module.data.type_offset,
                    data_module.data.node_type_of)


def typed_optimizer(learning_rate: float) -> Optimizer:
    """clip_by_global_norm(1.0) then Adam at a constant rate (the rate
    rounded to float32, as optax's scale takes it)."""
    lr = float(np.float32(learning_rate))
    return Optimizer(lambda step: lr, grad_clip=1.0)


def typed_params(module) -> Dict[str, torch.Tensor]:
    """The trained leaves by name: the encoder's and the decoder's."""
    return {f"model.{name}": p for name, p in module.model.named_parameters()}


def _regularised(bce, z, decoder):
    reg = sum(torch.mean(p ** 2) for p in decoder.parameters())
    return bce + 1e-2 * (torch.mean(z ** 2) + reg)


def full_batch_loss(encoder, decoder, typed: TypedGraph, src, dst, rel,
                    neg_src, neg_dst) -> torch.Tensor:
    """Mean BCE over the positives and the (K, E) negatives of the
    full-graph typed encode, + the L2 term (the ``step.forward`` span)."""
    with profiling.span("step.forward", counters=(profiling.LAUNCHES,)):
        z = concat_tables(typed_encode(encoder, typed), typed.type_names)
        pos = decoder.score(z, src, dst, rel)
        neg = decoder.score_neg(z, neg_src, neg_dst, rel).reshape(-1)
        pred = torch.cat([pos, neg])
        gt = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
        bce = torch.mean(-(gt * F.logsigmoid(pred)
                           + (1 - gt) * F.logsigmoid(-pred)))
        return _regularised(bce, z, decoder)


def iid_negatives(generator: torch.Generator, ratio: int, num_edges: int,
                  high) -> tuple:
    """(K, E) int64 sources and destinations, iid over [0, high) (the
    ``step.draw`` span)."""
    shape = (ratio, num_edges)
    with profiling.span("step.draw", counters=(profiling.LAUNCHES,)):
        return (torch.randint(0, int(high), shape, generator=generator,
                              device=generator.device),
                torch.randint(0, int(high), shape, generator=generator,
                              device=generator.device))


def typed_update(loss, params: Dict[str, torch.Tensor], tx: Optimizer,
                 opt_state):
    """One clip + Adam update of ``params`` in place; the new state."""
    grads = param_grads(loss, params)
    return tx.update(grads, opt_state, list(params.values()))


def _label_edges(split, device):
    return tuple(torch.as_tensor(np.asarray(a, np.int64), device=device)
                 for a in (split[0], split[1], split[2]))


def typed_full_train(model, data_module, cfg, device: torch.device):
    """Full-batch typed training of ``model`` (a KGEModule with an RGCN
    encoder) on ``device``; returns the test metrics."""
    enc, dec = model.model.encoder, model.model.decoder
    neg_ratio = model.neg_ratio or 1
    typed = typed_to_device(train_split_typed(data_module), device)
    n = typed.num_nodes

    model.init(torch.Generator().manual_seed(int(cfg.seed)))
    model.to(device)
    params = typed_params(model)
    steps = int(cfg.get("typed_steps", 300)) * max(1, int(cfg.epochs))
    tx = typed_optimizer(model.hparams["learning_rate"])
    opt = tx.init(list(params.values()))

    g = data_module.train_data.graph
    src, dst, rel = _label_edges((g.edge_index[0], g.edge_index[1],
                                  g.edge_type), device)
    gen = torch.Generator(device=device).manual_seed(int(cfg.seed) + 1)
    t0 = time.perf_counter()
    for i in range(steps):
        ns, nd = iid_negatives(gen, neg_ratio, rel.shape[0], n)
        loss = full_batch_loss(enc, dec, typed, src, dst, rel, ns, nd)
        opt = typed_update(loss, params, tx, opt)
        if i % 100 == 0 or i == steps - 1:
            print(f"[typed {i}/{steps}] loss={loss.item():.4f}", flush=True)
    print(f"typed full-batch training: {steps} steps in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return _typed_binary_test(enc, dec, typed, data_module, neg_ratio,
                              int(cfg.seed))


@torch.no_grad()
def _typed_binary_test(encoder, decoder, typed: TypedGraph, data_module,
                       neg_ratio: int, seed: int) -> Dict[str, float]:
    """Binary test metrics (the reference's protocol, sampled negatives)
    scored on the full-graph typed encode of the device TypedGraph."""
    device = next(encoder.parameters()).device
    n = typed.num_nodes
    z = concat_tables(typed_encode(encoder, typed), typed.type_names)
    te = data_module.test_data
    tsrc, tdst, trel = _label_edges((te.label_edge_index[0],
                                     te.label_edge_index[1],
                                     te.label_edge_type), device)
    pos = decoder.score(z, tsrc, tdst, trel).cpu().numpy()
    rng = np.random.default_rng(seed)
    negs = []
    for _ in range(max(1, neg_ratio)):
        ns = torch.as_tensor(rng.integers(0, n, len(pos)).astype(np.int32),
                             device=device).long()
        nd = torch.as_tensor(rng.integers(0, n, len(pos)).astype(np.int32),
                             device=device).long()
        negs.append(decoder.score(z, ns, nd, trel).cpu().numpy())
    neg = np.concatenate(negs)
    m = BootstrappedBinaryMetrics(prefix="test_")
    m.update(np.concatenate([pos, neg]),
             np.concatenate([np.ones_like(pos), np.zeros_like(neg)]))
    out = m.compute()
    print("typed-table test metrics:")
    for k in sorted(out):
        print(f"  {k}: {out[k]:.6f}")
    return out


def make_typed_batch_loss(encoder, decoder, neg_ratio: int):
    """The typed SAINT loss: masked BCE over the positives and K
    negatives a supervision edge on the concatenated batch tables, the
    weights (1 + K)·max(Σw, 1), negatives drawn over the real batch rows
    (``flat_real``), + the L2 term. Honours ``encoder.drop_out``
    (dropout 0.2 after each hidden conv).

    ``loss_fn(batch, flat_real, n_real, generator=None, negatives=None,
    dropout_masks=None)`` takes a device batch (``typed_batch_to_device``)
    and ``flat_real`` as a device tensor; ``negatives`` are the (K, P)
    draws (js, jd) into ``flat_real``, else drawn from ``generator``
    after the dropout masks."""

    def loss_fn(batch, flat_real, n_real, generator=None, negatives=None,
                dropout_masks=None):
        if generator is None and (negatives is None or (
                encoder.drop_out and dropout_masks is None)):
            raise ValueError("pass a torch.Generator or the draws "
                             "(negatives, dropout_masks)")
        tables = typed_encode_batch(encoder, batch, training=True,
                                    drop_out=encoder.drop_out,
                                    generator=generator,
                                    dropout_masks=dropout_masks)
        z = concat_tables(tables, list(batch.x.keys()))
        src, dst, rel = batch.pos[0], batch.pos[1], batch.pos[2]
        w = batch.pos[3].float()
        pos = decoder.score(z, src, dst, rel)
        if negatives is None:
            negatives = iid_negatives(generator, neg_ratio, rel.shape[0],
                                      n_real)
        js, jd = negatives
        neg = decoder.score_neg(z, flat_real[js], flat_real[jd], rel)
        wsum = w.sum().clamp(min=1.0) * (1 + neg_ratio)
        bce = (torch.sum(-F.logsigmoid(pos) * w)
               + torch.sum(-F.logsigmoid(-neg) * w[None, :])) / wsum
        return _regularised(bce, z, decoder)

    return loss_fn


def typed_sampler(data_module, steps: int, seed: int):
    """The typed SAINT sampler over the train split, its signature
    vocabulary from the largest split."""
    from ..sampling.typed_batch import TypedSaintSampler

    tg = data_module.data
    return TypedSaintSampler(
        data_module.train_data.graph, tg.node_type_of, tg.node_type_names,
        batch_size=data_module.batch_size,
        walk_length=data_module.SAINT_WALK_LENGTH, num_steps=steps,
        seed=seed, sig_graph=data_module._probe_graph())


def flat_real_to_device(sampler, batch, device):
    """``sampler.flat_real(batch)`` as (int64 device tensor, int)."""
    flat, n_real = sampler.flat_real(batch)
    return torch.as_tensor(flat, device=device).long(), int(n_real)


def typed_saint_train(model, data_module, cfg, device: torch.device):
    """Typed SAINT sub-batch training of ``model`` on ``device``
    (``typed_steps`` batches an epoch, max(1, epochs) epochs); returns the
    test metrics of the full-graph typed encode."""
    enc, dec = model.model.encoder, model.model.decoder
    neg_ratio = model.neg_ratio or 1
    sampler = typed_sampler(data_module, int(cfg.get("typed_steps", 300)),
                            int(cfg.seed))
    model.init(torch.Generator().manual_seed(int(cfg.seed)))
    model.to(device)
    params = typed_params(model)
    tx = typed_optimizer(model.hparams["learning_rate"])
    opt = tx.init(list(params.values()))
    batch_loss = make_typed_batch_loss(enc, dec, neg_ratio)

    gen = torch.Generator(device=device).manual_seed(int(cfg.seed) + 1)
    t0 = time.perf_counter()
    n_steps = 0
    for epoch in range(max(1, int(cfg.epochs))):
        sampler.set_epoch(epoch)
        for batch in sampler:
            flat, n_real = flat_real_to_device(sampler, batch, device)
            loss = batch_loss(typed_batch_to_device(batch, device), flat,
                              n_real, generator=gen)
            opt = typed_update(loss, params, tx, opt)
            if n_steps % 100 == 0:
                print(f"[typed-saint {n_steps}] loss={loss.item():.4f}",
                      flush=True)
            n_steps += 1
    print(f"typed SAINT training: {n_steps} steps in "
          f"{time.perf_counter() - t0:.1f}s "
          f"(dropped_edges={sampler.dropped_edges})", flush=True)
    typed = typed_to_device(train_split_typed(data_module), device)
    return _typed_binary_test(enc, dec, typed, data_module, neg_ratio,
                              int(cfg.seed))

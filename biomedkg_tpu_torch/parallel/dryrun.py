"""The dry run of every parallel strategy on tiny shapes (counterpart of
``dryrun_multichip`` in the repo root's ``__graft_entry__.py``): called on
every rank of an initialised group of ``n`` ranks, it runs

  1. the dp × tp step (tp = 2 where n is even) against the same dp-mean
     step on one device, for RGCN + DistMult, RGAT + ComplEx and GRACE;
  2. the data-parallel step, and 2b. k = 2 steps of it in one call,
     against the serial mean of the ranks' steps;
  3. the balanced graph-sharded encode against the single-device encode;
  4. the graph-sharded training step with the all_gather and with the
     halo exchange (the same fixed negatives) against one single-device
     step over the same edges on the full-batch encode: the loss, and the
     parameters after one Adam step;
  5. the typed step with row-sharded tables against the single-device
     typed step;
  6. sharded filtered ranking against the unsharded ranks (bit for bit);

each rank computing its reference itself. It prints (rank 0) each leg's
loss and the graph shard's balance and communication volume, and returns
them with every leg's largest error against its reference; a leg outside
its tolerance raises.
"""

from __future__ import annotations

import copy
import json
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..data.node_encoders import RandomEncode
from ..data.synthetic import synthetic_triplets
from ..data.triplet import TripletGraph
from ..eval.ranking import filtered_ranking_metrics
from ..models.decoders import DistMult
from ..models.encoders import RGCN
from ..sampling.batch import batch_to_device
from ..sampling.loaders import FullGraphLoader
from ..sampling.saint import SaintRandomWalkSampler
from ..sampling.typed_batch import TypedSaintSampler
from ..training.gcl_module import GRACEModule
from ..training.kge_module import KGEModule
from ..training.optim import Optimizer
from ..training.stepping import TrainState, param_grads
from ..training.typed_train import (flat_real_to_device, make_typed_batch_loss,
                                    typed_update)
from ..models.typed import typed_batch_to_device
from .dp import (gather_params, init_spmd_state, make_dp_train_step,
                 make_dp_train_steps_scan, make_spmd_train_step)
from .graph_shard import (build_halo_plan, init_sharded_state,
                          make_sharded_train_step, partition_graph,
                          sharded_rgcn_encode)
from .mesh import make_mesh
from .sharding import param_layout

DIM = 64
SEED = 0
# loss within LOSS_RTOL of the reference's; parameters after one step
# within PARAM_RTOL / PARAM_ATOL (float32 sums that differ in order; one
# Adam step moves a weight by at most its learning rate); encodes within
# Z_RTOL of the reference's largest entry
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL, Z_RTOL = 1e-5, 1e-5, 1e-6, 2e-4
# Adam's eps in every leg: with eps near the gradients' size the update
# follows the gradient's magnitude, so a gradient off by a factor (the
# dp mean against the graph shard's sum) moves the parameters visibly
EPS = 1e-3


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def _gen(device, *key) -> torch.Generator:
    seed = int(np.random.SeedSequence(key).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _module(tg, device, layout: str, encoder: str = "rgcn",
            decoder: str = "dismult") -> KGEModule:
    module = KGEModule(
        encoder_name=encoder, decoder_name=decoder, in_dim=DIM,
        hidden_dim=DIM, out_dim=DIM, num_hidden_layers=1,
        num_relation=tg.num_edge_types, num_heads=2,
        scheduler_type="cosine", learning_rate=1e-3, warm_up_ratio=0.0,
        fuse_method="none", neg_ratio=2, node_init_method="random")
    return _ready(module, device, layout)


def _ready(module, device, layout: str):
    module.init(torch.Generator().manual_seed(SEED))
    module.edge_layout = layout
    module.configure_optimizers(num_training_steps=8)
    module.tx.eps = EPS
    return module.to(device)


def _params_err(got: Dict[str, torch.Tensor],
                want: Dict[str, torch.Tensor], what: str) -> float:
    worst = 0.0
    for name, w in want.items():
        g = got[name].detach().float()
        w = w.detach().float()
        err = (g - w).abs()
        _check(bool(torch.all(err <= PARAM_ATOL + PARAM_RTOL * w.abs())),
               f"{what}: {name} off by {float(err.max()):.3g}")
        worst = max(worst, float(err.max()))
    return worst


def _loss_err(got: float, want: float, what: str) -> float:
    err = abs(got - want)
    _check(err <= LOSS_RTOL * max(1.0, abs(want)),
           f"{what}: loss {got} against {want}")
    return err


def _serial_dp(module, batches, gens_of, steps: int):
    """The reference of ``steps`` dp steps: each step's gradients the mean
    of the batches' (generator ``gens_of(j, r)``) on one module."""
    ref = copy.deepcopy(module)
    state = ref.init_state()
    loss = None
    for j in range(steps):
        grads, losses = None, []
        for r, batch in enumerate(batches[j]):
            loss, _ = ref._forward_loss(batch, training=True,
                                        generator=gens_of(j, r))
            g = param_grads(loss, state.params)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            losses.append(float(loss.detach()))
        grads = [g / len(batches[j]) for g in grads]
        opt = ref.tx.update(grads, state.opt_state,
                            list(state.params.values()))
        state = state._replace(opt_state=opt, step=state.step + 1)
        loss = float(np.mean(losses))
    return dict(ref.named_parameters()), loss


def _spmd_leg(module, batches, mesh, device, key: int, what: str) -> dict:
    """One dp × tp step of ``module`` (dp row d on ``batches[d]``) against
    the single-device dp-mean step: the loss and the gathered
    parameters."""
    state = init_spmd_state(module, mesh)
    step = make_spmd_train_step(module, mesh)
    state, loss = step(state, batches[mesh.dp_rank],
                       _gen(device, SEED, key, mesh.dp_rank))
    got = gather_params(state.params, mesh, param_layout(module, mesh.tp))
    want, ref_loss = _serial_dp(module, [batches],
                                lambda j, r: _gen(device, SEED, key, r), 1)
    if dist.get_rank() == 0:
        print(f"[dryrun dp={mesh.dp} tp={mesh.tp}] {what} spmd step "
              f"loss={float(loss):.4f}")
    return {"loss": _loss_err(float(loss), ref_loss, what),
            "params": _params_err(got, want, what)}, float(loss)


def _dp_legs(tg, device, n, loader) -> dict:
    out = {}
    # 1. dp × tp: RGCN + DistMult and GRACE on dst batches, RGAT + ComplEx
    # on relation batches (GRACE's features scaled by 30, as the tests
    # scale them: its gradients then stand well above Adam's eps)
    tp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // tp
    mesh = make_mesh(dp=dp, tp=tp)
    batches = [batch_to_device(loader.sample()[0], device)
               for _ in range(dp)]
    relation = SaintRandomWalkSampler(
        tg.graph, batch_size=8, walk_length=5, num_steps=dp, block_size=256,
        seed=SEED, edge_layout="relation")
    rel_batches = [batch_to_device(relation.sample()[0], device)
                   for _ in range(dp)]
    grace = GRACEModule(in_dim=DIM, hidden_dim=DIM, out_dim=DIM,
                        num_hidden_layers=1, warm_up_ratio=0.0,
                        learning_rate=1e-3)
    legs = (("spmd_dp_tp", 1, _module(tg, device, "dst"), batches,
             "dp x tp step"),
            ("spmd_dp_tp_rgat_complex", 11,
             _module(tg, device, "relation", "rgat", "complex"),
             rel_batches, "dp x tp RGAT + ComplEx step"),
            ("spmd_dp_tp_grace", 12, _ready(grace, device, "dst"),
             [b._replace(x=b.x * 30.0) for b in batches],
             "dp x tp GRACE step"))
    for name, key, module, leg_batches, what in legs:
        out[f"{name}_err"], out[name] = _spmd_leg(
            module, leg_batches, mesh, device, key, what)

    # 2. dp, and 2b. dp × scan
    mesh = make_mesh(dp=n, tp=1)
    for k, key in ((1, "shard_map_dp"), (2, "dp_scan_fused")):
        module = _module(tg, device, "dst")
        groups = [[batch_to_device(loader.sample()[0], device)
                   for _ in range(n)] for _ in range(k)]
        want, ref_loss = _serial_dp(
            module, groups, lambda j, r: _gen(device, SEED, 2, j, r), k)
        state = module.init_state()
        mine = [g[mesh.dp_rank] for g in groups]
        gens = [_gen(device, SEED, 2, j, mesh.dp_rank) for j in range(k)]
        if k == 1:
            state, loss = make_dp_train_step(module, mesh)(state, mine[0],
                                                           gens[0])
        else:
            state, loss = make_dp_train_steps_scan(module, mesh, k)(
                state, mine, gens)
        _check(state.step == k, f"{key}: {state.step} steps")
        out[key] = float(loss)
        out[f"{key}_err"] = {
            "loss": _loss_err(float(loss), ref_loss, key),
            "params": _params_err(dict(module.named_parameters()), want,
                                  key)}
        if dist.get_rank() == 0:
            print(f"[dryrun dp={n} x scan_k={k}] loss={float(loss):.4f}")
    return out


def _graph_legs(tg, device, n) -> dict:
    out = {}
    mesh = make_mesh(dp=n, tp=1)
    g = tg.graph
    r = g.num_relations
    batch = FullGraphLoader(g, block_size=256).batch()
    encoder = RGCN(DIM, DIM, DIM, 1, r, drop_out=False)
    decoder = DistMult(r, DIM)
    gen = torch.Generator().manual_seed(SEED)
    encoder.init(gen)
    decoder.init(gen)
    encoder.to(device)
    decoder.to(device)
    full = batch_to_device(batch, device)
    with torch.no_grad():
        z_ref = encoder(full.x, full.edge_index, full.edge_type,
                        full.edge_mask, full.block_rel)

    # 3. the balanced encode
    plain = partition_graph(batch, n, r, block_size=256)
    sharded = partition_graph(batch, n, r, block_size=256, balance=True)
    z = sharded_rgcn_encode(encoder, sharded, mesh)
    z_orig = torch.empty_like(z)
    z_orig[torch.as_tensor(sharded.node_order, device=device)] = z
    real = full.node_mask
    scale = float(z_ref[real].abs().max())
    err = float((z_orig[real] - z_ref[real]).abs().max())
    _check(err <= Z_RTOL * scale, f"graph-sharded encode off by {err:.3g}")
    out["graph_sharded_encode_err"] = err
    if dist.get_rank() == 0:
        print(f"[dryrun graph-sharded x{n}] full-graph encode z"
              f"{tuple(z.shape)} == single-device forward "
              f"(max_abs_err {err:.3g}, balanced partition)")

    # 4. the training step, all_gather and halo, on fixed negatives,
    # each from the same weights, against one device's step
    k = 2
    e_p = sharded.edge_type.shape[1]
    fixed = np.random.default_rng(SEED).integers(
        0, g.num_nodes, (n, 2, k, e_p)).astype(np.int32)
    plan = build_halo_plan(sharded, sharded.x.shape[1])
    params = init_sharded_state(encoder, decoder, _adam()).params
    init = {name: p.detach().clone() for name, p in params.items()}

    def from_init():
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(init[name])
        tx = _adam()
        return tx, TrainState(params, tx.init(list(params.values())), 0)

    results = {}
    for leg, halo in (("graph_sharded", None), ("halo_exchange", plan)):
        tx, state = from_init()
        run = make_sharded_train_step(encoder, decoder, tx, mesh,
                                      neg_ratio=k, halo_plan=halo)
        state, loss = run(state, sharded, fixed_neg=fixed)
        results[leg] = (float(loss), {name: p.detach().clone()
                                      for name, p in params.items()})
    tx, state = from_init()
    ref = _sharded_reference_step(encoder, decoder, sharded, full, fixed,
                                  state, tx)
    for leg, (loss, got) in results.items():
        out[leg] = loss
        out[f"{leg}_err"] = {"loss": _loss_err(loss, ref, leg),
                             "params": _params_err(got, params, leg)}
    if dist.get_rank() == 0:
        print(f"[dryrun graph-sharded x{n}] TRAIN step loss="
              f"{out['graph_sharded']:.4f}; halo-exchange TRAIN step "
              f"loss={out['halo_exchange']:.4f} (halo={plan.halo} "
              f"rows/pair; single-device {ref:.4f}; parameters after the "
              f"step within {out['halo_exchange_err']['params']:.3g} / "
              f"{out['graph_sharded_err']['params']:.3g})")

    # the balance and communication volume of the graph shard
    shard_n, d_feat = sharded.x.shape[1], sharded.x.shape[2]
    edges = [int(m.sum()) for m in sharded.edge_mask]
    edges_plain = [int(m.sum()) for m in plain.edge_mask]
    ag_bytes = shard_n * d_feat * 4 * (n - 1)
    halo_bytes = n * plan.halo * d_feat * 4
    out["graph_shard"] = {
        "shard_rows": shard_n, "feature_dim": d_feat,
        "nodes_per_device": [int(m.sum()) for m in sharded.node_mask],
        "real_edges_per_device": edges,
        "edge_balance_max_over_min":
            round(max(edges) / max(1, min(edges)), 3),
        "edge_balance_contiguous_max_over_min":
            round(max(edges_plain) / max(1, min(edges_plain)), 3),
        "halo_rows_per_pair_padded": int(plan.halo),
        "halo_real_send_rows_per_device":
            [int(s) for s in plan.send_counts.sum(axis=1)],
        "all_gather_bytes_out_per_device_per_layer": int(ag_bytes),
        "halo_bytes_out_per_device_per_layer": int(halo_bytes),
        "halo_vs_all_gather_ratio": round(halo_bytes / max(1, ag_bytes), 4),
    }
    if dist.get_rank() == 0:
        print("[dryrun stats] " + json.dumps(out["graph_shard"]))

    # 6. sharded ranking, on the single-device z
    all6 = np.stack([g.edge_index[0], g.edge_type, g.edge_index[1]], axis=1)
    test6 = all6[np.random.default_rng(9).choice(all6.shape[0], size=40,
                                                 replace=False)]
    z6 = z_ref[:g.num_nodes].contiguous()
    single = filtered_ranking_metrics(decoder, z6, test6, all6, chunk=8)
    shard = filtered_ranking_metrics(decoder, z6, test6, all6, chunk=8,
                                     mesh=mesh)
    _check(shard == single, f"sharded ranking {shard} != {single}")
    out["eval_sharded_mrr"] = shard["mrr"]
    if dist.get_rank() == 0:
        print(f"[dryrun eval-sharded x{n}] filtered ranking "
              f"mrr={shard['mrr']:.4f} == single-device (40 triples, both "
              "directions)")
    return out


def _adam() -> Optimizer:
    """Adam at 1e-2 without the clip (optax.adam(1e-2, eps=EPS))."""
    return Optimizer(lambda step: 1e-2, grad_clip=float("inf"), eps=EPS)


def _sharded_reference_step(encoder, decoder, sharded, full, fixed, state,
                            tx) -> float:
    """One device's step over the shards' edges and negatives on the
    full-batch encode (ids in shard order mapped back by ``node_order``):
    updates ``state``'s parameters in place; returns the loss."""
    device = full.x.device
    z = encoder(full.x, full.edge_index, full.edge_type, full.edge_mask,
                full.block_rel)
    order = torch.as_tensor(sharded.node_order, device=device)
    num = den = 0.0
    for p in range(sharded.x.shape[0]):
        ei = torch.as_tensor(sharded.edge_index[p].astype(np.int64),
                             device=device)
        src, dst = order[ei[0]], order[ei[1]]
        et = torch.as_tensor(sharded.edge_type[p].astype(np.int64),
                             device=device)
        em = torch.as_tensor(sharded.edge_mask[p], device=device).float()
        fneg = torch.as_tensor(fixed[p].astype(np.int64), device=device)
        pos = decoder.score(z, src, dst, et)
        neg = decoder.score_neg(z, order[fneg[0]], order[fneg[1]],
                                et).reshape(-1)
        pred = torch.cat([pos, neg])
        gt = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
        w = torch.cat([em, em.repeat(fneg.shape[1])])
        per = -(gt * torch.nn.functional.logsigmoid(pred)
                + (1 - gt) * torch.nn.functional.logsigmoid(-pred))
        num = num + torch.sum(per * w)
        den = den + torch.sum(w)
    nm = full.node_mask.float()
    reg_z = torch.sum(z ** 2 * nm[:, None]) / (nm.sum() * z.shape[1])
    reg_rel = torch.mean(decoder.rel_emb ** 2)
    loss = num / den + 1e-2 * (reg_z + reg_rel)
    tx.update(param_grads(loss, state.params), state.opt_state,
              list(state.params.values()))
    return float(loss.detach())


def _typed_leg(device, n) -> dict:
    from .typed_shard import make_typed_spmd_step

    mesh = make_mesh(dp=n, tp=1)
    rng = np.random.default_rng(5)
    tg = TripletGraph(synthetic_triplets(num_gene=80, num_drug=40,
                                         num_disease=30, num_edges=1200,
                                         seed=5),
                      encoder=lambda ns: rng.standard_normal(
                          (len(ns), 32)).astype(np.float32))
    sampler = TypedSaintSampler(tg.graph, tg.node_type_of,
                                tg.node_type_names, batch_size=8,
                                walk_length=4, num_steps=1, seed=5)
    batch = sampler.sample()
    flat, n_real = flat_real_to_device(sampler, batch, device)
    r = tg.graph.num_relations
    results = []
    for sharded in (False, True):
        encoder = RGCN(32, 32, 16, 1, r, drop_out=True)
        decoder = DistMult(r, 16)
        gen = torch.Generator().manual_seed(5)
        encoder.init(gen)
        decoder.init(gen)
        encoder.to(device)
        decoder.to(device)
        params = {f"encoder.{k}": p for k, p in encoder.named_parameters()}
        params.update({f"decoder.{k}": p
                       for k, p in decoder.named_parameters()})
        tx = Optimizer(lambda step: 1e-3, grad_clip=1.0, eps=EPS)
        opt = tx.init(list(params.values()))
        draws = _gen(device, SEED, 5)
        if sharded:
            step = make_typed_spmd_step(encoder, decoder, tx, mesh, batch,
                                        neg_ratio=2)
            opt, loss = step(params, opt, batch, flat, n_real, draws)
        else:
            loss = make_typed_batch_loss(encoder, decoder, 2)(
                typed_batch_to_device(batch, device), flat, n_real,
                generator=draws)
            opt = typed_update(loss, params, tx, opt)
        results.append((float(loss.detach()), params))
    (ref_loss, ref_params), (loss, got) = results
    out = {"typed_sharded": loss,
           "typed_sharded_err": {
               "loss": _loss_err(loss, ref_loss, "typed sharded step"),
               "params": _params_err(got, ref_params,
                                     "typed sharded step")}}
    if dist.get_rank() == 0:
        print(f"[dryrun typed-sharded x{n}] hetero step loss={loss:.4f} "
              f"(single-device {ref_loss:.4f})")
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Every parallel strategy on this rank of an initialised group of
    ``n_devices`` ranks, on ``device`` (this rank's card, or the CPU);
    returns each leg's loss and error against its single-device
    reference, and the graph shard's stats."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs in a group "
                           f"of {n_devices} ranks, this one has {world}")
    device = torch.device("cpu" if device is None else device)
    tg = TripletGraph(synthetic_triplets(num_gene=120, num_drug=50,
                                         num_disease=30, num_edges=1500,
                                         seed=SEED),
                      encoder=RandomEncode(embed_dim=DIM))
    loader = SaintRandomWalkSampler(tg.graph, batch_size=8, walk_length=5,
                                    num_steps=4, block_size=256, seed=SEED,
                                    edge_layout="dst")
    out = {"n_devices": n_devices}
    out.update(_dp_legs(tg, device, n_devices, loader))
    out.update(_graph_legs(tg, device, n_devices))
    out.update(_typed_leg(device, n_devices))
    return out

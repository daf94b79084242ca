"""The rank side of the port's multi-rank CPU tests
(test_torch_parallel_{graph,dp,tp,typed_rank}.py); no tests of its own.
``parallel.launch.run_local_ranks`` runs these functions on each gloo
rank. They import torch and the port only (never JAX), take numpy inputs
the test process made (parameters, batches, the reference's draws) and
return numpy results for the test process to hold against the JAX
package."""

import numpy as np
import torch

from biomedkg_tpu_torch.interop.jax_params import flatten_tree, \
    load_jax_params
from biomedkg_tpu_torch.models import decoders
from biomedkg_tpu_torch.models.encoders import RGCN
from biomedkg_tpu_torch.models.factory import GAE
from biomedkg_tpu_torch.parallel import graph_shard
from biomedkg_tpu_torch.parallel.mesh import make_mesh
from biomedkg_tpu_torch.sampling.batch import GraphBatch, batch_to_device
from biomedkg_tpu_torch.training.optim import Optimizer

def _np(named):
    return {k: v.detach().cpu().numpy().copy() for k, v in named.items()}


# Adam's eps in the parameter comparisons: one step's update then follows
# the gradient's size (with 1e-8 it is ±lr wherever |g| >> 1e-8, so a
# gradient wrong by a factor would not show, and a near-zero gradient's
# summation-order noise decides its sign)
EPS = 1e-3


def adam(lr, eps=EPS):
    """optax.adam(lr, eps=eps): Adam without the clip."""
    return Optimizer(lambda step: lr, grad_clip=float("inf"), eps=eps)


def port_batch(fields) -> GraphBatch:
    return GraphBatch(*[np.asarray(fields[f]) for f in GraphBatch._fields])


# -- graph_shard -----------------------------------------------------------

def _graph_models(p):
    enc = RGCN(p["dim"], p["dim"], p["dim"], 1, p["num_rel"],
               drop_out=p.get("drop_out", False))
    dec = decoders.DistMult(p["num_rel"], p["dim"])
    load_jax_params(GAE(enc, dec), {"model": p["params"]})
    return enc, dec


def graph_worker(rank, p):
    mesh = make_mesh(dp=p["world"], tp=1)
    batch = port_batch(p["batch"])
    r = p["num_rel"]
    out = {}
    plain = graph_shard.partition_graph(batch, p["world"], r, block_size=64)
    bal = graph_shard.partition_graph(batch, p["world"], r, block_size=64,
                                      balance=True)
    plan = graph_shard.build_halo_plan(plain, plain.x.shape[1])
    plan_bal = graph_shard.build_halo_plan(bal, bal.x.shape[1])
    enc, dec = _graph_models(p)
    out["z_all_gather"] = graph_shard.sharded_rgcn_encode(
        enc, plain, mesh).numpy()
    out["z_halo"] = graph_shard.sharded_rgcn_encode(
        enc, plain, mesh, halo_plan=plan).numpy()
    out["z_balanced"] = graph_shard.sharded_rgcn_encode(enc, bal,
                                                        mesh).numpy()
    out["z_balanced_halo"] = graph_shard.sharded_rgcn_encode(
        enc, bal, mesh, halo_plan=plan_bal).numpy()
    for leg, halo in (("all_gather", None), ("halo", plan)):
        enc, dec = _graph_models(p)
        tx = adam(1e-2)
        state = graph_shard.init_sharded_state(enc, dec, tx)
        run = graph_shard.make_sharded_train_step(
            enc, dec, tx, mesh, neg_ratio=p["k"], halo_plan=halo)
        state, loss = run(state, plain, fixed_neg=p["fixed_neg"])
        out[f"train_{leg}"] = (float(loss), _np(state.params))

    # sampled negatives: the draws the step scores, and the loss over steps
    enc, dec = _graph_models(p)
    seen = []
    score_neg = dec.score_neg

    def recording(z, ns, nd, rel):
        seen.append((ns.clone(), nd.clone()))
        return score_neg(z, ns, nd, rel)

    dec.score_neg = recording
    tx = adam(5e-3)
    state = graph_shard.init_sharded_state(enc, dec, tx)
    run = graph_shard.make_sharded_train_step(enc, dec, tx, mesh,
                                              neg_ratio=4)
    gen = torch.Generator().manual_seed(100 + rank)
    losses = []
    for _ in range(p["sampled_steps"]):
        state, loss = run(state, plain, gen)
        losses.append(float(loss))
    draws = torch.stack([torch.stack(d) for d in seen]).numpy()
    out["sampled"] = (losses, int(draws.min()), int(draws.max()))

    # dropout: the keep share of the masks the training step draws
    p_drop = dict(p, drop_out=True)
    enc, dec = _graph_models(p_drop)
    kept = []
    dropout = graph_shard.dropout

    def recording_dropout(x, keep, rate):
        kept.append(keep.float().mean().item())
        return dropout(x, keep, rate)

    graph_shard.dropout = recording_dropout
    try:
        tx = adam(1e-2)
        state = graph_shard.init_sharded_state(enc, dec, tx)
        run = graph_shard.make_sharded_train_step(enc, dec, tx, mesh,
                                                  neg_ratio=2)
        gen = torch.Generator().manual_seed(200 + rank)
        for _ in range(4):
            state, _ = run(state, plain, gen)
    finally:
        graph_shard.dropout = dropout
    out["keep_share"] = kept
    return out


# -- dp, dp × scan, GRACE, the Trainer, dp × tp ----------------------------

def _kge_module(p):
    from biomedkg_tpu_torch.training.kge_module import KGEModule

    module = KGEModule(**p["hparams"])
    module.edge_layout = "dst"
    load_jax_params(module.model, p["params"])
    module.configure_optimizers(p["num_training_steps"])
    module.tx.eps = EPS
    return module


def _draws(d):
    """A rank's injected KGE draws (numpy) as the module takes them."""
    ns, nd, off = (torch.from_numpy(np.asarray(a)) for a in d["negatives"])
    return {"negatives": (ns, nd, off.long()),
            "dropout_masks": [torch.from_numpy(np.asarray(m))
                              for m in d["masks"]]}


def _gcl_draws(d):
    def t(a):
        return torch.from_numpy(np.asarray(a))

    return {"feat_keep": [t(a) for a in d["feat_keep"]],
            "edge_keep": [t(a) for a in d["edge_keep"]],
            "dropout": [[t(m) for m in ms] for ms in d["dropout"]]}


def dp_worker(rank, p):
    from biomedkg_tpu_torch.parallel.dp import (
        gather_params, init_spmd_state, make_dp_train_step,
        make_dp_train_steps_scan, make_spmd_train_step)
    from biomedkg_tpu_torch.parallel.sharding import param_layout
    from biomedkg_tpu_torch.training import gcl_module

    out = {}
    mesh = make_mesh(dp=p["world"], tp=1)
    # one dp step
    module = _kge_module(p)
    batch = batch_to_device(port_batch(p["dp_batches"][rank]), "cpu")
    state = module.init_state()
    state, loss = make_dp_train_step(module, mesh)(
        state, batch, **_draws(p["dp_draws"][rank]))
    out["dp"] = (float(loss), _np(dict(module.model.named_parameters())))

    # k = 2 steps in one call
    module = _kge_module(p)
    state = module.init_state()
    batches = [batch_to_device(port_batch(b), "cpu")
               for b in p["scan_batches"][rank]]
    state, loss = make_dp_train_steps_scan(module, mesh, 2)(
        state, batches, draws=[_draws(d) for d in p["scan_draws"][rank]])
    out["scan"] = (float(loss), state.step,
                   _np(dict(module.model.named_parameters())))

    # GRACE
    g = p["grace"]
    module = gcl_module.GCL_CLASSES["grace"](**g["hparams"])
    module.edge_layout = "dst"
    load_jax_params(module.model, g["params"])
    module.configure_optimizers(g["num_training_steps"])
    module.tx.eps = EPS
    state = module.init_state()
    batch = batch_to_device(port_batch(g["batches"][rank]), "cpu")
    state, loss = make_dp_train_step(module, mesh)(
        state, batch, draws=_gcl_draws(g["draws"][rank]))
    out["grace"] = (float(loss), _np(dict(module.model.named_parameters())))

    # dp × tp: (2, 2), rank d·2 + t takes batch d and its draws
    mesh = make_mesh(dp=2, tp=2)
    module = _kge_module(p)
    state = init_spmd_state(module, mesh)
    batch = batch_to_device(port_batch(p["dp_batches"][mesh.dp_rank]),
                            "cpu")
    d = _draws(p["tp_draws"][mesh.dp_rank])
    state, loss = make_spmd_train_step(module, mesh)(
        state, batch, negatives=d["negatives"],
        dropout_masks=d["dropout_masks"])
    out["tp"] = (float(loss), _np(gather_params(
        state.params, mesh, param_layout(module, mesh.tp))))
    return out


def _to_torch(obj):
    """numpy arrays (in lists and dicts) as tensors."""
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_torch(v) for v in obj]
    return torch.from_numpy(np.array(obj))


def _tp_draws(d):
    """A dp row's injected draws (numpy) as the module takes them: the
    permutations, the sorted offsets and the iid endpoints as int64."""
    out = _to_torch(d)
    if "draws" in out:
        g = out["draws"]
        if "perm" in g:
            g["perm"] = g["perm"].long()
        return out
    neg = out["negatives"]
    out["negatives"] = (tuple(neg[:2]) + (neg[2].long(),) if len(neg) == 3
                        else tuple(a.long() for a in neg))
    if "filter_draws" in out:
        out["filter_draws"] = [tuple(r) for r in out["filter_draws"]]
    return out


def _tp_module(c):
    from biomedkg_tpu_torch.training import gcl_module
    from biomedkg_tpu_torch.training.kge_module import KGEModule

    if isinstance(c["model"], str):
        module = gcl_module.GCL_CLASSES[c["model"]](**c["hparams"])
    else:
        module = KGEModule(**c["hparams"])
    module.edge_layout = c["layout"]
    for k, v in c["attrs"].items():
        setattr(module, k, v)
    load_jax_params(module.model, c["params"], module.fusion)
    module.configure_optimizers(c["num_training_steps"])
    module.tx.eps = EPS
    return module


def _recording(tx):
    """[the gradients of ``tx``'s last update], filled as it updates."""
    seen = [None]
    update = tx.update

    def recording(grads, *args, **kwargs):
        seen[0] = [g.detach().clone() for g in grads]
        return update(grads, *args, **kwargs)

    tx.update = recording
    return seen


def tp_worker(rank, p):
    from biomedkg_tpu_torch.parallel.dp import (
        gather_params, init_spmd_state, make_spmd_train_step, shard_params)
    from biomedkg_tpu_torch.parallel.dryrun import _serial_dp
    from biomedkg_tpu_torch.parallel.sharding import param_layout

    out = {"cases": {}, "round_trips": {}}
    for name, c in p["cases"].items():
        mesh = make_mesh(*c["mesh"])
        module = _tp_module(c)
        seen = _recording(module.tx)
        state = init_spmd_state(module, mesh)
        batch = batch_to_device(port_batch(c["batches"][mesh.dp_rank]),
                                "cpu")
        state, loss = make_spmd_train_step(module, mesh)(
            state, batch, **_tp_draws(c["draws"][mesh.dp_rank]))
        layout = param_layout(module, mesh.tp)
        out["cases"][name] = (
            float(loss), _np(gather_params(state.params, mesh, layout)),
            _np(gather_params(dict(zip(state.params, seen[0])), mesh,
                              layout)))

    for (name, c), tp in [(item, tp) for item in p["round_trips"].items()
                          for tp in (2, 4)]:
        mesh = make_mesh(dp=p["world"] // tp, tp=tp)
        rgat = c["hparams"]["encoder_name"] == "rgat"
        module = _tp_module(dict(c, model=None, attrs={},
                                 layout="relation" if rgat else "dst",
                                 num_training_steps=1))
        layout = param_layout(module, tp)
        shards = shard_params(module, mesh)
        whole = gather_params(shards, mesh, layout)
        named = dict(module.named_parameters())
        out["round_trips"][(name, tp)] = (
            all(torch.equal(whole[k], v) for k, v in named.items()),
            all(shards[k].shape[s[0]] * tp == v.shape[s[0]]
                for k, v in named.items() if (s := layout[k]) is not None))

    # the draws from a generator, alike on a dp row's tp ranks
    g = p["generator"]
    mesh = make_mesh(dp=2, tp=2)
    c = dict(g, model=None, layout="dst", attrs={}, num_training_steps=10)
    module = _tp_module(c)
    batches = [batch_to_device(port_batch(b), "cpu") for b in g["batches"]]
    state = init_spmd_state(module, mesh)
    state, loss = make_spmd_train_step(module, mesh)(
        state, batches[mesh.dp_rank],
        torch.Generator().manual_seed(50 + mesh.dp_rank))
    got = gather_params(state.params, mesh, param_layout(module, mesh.tp))
    want, ref_loss = _serial_dp(module, [batches],
                                lambda j, r: torch.Generator().manual_seed(
                                    50 + r), 1)
    out["generator"] = (abs(float(loss) - ref_loss), all(
        torch.allclose(got[k], w, rtol=1e-5, atol=1e-6)
        for k, w in want.items()))
    return out


def trainer_worker(rank, p):
    from biomedkg_tpu_torch.data.node_encoders import RandomEncode
    from biomedkg_tpu_torch.data.synthetic import synthetic_triplets
    from biomedkg_tpu_torch.data.triplet import TripletGraph
    from biomedkg_tpu_torch.sampling.saint import SaintRandomWalkSampler
    from biomedkg_tpu_torch.training.kge_module import KGEModule
    from biomedkg_tpu_torch.training.trainer import Trainer

    tg = TripletGraph(synthetic_triplets(num_gene=100, num_drug=40,
                                         num_disease=30, num_edges=1200,
                                         seed=5),
                      encoder=RandomEncode(embed_dim=16))
    loader = SaintRandomWalkSampler(tg.graph, batch_size=8, walk_length=4,
                                    num_steps=p["steps"], block_size=32,
                                    seed=0, edge_layout="dst")
    module = KGEModule(**dict(p["hparams"],
                              num_relation=tg.num_edge_types))
    module.edge_layout = "dst"
    trainer = Trainer(max_epochs=2, devices=p["world"],
                      enable_checkpointing=False, enable_progress_bar=False)
    trainer.fit(module, loader)
    flat = torch.cat([t.detach().reshape(-1)
                      for t in module.parameters()]).double()
    return {"global_step": trainer.global_step,
            "losses": [h["train_loss_epoch"] for h in trainer.history],
            "checksum": (float(flat.sum()), float((flat ** 2).sum()),
                         flat.numpy().tobytes())}


# -- typed tables, ranking, the dry run ------------------------------------

def typed_rank_worker(rank, p):
    from biomedkg_tpu_torch.eval.ranking import filtered_ranking_metrics
    from biomedkg_tpu_torch.parallel.dryrun import dryrun_multichip
    from biomedkg_tpu_torch.parallel.typed_shard import make_typed_spmd_step
    from biomedkg_tpu_torch.sampling.typed_batch import TypedBatch

    out = {}
    t = p["typed"]
    mesh = make_mesh(dp=p["world"], tp=1)
    enc = RGCN(t["dim"], 32, 16, 1, t["num_rel"], drop_out=False)
    dec = decoders.DistMult(t["num_rel"], 16)
    load_jax_params(GAE(enc, dec), {"model": t["params"]})
    params = {f"encoder.{k}": v for k, v in enc.named_parameters()}
    params.update({f"decoder.{k}": v for k, v in dec.named_parameters()})
    tx = adam(1e-3)
    batch = TypedBatch(**t["batch"])
    step = make_typed_spmd_step(enc, dec, tx, mesh, batch, neg_ratio=4)
    opt, loss = step(params, tx.init(list(params.values())), batch,
                     torch.as_tensor(t["flat"]).long(), int(t["n_real"]),
                     negatives=tuple(torch.as_tensor(a).long()
                                     for a in t["negatives"]))
    out["typed"] = (float(loss), _np(params))

    r = p["ranking"]
    dec = decoders.DistMult(r["num_rel"], r["z"].shape[1])
    with torch.no_grad():
        dec.rel_emb.copy_(torch.from_numpy(r["rel_emb"]))
    z = torch.from_numpy(r["z"])
    out["ranking"] = [
        (filtered_ranking_metrics(dec, z, r["test"], r["known"],
                                  chunk=chunk),
         filtered_ranking_metrics(dec, z, r["test"], r["known"],
                                  chunk=chunk, mesh=mesh))
        for chunk in r["chunks"]]
    out["dryrun"] = dryrun_multichip(p["world"])
    return out


def flat_params(tree):
    """A JAX params tree flattened by dotted name (numpy)."""
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}

"""The parallel strategies' host side and single-process surface
(biomedkg_tpu_torch/parallel/) against the JAX package: the graph
partition, the LPT relabelling and the halo plan byte for byte, the batch
stacking, the tensor-parallel layout against ``_spec_for``, the Trainer's
``devices`` forms, and what one process does (a one-rank mesh, the
collectives over no group, the launcher's card count)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from biomedkg_tpu.data.node_encoders import RandomEncode
from biomedkg_tpu.data.synthetic import synthetic_triplets
from biomedkg_tpu.data.triplet import TripletGraph
from biomedkg_tpu.parallel import dp as jax_dp
from biomedkg_tpu.parallel import graph_shard as jax_gs
from biomedkg_tpu.parallel.sharding import _spec_for
from biomedkg_tpu.sampling.loaders import FullGraphLoader, \
    SaintRandomWalkLoader
from biomedkg_tpu.training.kge_module import KGEModule as JaxKGEModule
from biomedkg_tpu_torch.parallel import collectives, dp, graph_shard, launch
from biomedkg_tpu_torch.parallel.mesh import (distributed_init_if_needed,
                                              host_local_batch_seed,
                                              make_mesh)
from biomedkg_tpu_torch.parallel.sharding import param_shard_dims
from biomedkg_tpu_torch.sampling.batch import GraphBatch
from biomedkg_tpu_torch.training.trainer import Trainer

DIM = 16


@pytest.fixture(scope="module")
def graph():
    return TripletGraph(synthetic_triplets(num_gene=100, num_drug=40,
                                           num_disease=30, num_edges=1200,
                                           seed=5),
                        encoder=RandomEncode(embed_dim=DIM))


@pytest.fixture(scope="module")
def batch(graph):
    return FullGraphLoader(graph.graph, block_size=64).batch()


def _port(b) -> GraphBatch:
    return GraphBatch(**{f: np.asarray(getattr(b, f))
                         for f in GraphBatch._fields})


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shards", [1, 4, 8])
@pytest.mark.parametrize("balance", [False, True])
def test_partition_graph_is_byte_identical(graph, batch, shards, balance):
    r = graph.num_edge_types
    got = graph_shard.partition_graph(_port(batch), shards, r,
                                      block_size=64, balance=balance)
    want = jax_gs.partition_graph(batch, shards, r, block_size=64,
                                  balance=balance)
    for f in jax_gs.ShardedGraph._fields:
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_balanced_node_order_is_byte_identical(batch, shards):
    _same(graph_shard.balanced_node_order(_port(batch), shards),
          jax_gs.balanced_node_order(batch, shards))


@pytest.mark.parametrize("balance", [False, True])
def test_halo_plan_is_byte_identical(graph, batch, balance):
    r = graph.num_edge_types
    sharded = jax_gs.partition_graph(batch, 4, r, block_size=64,
                                     balance=balance)
    got = graph_shard.build_halo_plan(
        graph_shard.ShardedGraph(*sharded), sharded.x.shape[1])
    want = jax_gs.build_halo_plan(sharded, sharded.x.shape[1])
    assert got.halo == want.halo
    for f in ("send_idx", "src_remap", "send_counts"):
        _same(getattr(got, f), getattr(want, f))


def test_partition_refuses_a_budget_that_does_not_divide(batch, graph):
    with pytest.raises(ValueError, match="divide"):
        graph_shard.partition_graph(_port(batch), 3, graph.num_edge_types,
                                    block_size=64)


def test_stacking_is_byte_identical(graph):
    loader = SaintRandomWalkLoader(graph.graph, batch_size=8, walk_length=4,
                                   num_steps=8, block_size=32, seed=0,
                                   edge_layout="dst")
    batches = [loader.sample()[0] for _ in range(4)]
    got = dp.stack_batches([_port(b) for b in batches])
    want = jax_dp.stack_batches(batches)
    for f in GraphBatch._fields:
        _same(getattr(got, f), getattr(want, f))
    got = dp.stack_batch_groups([got, got])
    want = jax_dp.stack_batch_groups([want, want])
    for f in GraphBatch._fields:
        _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("encoder,decoder", [
    ("rgcn", "dismult"), ("rgat", "complex"), ("rgcn", "rotate")])
def test_shard_dims_match_spec_for(encoder, decoder):
    jm = JaxKGEModule(
        encoder_name=encoder, decoder_name=decoder, in_dim=DIM,
        hidden_dim=DIM, out_dim=DIM, num_hidden_layers=1, num_relation=4,
        num_heads=2, scheduler_type="cosine", learning_rate=1e-3,
        warm_up_ratio=0.2, fuse_method="attention", neg_ratio=2,
        node_init_method="lm")
    params = jm.init(jax.random.PRNGKey(0))
    named = _leaves(params)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        spec = tuple(_spec_for(path, leaf))
        want[_name(path)] = spec.index("tp") if "tp" in spec else None
    got = param_shard_dims(named)
    assert got == want
    assert any(d is not None for d in got.values())


def _name(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                    for p in path)


def _leaves(params):
    return {_name(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(params)}


def test_one_process_mesh_and_collectives():
    mesh = make_mesh()
    assert (mesh.dp, mesh.tp, mesh.rank, mesh.size) == (1, 1, 0, 1)
    assert mesh.dp_group is None and mesh.tp_group is None
    x = torch.arange(6.0).reshape(3, 2)
    for fn in (collectives.all_gather, collectives.all_to_all,
               collectives.psum_replicated, collectives.psum,
               collectives.all_gather_cols):
        assert torch.equal(fn(x, None), x)
    (g,) = collectives.all_reduce_grads([x], None, divisor=2)
    assert torch.equal(g, x / 2)
    assert host_local_batch_seed(7) == 7
    with pytest.raises(RuntimeError, match="parallel.launch"):
        make_mesh(dp=2)


def test_gradient_buckets_cover_every_gradient(monkeypatch):
    """The flat buckets (at most BUCKET_BYTES, one dtype each) carry every
    element back to its own tensor."""
    monkeypatch.setattr(collectives, "BUCKET_BYTES", 64)
    monkeypatch.setattr(collectives, "group_size", lambda group: 2)
    calls = []
    monkeypatch.setattr(collectives.dist, "all_reduce",
                        lambda t, group=None: (calls.append(t.numel()),
                                               t.mul_(2)))
    grads = [torch.arange(n, dtype=dt) for n, dt in
             ((5, torch.float32), (20, torch.float32), (3, torch.float64),
              (2, torch.float32))]
    out = collectives.all_reduce_grads(grads, object(), divisor=2)
    for g, o in zip(grads, out):
        assert torch.equal(o, g)          # (2·g) / 2
    assert len(calls) == 4 and sum(calls) == 30
    assert all(n * 8 <= 64 or n == 20 for n in calls)


@pytest.mark.parametrize("devices,present,want", [
    (None, 8, 1), ("0,1", 2, 2), ("0,", 2, 1), ([0, 1, 2], 4, 3),
    ("2", 4, 2), (3, 4, 3), ("auto", 4, 4), (-1, 2, 2)])
def test_trainer_devices_forms(devices, present, want, monkeypatch):
    """Lightning's forms, clamped to the cards present (the JAX Trainer's
    ``_resolve_dp`` rules)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: present)
    assert Trainer(devices=devices)._resolve_dp(torch.device("cuda")) \
        == want
    assert launch.cards_asked(devices, "cpu") == 1


def test_trainer_devices_clamp_and_drop_with_a_warning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.warns(UserWarning, match="present"):
        assert Trainer(devices=4)._resolve_dp(torch.device("cuda")) == 2
    with pytest.warns(UserWarning, match="dropped"):
        assert Trainer(devices="0,9")._resolve_dp(torch.device("cuda")) == 1
    # without a group the CPU is one device
    with pytest.warns(UserWarning, match="present"):
        assert Trainer(devices=4)._resolve_dp(torch.device("cpu")) == 1


def test_launcher_runs_a_module_per_rank(tmp_path):
    """``python -m biomedkg_tpu_torch.parallel.launch --nproc 2 <module>``
    starts two processes with torchrun's variables set."""
    mod = tmp_path / "show_rank.py"
    mod.write_text("import os\nprint('rank', os.environ['RANK'], 'of', "
                   "os.environ['WORLD_SIZE'], os.environ['LOCAL_RANK'])\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-m", "biomedkg_tpu_torch.parallel.launch",
         "--nproc", "2", "show_rank"], capture_output=True, text=True,
        timeout=120, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": f"{tmp_path}:{root}"})
    assert run.returncode == 0, run.stderr
    assert sorted(run.stdout.split("\n")[:2]) == ["rank 0 of 2 0",
                                                  "rank 1 of 2 1"]


def _stub_cards(monkeypatch, count):
    """Two-or-more-card host on the CPU: torch.cuda answers as if cards
    were there; ``set_device`` records its calls."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    return calls


def test_single_process_keeps_its_card(monkeypatch):
    """A single process keeps the card it names; a launched rank moves
    to cuda:LOCAL_RANK (its group is not started here: WORLD_SIZE 1)."""
    calls = _stub_cards(monkeypatch, 2)
    for var in ("WORLD_SIZE", "LOCAL_RANK", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init_if_needed("cuda:1") == torch.device("cuda", 1)
    assert distributed_init_if_needed("cpu") == torch.device("cpu")
    assert calls == []
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed_init_if_needed("cuda") == torch.device("cuda", 1)
    assert calls == [1]


def test_typed_tables_refuse_a_group_and_run_one_process(monkeypatch):
    """``train_kge typed_tables=true`` launched as two ranks raises (no
    data-parallel typed training); asked for two cards as one process it
    warns and trains in this process, re-launching nothing."""
    from biomedkg_tpu_torch import train_kge
    from biomedkg_tpu_torch.config import (CONFIG_DIR, cli_overrides,
                                           load_config)

    args = ["typed_tables=true", "device=cpu"]
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 12c"):
        train_kge.train(load_config(CONFIG_DIR, "kge", cli_overrides(args)))
    monkeypatch.delenv("WORLD_SIZE")
    _stub_cards(monkeypatch, 2)
    monkeypatch.setattr(train_kge, "per_card", lambda *a: pytest.fail(
        "typed_tables re-launched itself"))
    monkeypatch.setattr(train_kge, "train", lambda cfg: "trained")
    with pytest.warns(UserWarning, match="one card"):
        assert train_kge.main(["typed_tables=true", "devices=0,1"]) \
            == "trained"

"""The opt-in RGCN variants, profiling and the import aliases against the
JAX package: ``agg_conv`` and ``take_rows_via_perm`` (forward and
gradients, tests/test_ops.py's shapes), a whole dst-layout KGE step with
``dst_bwd`` "agg", "perm" and ``remat=True`` equal to the "scatter" step
(loss 1e-5, gradients 2e-4, as tests/test_stepping.py:55 holds JAX's),
RGAT refusing the variants, ``trace``, ``debug_nans``, and
the aliases' names."""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.ops.aggconv import agg_conv as jax_agg_conv
from biomedkg_tpu.ops.segment import take_rows_via_perm as jax_via_perm
from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.training.kge_module import KGEModule as JaxKGEModule
from biomedkg_tpu_torch.interop.jax_params import load_jax_params
from biomedkg_tpu_torch.ops.aggconv import agg_conv
from biomedkg_tpu_torch.ops.segment import take_rows_via_perm
from biomedkg_tpu_torch.sampling.batch import (batch_to_device,
                                               pad_graph_batch)
from biomedkg_tpu_torch.training.kge_module import KGEModule
from biomedkg_tpu_torch.training.stepping import param_grads
from biomedkg_tpu_torch.utils import profiling

N, E, R, D = 50, 300, 4, 16


def _batch(seed=0, edge_budget=512, x_dim=D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, x_dim)).astype(np.float32)
    ei = rng.integers(0, N, (2, E)).astype(np.int64)
    et = rng.integers(0, R, E).astype(np.int32)
    kw = dict(num_relations=R, node_budget=64, edge_budget=edge_budget,
              block_size=64, layout="dst")
    return jax_pad(x, ei, et, **kw), pad_graph_batch(x, ei, et, **kw)


def _copy_args(b):
    """agg_conv's sorted keys and masked norms, from numpy."""
    src, dst = b.edge_index[0].astype(np.int64), b.edge_index[1]
    et, mask = b.edge_type.astype(np.int64), b.edge_mask
    se = b.src_edges.astype(np.int64)
    cnt = np.zeros((64, R), np.float32)
    np.add.at(cnt, (dst[mask], et[mask]), 1.0)
    norm = mask / np.maximum(cnt[dst, et], 1.0)
    norm2 = se[3] / np.maximum(cnt[se[1], se[2]], 1.0)
    return dict(src=src, key=dst * R + et, norm=norm.astype(np.float32),
                s2=se[0], key2=se[1] * R + se[2],
                norm2=norm2.astype(np.float32))


def test_agg_conv_matches_jax():
    _, b = _batch()
    a = _copy_args(b)
    assert (np.diff(a["key"]) >= 0).all() and (np.diff(a["s2"]) >= 0).all()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, D)).astype(np.float32)
    w = rng.standard_normal((R, D, 8)).astype(np.float32)
    cot = rng.standard_normal((64, 8)).astype(np.float32)

    def jax_loss(xx, ww):
        out = jax_agg_conv(xx, ww, a["src"].astype(np.int32),
                           a["key"].astype(np.int32), a["norm"],
                           a["s2"].astype(np.int32),
                           a["key2"].astype(np.int32), a["norm2"])
        return jnp.sum(out * cot), out

    (_, want), (gx, gw) = jax.value_and_grad(jax_loss, (0, 1),
                                             has_aux=True)(x, w)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    out = agg_conv(tx, tw, t["src"], t["key"].int(), t["norm"],
                   t["s2"].int(), t["key2"], t["norm2"])
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-5)


def test_take_rows_via_perm_matches_jax():
    _, b = _batch()
    se = b.src_edges.astype(np.int64)
    key2 = se[0] * R + se[2]
    flat = b.edge_index[0].astype(np.int64) * R + b.edge_type
    real = se[3].astype(bool)
    np.testing.assert_array_equal(flat[b.src_pos[real]], key2[real])
    rng = np.random.default_rng(2)
    table = rng.standard_normal((64 * R, D)).astype(np.float32)
    # pads carry a zero gradient (the caller's contract)
    cot = rng.standard_normal((len(flat), D)).astype(np.float32) \
        * b.edge_mask[:, None]

    def jax_loss(t):
        out = jax_via_perm(t, flat.astype(np.int32),
                           b.src_pos.astype(np.int32),
                           key2.astype(np.int32), 3, 0)
        return jnp.sum(out * cot), out

    (_, want), g = jax.value_and_grad(jax_loss, has_aux=True)(table)
    t = torch.from_numpy(table).requires_grad_()
    out = take_rows_via_perm(t, torch.from_numpy(flat),
                             torch.from_numpy(b.src_pos.astype(np.int64)),
                             torch.from_numpy(key2).int())
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                               atol=1e-6)


HP = dict(encoder_name="rgcn", decoder_name="dismult", in_dim=D,
          hidden_dim=32, out_dim=16, num_hidden_layers=1, num_relation=R,
          num_heads=2, scheduler_type="cosine", learning_rate=1e-3,
          warm_up_ratio=0.1, fuse_method="none", neg_ratio=4,
          node_init_method="random")


def _step(variant, batch, params, seed=3, **over):
    """Loss and gradients of one training step, its draws from a
    generator seeded ``seed``."""
    remat = variant == "remat"
    module = KGEModule(**dict(HP, remat=remat, **over))
    module.edge_layout = "dst"
    module.dst_bwd = "scatter" if remat else variant
    load_jax_params(module.model, params)
    gen = torch.Generator().manual_seed(seed)
    loss, _ = module._forward_loss(batch, training=True, generator=gen)
    named = dict(module.named_parameters())
    return loss.item(), param_grads(loss, named), list(named)


@pytest.mark.parametrize("variant", ["agg", "perm", "remat"])
@pytest.mark.parametrize("sampler", ["sorted", "iid"])
def test_whole_step_equals_scatter(variant, sampler):
    """A dst-layout KGE step (dropout on, drawn from the generator) with
    each variant against "scatter": the same loss and every gradient
    ("agg" runs its conv in the 16 → 32 and 32 → 32 layers; the 32 → 16
    output layer, wider in than out, keeps the node path)."""
    _, b = _batch()
    batch = batch_to_device(b, "cpu")
    jm = JaxKGEModule(**HP)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    want_loss, want, names = _step("scatter", batch, params,
                                   neg_sampler=sampler)
    loss, grads, _ = _step(variant, batch, params, neg_sampler=sampler)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for name, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("variant", ["agg", "perm", "remat"])
def test_variants_with_injected_masks_and_cold_start(variant):
    """Injected dropout masks, cold-start dropout and ``fix_edge_id``
    (the copy mirrors both) give the same step as "scatter"; every layer
    of a wide-input model ("agg": 48 → 32 keeps the node path)."""
    _, b = _batch(x_dim=48)
    batch = batch_to_device(b, "cpu")
    hp = dict(HP, in_dim=48, cold_start_dropout=0.2)
    params = jax.tree_util.tree_map(np.asarray, JaxKGEModule(**hp).init(
        jax.random.PRNGKey(1)))
    masks = [torch.rand(64, 32, generator=torch.Generator().manual_seed(i))
             >= 0.2 for i in range(2)]

    def run(v):
        module = KGEModule(**dict(hp, remat=v == "remat"))
        module.edge_layout = "dst"
        module.dst_bwd = v if v in ("agg", "perm") else "scatter"
        module.fix_edge_id = 2
        load_jax_params(module.model, params)
        loss, _ = module._forward_loss(
            batch, training=True, generator=torch.Generator().manual_seed(4),
            dropout_masks=masks)
        named = dict(module.named_parameters())
        return loss.item(), param_grads(loss, named)

    want_loss, want = run("scatter")
    loss, grads = run(variant)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                   atol=1e-6)


def test_variant_launches_on_the_segsum(monkeypatch):
    """Which segment-sums each variant runs, counted at the dispatch: per
    forward the count table + one per conv; "perm" adds one per conv and
    the head gather in the backward; "agg" sums its hidden conv's forward
    into N·R rows and its backward on the src-sorted copy; remat runs each
    conv's forward again in the backward."""
    from biomedkg_tpu_torch.ops import aggconv, segment, segsum
    from biomedkg_tpu_torch.models import encoders

    calls = []

    def counted(data, ids, n):
        calls.append(n)
        return segsum.sorted_segment_sum(data, ids, n)

    for mod in (aggconv, segment, encoders):
        monkeypatch.setattr(mod, "sorted_segment_sum", counted)
    _, b = _batch()
    batch = batch_to_device(b, "cpu")
    params = jax.tree_util.tree_map(np.asarray, JaxKGEModule(**HP).init(
        jax.random.PRNGKey(0)))
    counts = {}
    for v in ("scatter", "perm", "agg", "remat"):
        calls.clear()
        _step(v, batch, params)
        counts[v] = sorted(calls)
    # scatter: count table + 3 convs + the tail gather's backward; perm
    # adds the head gather's backward and each conv's into N·R rows
    assert counts["scatter"] == [64] * 5
    assert counts["perm"] == [64] * 6 + [64 * R] * 3
    # agg: count table, the output conv, the tail gather, the two agg
    # convs' backwards; their forwards into N·R rows
    assert counts["agg"] == [64] * 5 + [64 * R] * 2
    assert counts["remat"] == [64] * 8


def test_rgat_refuses_the_variants():
    rgat = KGEModule(**dict(HP, encoder_name="rgat"))
    for v in ("agg", "perm"):
        with pytest.raises(ValueError, match="RGAT has no dst-layout"):
            rgat.dst_bwd = v
    rgat.dst_bwd = "scatter"
    assert rgat.dst_bwd == "scatter"
    rgcn = KGEModule(**HP)
    rgcn.dst_bwd = "agg"
    assert rgcn.dst_bwd == "agg" == rgcn.model.encoder.dst_bwd


def test_remat_reaches_the_encoder():
    assert KGEModule(**dict(HP, remat=True)).model.encoder.remat
    assert not KGEModule(**HP).model.encoder.remat


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_debug_nans_toggles_anomaly_detection():
    profiling.debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0 - 1).sum().backward()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("name", ["data_module", "factory", "gcl_module",
                                  "kge_module"])
def test_aliases_export_the_jax_names(name):
    jax_mod = importlib.import_module(f"biomedkg_tpu.{name}")
    port = importlib.import_module(f"biomedkg_tpu_torch.{name}")

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and not isinstance(vars(mod)[n], type(os))}

    assert public(port) == public(jax_mod)
    for n in public(port):
        assert getattr(port, n).__module__.startswith("biomedkg_tpu_torch")

"""The port's RGAT encoder and RGCN edge conv against the JAX package's, on
the CPU: z and every parameter's gradient of the full-graph encode in the
"relation" layout (block 64, JAX-initialised weights carried across), the
edge conv against the node conv, and RGAT's ``_forward_loss`` on a
relation-layout SAINT batch with the reference's negatives and dropout
masks injected (its key splits replayed), in float32 and bf16; and, in
float64, RGAT's conv, whose attention logits come from per-(node,
relation) projections, against the per-edge formulation it replaced.

Tolerances: float32 z 1e-4 of max|z|, loss 1e-5 relative, gradients 5e-4
of their max (only summation orders differ); float64 1e-10 of the max. bf16, JAX's own figures for
its kernels (tests/test_ops.py): loss 1e-3 relative, gradients 3e-2 of
their max. The port sums the attention's scatter and softmax denominator
in float32 where JAX sums them in bf16 (PERF.md, parity note).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.data.node_encoders import RandomEncode as JaxEncode
from biomedkg_tpu.data.synthetic import synthetic_triplets as jax_synth
from biomedkg_tpu.data.triplet import TripletGraph as JaxTripletGraph
from biomedkg_tpu.models import encoders as jax_encoders
from biomedkg_tpu.ops import segment as jax_segment
from biomedkg_tpu.sampling.loaders import FullGraphLoader as JaxLoader
from biomedkg_tpu.sampling.loaders import SaintRandomWalkLoader as JaxSaint
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu_torch.data.node_encoders import RandomEncode
from biomedkg_tpu_torch.data.synthetic import synthetic_triplets
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.interop.jax_params import flatten_tree, \
    load_jax_params
from biomedkg_tpu_torch.models import decoders, encoders
from biomedkg_tpu_torch.models.factory import DECODERS, KGEModelFactory
from biomedkg_tpu_torch.ops.segment import segment_softmax
from biomedkg_tpu_torch.sampling.batch import batch_to_device
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader, \
    SaintRandomWalkLoader
from biomedkg_tpu_torch.training import kge_module
from test_torch_train_step import _jax_draws

DIM, HEADS, BLOCK = 16, 2, 64
# JAX's own bf16 RGAT gradients, against its float32 ones, reach 0.183 of
# their max (the last layer's att_dst; PERF.md, parity note)
BF16_GRAD_ERR_CAP = 0.2


def _hparams(encoder, num_relation, dtype="float32"):
    return dict(encoder_name=encoder, decoder_name="dismult", in_dim=DIM,
                hidden_dim=DIM, out_dim=DIM, num_hidden_layers=1,
                num_relation=num_relation, num_heads=HEADS,
                scheduler_type="cosine", learning_rate=1e-3,
                warm_up_ratio=0.2, fuse_method="none", neg_ratio=3,
                node_init_method="random", compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _graphs():
    return (JaxTripletGraph(jax_synth(seed=42), encoder=JaxEncode(DIM)),
            TripletGraph(synthetic_triplets(seed=42),
                         encoder=RandomEncode(DIM)))


def _full_batches():
    jax_tg, tg = _graphs()
    jb = JaxLoader(jax_tg.graph, block_size=BLOCK).batch()
    batch = FullGraphLoader(tg.graph, block_size=BLOCK).batch()
    for a, b in zip(jb, batch):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return jb, batch_to_device(batch, "cpu")


def _encoders(name, conv_impl="auto"):
    """(JAX encoder, its params, the port's encoder with them)."""
    num_rel = _graphs()[1].num_edge_types
    kw = dict(in_dim=DIM, hidden_dim=DIM, out_dim=DIM, num_hidden_layers=1,
              num_relations=num_rel)
    if name == "rgat":
        jenc = jax_encoders.RGAT(**kw, num_heads=HEADS)
        enc = encoders.RGAT(**kw, num_heads=HEADS)
    else:
        jenc = jax_encoders.RGCN(**kw, conv_impl=conv_impl)
        enc = encoders.RGCN(**kw, conv_impl=conv_impl)
    params = jax.tree_util.tree_map(np.asarray,
                                    jenc.init(jax.random.PRNGKey(1)))
    with torch.no_grad():
        for name_, p in enc.named_parameters():
            p.copy_(torch.from_numpy(flatten_tree(params)[name_]))
    return jenc, params, enc


def _z_and_grads(name, conv_impl="auto"):
    """JAX's and the port's z and d(Σ z·cot)/dparams of the full graph."""
    jenc, params, enc = _encoders(name, conv_impl)
    jb, batch = _full_batches()
    cot = np.random.default_rng(0).standard_normal(
        (batch.num_nodes, DIM)).astype(np.float32)

    def jz(p):
        return jenc.apply(p, jnp.asarray(jb.x), jnp.asarray(jb.edge_index),
                          jnp.asarray(jb.edge_type),
                          jnp.asarray(jb.edge_mask),
                          jnp.asarray(jb.block_rel))

    z_jax, vjp = jax.vjp(jz, params)
    g_jax = flatten_tree(jax.tree_util.tree_map(
        np.asarray, vjp(jnp.asarray(cot))[0]))
    z = enc(batch.x, batch.edge_index, batch.edge_type, batch.edge_mask,
            batch.block_rel)
    named = dict(enc.named_parameters())
    grads = torch.autograd.grad(z, list(named.values()),
                                torch.from_numpy(cot))
    return (np.asarray(z_jax), g_jax, z.detach().numpy(),
            {n: g.numpy() for n, g in zip(named, grads)})


def _assert_close_to_max(got, want, tol, what):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(
        got - want).max(), scale)


@pytest.mark.parametrize("name,conv_impl", [("rgat", "auto"),
                                            ("rgcn", "edge")])
def test_encoder_matches_jax(name, conv_impl):
    z_jax, g_jax, z, grads = _z_and_grads(name, conv_impl)
    _assert_close_to_max(z, z_jax, 1e-4, "z")
    assert set(grads) == set(g_jax)
    for n, g in grads.items():
        _assert_close_to_max(g, g_jax[n], 5e-4, n)


def test_edge_conv_equals_node_conv(monkeypatch):
    """Same weights, same relation-layout batch: the two convs agree, and
    "auto" takes the edge conv when E < R·N (one grouped GEMM per conv)."""
    _, _, enc = _encoders("rgcn", "edge")
    tg = TripletGraph(synthetic_triplets(num_edges=4000, seed=1),
                      encoder=RandomEncode(DIM))
    assert tg.num_edge_types == enc.num_relations
    batch = batch_to_device(
        FullGraphLoader(tg.graph, block_size=BLOCK).batch(), "cpu")
    args = (batch.x, batch.edge_index, batch.edge_type, batch.edge_mask,
            batch.block_rel)
    with torch.no_grad():
        z_edge = enc(*args)
        enc.conv_impl = "node"
        z_node = enc(*args)
        calls = []
        real = encoders.relation_matmul_sorted
        monkeypatch.setattr(encoders, "relation_matmul_sorted",
                            lambda *a: calls.append(1) or real(*a))
        enc.conv_impl = "auto"
        assert batch.num_edges < enc.num_relations * batch.num_nodes
        enc(*args)
    _assert_close_to_max(z_edge.numpy(), z_node.numpy(), 1e-5, "z")
    assert len(calls) == len(enc.layers)


@functools.lru_cache(maxsize=None)
def _saint_batches():
    """One relation-layout SAINT batch from each package's sampler, its
    features scaled by 30 so that no gradient falls below the resolution
    of bf16 (at scale 1 the attention vectors' gradients are ~1e-10)."""
    jax_tg, tg = _graphs()
    kw = dict(batch_size=8, walk_length=4, num_steps=1, block_size=BLOCK,
              seed=3)
    jb = JaxSaint(jax_tg.graph, **kw).sample()[0]
    batch = SaintRandomWalkLoader(tg.graph, **kw).sample()[0]
    for a, b in zip(jb, batch):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert batch.edge_mask.sum() > 100
    jb, batch = jb._replace(x=30 * jb.x), batch._replace(x=30 * batch.x)
    return jax.tree_util.tree_map(jnp.asarray, jb), batch


def _both_losses(dtype, monkeypatch):
    if dtype == "bfloat16":
        # XLA's CPU runtime refuses the bf16 x bf16 -> float32 one-hot
        # product of take_rows_matbwd's backward; its float32 scatter
        # twin, take_rows, computes the same exact sums
        monkeypatch.setattr(jax_encoders, "take_rows_matbwd",
                            jax_segment.take_rows)
    num_rel = _graphs()[1].num_edge_types
    jm = jax_kge.KGEModule(**_hparams("rgat", num_rel, dtype))
    params = jm.init(jax.random.PRNGKey(0))
    module = kge_module.KGEModule(**_hparams("rgat", num_rel, dtype))
    assert module.edge_layout == "relation"
    load_jax_params(module.model, jax.tree_util.tree_map(np.asarray, params))
    jbatch, batch = _saint_batches()
    batch = batch_to_device(batch, "cpu")
    rng = jax.random.PRNGKey(7)
    (loss_jax, _), grads_jax = jax.jit(jax.value_and_grad(
        lambda p: jm._forward_loss(p, jbatch, rng, training=True),
        has_aux=True))(params)
    negatives, masks = _jax_draws(jm, jbatch, rng)
    named = dict(module.named_parameters())
    loss, _ = module._forward_loss(batch, training=True, negatives=negatives,
                                   dropout_masks=masks)
    grads = torch.autograd.grad(loss, list(named.values()))
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, grads_jax))
    assert set(want) == set(named)
    return (float(loss_jax), want, float(loss.detach()),
            {n: g.numpy() for n, g in zip(named, grads)})


def test_rgat_forward_loss_matches_jax():
    """float32. The step runs RGAT with DistMult's "sorted" negatives, its
    positive tails through ``take_rows`` (no dst-sorted tails in this
    layout)."""
    seen = []
    real = decoders.take_rows_sorted
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decoders, "take_rows_sorted",
                   lambda *a: seen.append(1) or real(*a))
        loss_jax, want, loss, grads = _both_losses("float32", mp)
    assert not seen
    assert abs(loss - loss_jax) <= 1e-5 * abs(loss_jax)
    for n, g in grads.items():
        _assert_close_to_max(g, want[n], 5e-4, n)


def test_rgat_forward_loss_bf16_matches_jax(monkeypatch):
    """bf16: the loss within 1e-3 of JAX's. Each gradient is held to JAX's
    float32 gradient, within 3e-2 of its max; where JAX's own bf16 gradient
    lies further than that (an attention vector whose softmax barely moves),
    no further from it than JAX's own bf16 gradient, which itself must stay
    within BF16_GRAD_ERR_CAP. Run with ``-s`` for the per-leaf readings."""
    _, f32, _, _ = _both_losses("float32", monkeypatch)
    seen = set()
    real = encoders.relation_matmul_sorted

    def spy(msg, *args):
        out = real(msg, *args)
        seen.update((msg.dtype, out.dtype))
        return out
    monkeypatch.setattr(encoders, "relation_matmul_sorted", spy)
    loss_jax, want, loss, grads = _both_losses("bfloat16", monkeypatch)
    assert seen == {torch.bfloat16}
    print(f"bf16 loss: port {loss:.7g}, JAX {loss_jax:.7g}")
    assert abs(loss - loss_jax) <= 1e-3 * abs(loss_jax)
    for n, g in grads.items():
        scale = np.abs(f32[n]).max() + 1e-30
        err_jax = np.abs(want[n] - f32[n]).max() / scale
        err = np.abs(g - f32[n]).max() / scale
        print(f"bf16 gradient vs JAX float32, of its max: {n} JAX "
              f"{err_jax:.3g}, port {err:.3g}")
        assert err_jax <= BF16_GRAD_ERR_CAP, (n, err_jax)
        assert err <= max(3e-2, err_jax), (n, err, err_jax)


def test_factory_builds_rgat_with_every_decoder():
    for decoder in sorted(set(DECODERS)):
        model = KGEModelFactory.get_model("rgat", decoder, 8, 8, 8, 1, 5)
        assert type(model.encoder).__name__ == "RGAT"
        assert model.encoder.num_heads == 1
    model = KGEModelFactory.get_model("rgat", "transe", 8, 6, 4, 1, 5,
                                      num_heads=3)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["encoder.layers.0.w_rel"] == (5, 8, 18)
    assert shapes["encoder.layers.2.att_src"] == (5, 3, 4)
    assert shapes["encoder.layers.2.b"] == (4,)
    model.init(torch.Generator().manual_seed(0))
    att = model.encoder.layers[0].att_dst.detach()
    assert 0 < float(att.abs().max()) <= np.sqrt(6.0 / (3 + 6))
    with pytest.raises(ValueError, match="Unknown encoder"):
        KGEModelFactory.get_model("gcn", "transe", 8, 8, 8, 1, 5)


def _relmm64(msg, w, block_rel):
    """The grouped GEMM in float64 (the kernel's wrapper takes float32 and
    bf16 only): each block of edges times its relation's W."""
    nb = block_rel.shape[0]
    return torch.bmm(msg.reshape(nb, -1, msg.shape[1]),
                     w[block_rel.long()]).reshape(msg.shape[0], -1)


def _per_edge_logits(x, w, att_src, att_dst, src, dst, edge_type, mask,
                     block_rel):
    """The per-edge formulation: both endpoints' messages through W_r,
    each dotted with its relation's attention vector; and hs."""
    heads, dout = att_src.shape[1:]
    m = mask[:, None].to(x.dtype)
    hs = _relmm64(x[src] * m, w, block_rel).reshape(-1, heads, dout)
    hd = _relmm64(x[dst] * m, w, block_rel).reshape(-1, heads, dout)
    return ((hs * att_src[edge_type]).sum(-1)
            + (hd * att_dst[edge_type]).sum(-1)), hs


def _per_edge_conv(layer, x, src, dst, edge_type, mask, block_rel):
    logits, hs = _per_edge_logits(x, layer.w_rel, layer.att_src,
                                  layer.att_dst, src, dst, edge_type, mask,
                                  block_rel)
    n, heads, dout = x.shape[0], hs.shape[1], hs.shape[2]
    alpha = segment_softmax(torch.nn.functional.leaky_relu(logits, 0.2),
                            dst, n, mask=mask)
    agg = torch.zeros(n, heads * dout, dtype=x.dtype).index_add_(
        0, dst, (hs * alpha[..., None]).reshape(-1, heads * dout))
    return agg.reshape(n, heads, dout).mean(1) + layer.b


class _Parts:
    """tp's ``sum_shared`` on one process: keeps each rank's part and adds
    the other rank's, once known."""

    def __init__(self, other=None):
        self.other, self.kept = other, []

    def sum_shared(self, part):
        self.kept.append(part)
        return part if self.other is None else part + self.other


@pytest.mark.parametrize("case", ["conv", "tp"])
def test_pair_logits_equal_the_per_edge_formulation(case, monkeypatch):
    """float64, a relation-layout SAINT batch with pad slots and a
    destination whose edges are all masked. "conv": RGAT's conv and the
    gradients of x, W, a_src and a_dst against the per-edge formulation
    (both endpoints' messages through W_r, the gathered attention
    vectors). "tp": two column shards of every head, each rank's part of
    the projection table summed with the other's, give the whole width's
    logits on both ranks."""
    monkeypatch.setattr(encoders, "relation_matmul_sorted", _relmm64)
    batch = batch_to_device(_saint_batches()[1], "cpu")
    src, dst = batch.edge_index
    mask = batch.edge_mask.clone()
    assert not mask.all()
    mask[dst == dst[mask][0]] = False
    num_rel = _graphs()[1].num_edge_types
    enc = encoders.RGAT(DIM, DIM, DIM, 1, num_rel, num_heads=HEADS).double()
    enc.init(torch.Generator().manual_seed(2))
    layer = enc.layers[0]
    with torch.no_grad():
        layer.b.normal_(generator=torch.Generator().manual_seed(4))
    x = batch.x.double().requires_grad_(True)
    keys = encoders.attention_keys(src, dst, batch.edge_type, mask,
                                   x.shape[0], num_rel)
    # the pad slots' rows are spread: none shares a row with more than
    # its share of the table
    pads = keys[~mask.repeat(2)]
    rows = x.shape[0] * 2 * num_rel
    assert pads.bincount().max() <= -(-2 * mask.shape[0] // rows)
    args = (src, dst, batch.edge_type, mask, batch.block_rel)
    if case == "conv":
        leaves = [x, layer.w_rel, layer.att_src, layer.att_dst]
        got = enc._conv(layer, x, src, dst, mask, batch.block_rel, keys,
                        torch.float64)
        want = _per_edge_conv(layer, x, *args)
        cot = torch.randn(got.shape, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(5))
        pairs = [(got, want)] + list(zip(
            torch.autograd.grad(got, leaves, cot),
            torch.autograd.grad(want, leaves, cot)))
    else:
        whole, _ = _per_edge_logits(x, layer.w_rel, layer.att_src,
                                    layer.att_dst, *args)
        c = DIM // 2
        shards = [(layer.w_rel.reshape(num_rel, DIM, HEADS, DIM)
                   [..., t * c:(t + 1) * c].reshape(num_rel, DIM, -1),
                   layer.att_src[..., t * c:(t + 1) * c],
                   layer.att_dst[..., t * c:(t + 1) * c]) for t in (0, 1)]
        kept = _Parts()
        for shard in shards:
            encoders.attention_logits(x, *shard, keys, kept)
        parts = kept.kept
        assert not torch.allclose(parts[0], parts[1])
        # a masked slot's logit is the softmax's to drop: the per-edge
        # formulation's is 0, the table's that of the slot's rows
        pairs = [(encoders.attention_logits(x, *shards[t], keys,
                                            _Parts(parts[1 - t]))[mask],
                  whole[mask]) for t in (0, 1)]
    for got, want in pairs:
        _assert_close_to_max(got.detach().numpy(), want.detach().numpy(),
                             1e-10, case)

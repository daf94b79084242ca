"""RGAT + ComplEx in the port's Stage C step against the benchmark's plain
reference (portbench/reference/kge_rgat_complex.py) on the CPU at a small
size: the loss within 1e-5 and every leaf's first (clipped) gradient
within 1e-4 relative, the reference computed in bfloat16 outside them;
the attention weights of every destination summing to one over its real
incoming edges across relations; the ``rgat.*`` spans and their counters
with the recorder on, nothing and no clock or counter read with it off;
the attention logits from the per-(node, relation) projection table, with
one grouped GEMM a conv and no destination rows gathered; and the
reference importing neither JAX nor either package."""

import ast
import os

import numpy as np
import pytest
import torch

from biomedkg_tpu_torch.models import encoders
from biomedkg_tpu_torch.sampling.batch import batch_to_device, pad_graph_batch
from biomedkg_tpu_torch.training.kge_module import KGEModule
from biomedkg_tpu_torch.utils import profiling
from portbench.reference import kge_rgat_complex as ref
from portbench.reference.optim import B1, Adam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_REAL, N_PAD, R, D_IN, D_HID, HEADS, K = 40, 48, 3, 16, 8, 2, 2
E_REAL, E_PAD, BLOCK = 150, 256, 16
NUM_LAYERS = 3          # in -> hidden, one hidden conv, hidden -> out


def _module():
    m = KGEModule(encoder_name="rgat", decoder_name="complex", in_dim=D_IN,
                  hidden_dim=D_HID, out_dim=D_HID, num_hidden_layers=1,
                  num_relation=R, num_heads=HEADS, scheduler_type="cosine",
                  learning_rate=1e-3, warm_up_ratio=0.2, fuse_method="none",
                  neg_ratio=K, node_init_method="random",
                  compute_dtype="float32", neg_sampler="sorted")
    m.edge_layout = "relation"
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
    m.configure_optimizers(100)
    return m


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N_REAL, E_REAL),
                   rng.integers(0, N_REAL, E_REAL)])
    et = rng.integers(0, R, E_REAL)
    x = rng.standard_normal((N_REAL, D_IN)).astype(np.float32)
    host = pad_graph_batch(x, ei, et, num_relations=R, node_budget=N_PAD,
                           edge_budget=E_PAD, block_size=BLOCK,
                           num_seed=N_REAL, layout="relation")
    return host, batch_to_device(host, "cpu")


def _draws(seed=5):
    gen = torch.Generator().manual_seed(seed)
    neg_src = torch.sort(torch.randint(0, N_REAL, (K * E_PAD,),
                                       generator=gen)).values.int()
    neg_dst = torch.randint(0, N_REAL, (K * E_PAD,), generator=gen).int()
    off = torch.randint(0, E_PAD, (K,), generator=gen)
    keep = [torch.rand(N_PAD, D_HID, generator=gen) >= 0.2
            for _ in range(NUM_LAYERS - 1)]
    return {"negatives": (neg_src, neg_dst, off), "dropout_masks": keep}


def _ref_batch(host, draws):
    mask = torch.as_tensor(host.edge_mask)
    ei = torch.as_tensor(host.edge_index.astype(np.int64))
    et = torch.as_tensor(host.edge_type.astype(np.int64))
    neg_src, neg_dst, off = draws["negatives"]
    return {"x": torch.as_tensor(host.x[:N_REAL]), "src": ei[0][mask],
            "dst": ei[1][mask], "rel": et[mask],
            "keep": [m[:N_REAL] for m in draws["dropout_masks"]],
            "edge_mask": mask, "edge_type": et, "neg_src": neg_src.long(),
            "neg_dst": neg_dst.long(), "off": off}


def _reference(module, host, draws, dtype):
    """The reference's loss and first clipped gradients from the module's
    weights."""
    params = {k: v.detach().clone() for k, v in module.named_parameters()}
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    loss = ref.step_loss(_ref_batch(host, draws), leaves, NUM_LAYERS, HEADS,
                         R, dtype)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    opt = Adam({k: v.detach() for k, v in params.items()}, lambda s: 1e-3)
    return float(loss.detach()), opt.step(dict(zip(leaves, grads)))


@pytest.fixture(scope="module")
def step():
    """The port's train_step: its loss and its first clipped gradients
    (Adam's first moment over 1 - b1), and the reference's."""
    module = _module()
    host, batch = _batch()
    draws = _draws()
    want = _reference(module, host, draws, torch.float32)
    control = _reference(module, host, draws, torch.bfloat16)
    state = module.init_state()
    names = list(state.params)
    state, logs = module.train_step(state, batch, **draws)
    grads = {n: m / (1.0 - B1) for n, m in zip(names, state.opt_state.mu)}
    return (float(logs["train_loss"]), grads), want, control


def _gaps(got, want):
    """(relative loss gap, the widest leaf's ‖g − g_ref‖ over ‖g_ref‖)."""
    (loss, grads), (ref_loss, ref_grads) = got, want
    leaf = max(float(torch.linalg.vector_norm(grads[k] - g)
                     / torch.linalg.vector_norm(g))
               for k, g in ref_grads.items())
    return abs(loss - ref_loss) / abs(ref_loss), leaf


def test_train_step_matches_the_reference(step):
    got, want, _ = step
    assert set(got[1]) == set(want[1])
    assert all(float(torch.linalg.vector_norm(g)) > 0
               for g in want[1].values())
    loss_gap, grad_gap = _gaps(got, want)
    assert loss_gap <= 1e-5
    assert grad_gap <= 1e-4


def test_bfloat16_control_falls_outside(step):
    _, want, control = step
    loss_gap, grad_gap = _gaps(control, want)
    assert loss_gap > 1e-5 or grad_gap > 1e-4


def test_attention_sums_to_one_over_each_destinations_real_edges(
        monkeypatch):
    seen = []

    def keep(scores, index, num_segments, mask=None):
        alpha = softmax(scores, index, num_segments, mask=mask)
        seen.append((alpha.detach(), index, mask))
        return alpha

    softmax = encoders.segment_softmax
    monkeypatch.setattr(encoders, "segment_softmax", keep)
    module = _module()
    host, batch = _batch()
    module._forward_loss(batch, True, **_draws())
    assert len(seen) == NUM_LAYERS
    real = torch.as_tensor(host.edge_mask)
    dst = torch.as_tensor(host.edge_index[1].astype(np.int64))
    has_in = torch.zeros(N_PAD, dtype=torch.bool)
    has_in[dst[real]] = True
    for alpha, index, mask in seen:
        assert torch.equal(index, batch.edge_index[1])
        assert alpha.shape == (E_PAD, HEADS)
        assert torch.all(alpha[~real] == 0)
        sums = torch.zeros(N_PAD, HEADS).index_add_(0, dst[real],
                                                    alpha[real])
        torch.testing.assert_close(sums[has_in],
                                   torch.ones(int(has_in.sum()), HEADS),
                                   rtol=0, atol=1e-6)
        assert torch.all(sums[~has_in] == 0)
    # across relations: destinations with incoming edges of two relations
    # or more, whose one softmax the sums above cover
    rel = torch.as_tensor(host.edge_type.astype(np.int64))[real]
    assert any(rel[dst[real] == v].unique().numel() > 1
               for v in dst[real].unique().tolist())


@pytest.fixture
def recorder_off():
    profiling.start()
    profiling.stop()
    yield
    profiling.stop()


def test_rgat_spans_record_with_their_counts(recorder_off):
    module = _module()
    _, batch = _batch()
    profiling.start()
    module._forward_loss(batch, True, **_draws())
    spans = profiling.stop()
    for name in ("rgat.messages", "rgat.attend", "rgat.aggregate"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == NUM_LAYERS
        # the CPU runs the plain versions: no hand-written launch
        assert all(s.counts["launches"] == 0 for s in mine)
    messages = [s for s in spans if s.name == "rgat.messages"]
    assert all(s.counts["edge_slots"] == E_PAD for s in messages)
    assert profiling.counters()["edge_slots"] == NUM_LAYERS * E_PAD
    attend = [s for s in spans if s.name == "rgat.attend"]
    assert all(s.counts["pair_logit_convs"] == 1 for s in attend)
    order = [s.name for s in sorted(spans, key=lambda s: s.start_ns)
             if s.name.startswith("rgat.")]
    assert order == ["rgat.messages", "rgat.attend",
                     "rgat.aggregate"] * NUM_LAYERS


def test_rgat_logits_come_from_the_pair_table(recorder_off, monkeypatch):
    """float32, recorder on: every conv takes the per-pair logits, runs one
    grouped GEMM (the source messages) and gathers no destination rows."""
    relmm, gathers = [], []
    real_relmm, real_take = encoders.relation_matmul_sorted, \
        encoders.take_rows

    def spy_relmm(*args):
        relmm.append(args[0].shape)
        return real_relmm(*args)

    def spy_take(x, index):
        gathers.append(index)
        return real_take(x, index)

    monkeypatch.setattr(encoders, "relation_matmul_sorted", spy_relmm)
    monkeypatch.setattr(encoders, "take_rows", spy_take)
    module = _module()
    _, batch = _batch()
    profiling.start()
    module._forward_loss(batch, True, **_draws())
    profiling.stop()
    counts = profiling.counters()
    assert counts["pair_logit_convs"] == NUM_LAYERS
    assert counts["edge_slots"] == NUM_LAYERS * E_PAD
    assert len(relmm) == NUM_LAYERS
    src, dst = batch.edge_index
    assert not any(i.shape == dst.shape and torch.equal(i, dst)
                   for i in gathers)
    assert sum(i.shape == src.shape and torch.equal(i, src)
               for i in gathers) == NUM_LAYERS


def test_rgat_spans_off_record_and_read_nothing(recorder_off, monkeypatch):
    def refuse(*args):
        raise AssertionError("the recorder read a clock or a counter")

    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(profiling, "_read", refuse)
    monkeypatch.setattr(profiling, "kernel_launches", refuse)
    assert not profiling.ON
    module = _module()
    _, batch = _batch()
    module._forward_loss(batch, True, **_draws())
    assert profiling.stop() == []
    assert profiling.counters() == {}


def test_reference_imports_neither_jax_nor_either_package():
    banned = ("jax", "jaxlib", "flax", "biomedkg_tpu", "biomedkg_tpu_torch")
    for name in ("kge_rgat_complex.py", "kge_rgcn_distmult.py", "optim.py"):
        path = os.path.join(ROOT, "portbench", "reference", name)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & set(banned), (name, tops)

"""The serving slice as a whole: one checkpoint written by the JAX package
(with an optimizer state) served by the JAX ``KGEScorer`` in its default
"relation" layout and by the port's on the CPU in the "dst" layout; a
DistMult checkpoint for every entry point, one of each other decoder
(TransE, ComplEx, RotatE) and one of RGAT (served in the "relation"
layout by both) for ``score``, ``score_many`` and ``topk_tails``.

Tolerances: z and scores 1e-4; probabilities 1e-5 (float32 on both sides,
summation order differs); top-k names equal wherever the probabilities
are not tied."""

import io

import jax
import numpy as np
import pytest
import torch

from biomedkg_tpu.data import primekg as jax_primekg
from biomedkg_tpu.data.modules import PrimeKGModule as JaxModule
from biomedkg_tpu.serving import KGEScorer as JaxScorer
from biomedkg_tpu.training.checkpoint import save_checkpoint as jax_save
from biomedkg_tpu.training.kge_module import KGEModule as JaxKGEModule
from biomedkg_tpu_torch import serve
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.interop.jax_params import to_jax_params
from biomedkg_tpu_torch.serving import KGEScorer
from biomedkg_tpu_torch.training.checkpoint import save_checkpoint
from biomedkg_tpu_torch.training.kge_module import KGEModule

DIM = 16
HPARAMS = dict(encoder_name="rgcn", decoder_name="dismult", in_dim=DIM,
               hidden_dim=DIM, out_dim=DIM, num_hidden_layers=2,
               num_relation=8, num_heads=2, scheduler_type="cosine",
               learning_rate=1e-3, warm_up_ratio=0.2, fuse_method="none",
               neg_ratio=1, node_init_method="random")


def _data_kw(data_dir, embed_dim=DIM):
    return dict(data_dir=str(data_dir), embed_dim=embed_dim,
                node_type=["gene/protein", "drug", "disease"], batch_size=8,
                val_ratio=0.2, test_ratio=0.2, node_init_method="random")


@pytest.fixture(scope="module")
def scorers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    module = JaxKGEModule(**HPARAMS)
    params = module.init(jax.random.PRNGKey(3))
    module.configure_optimizers(num_training_steps=10)
    ckpt = str(tmp / "kge.ckpt")
    jax_save(ckpt, "kge", module.hparams, params,
             opt_state=module.tx.init(params), step=3)
    with pytest.MonkeyPatch.context() as mp:
        # no download attempt: straight to the synthetic fallback
        mp.setattr(jax_primekg, "_download_csv", lambda path: False)
        jax_scorer = JaxScorer(ckpt, JaxModule(**_data_kw(tmp / "jax")))
    scorer = KGEScorer(ckpt, PrimeKGModule(**_data_kw(tmp / "port")),
                       device="cpu")
    return jax_scorer, scorer, ckpt


def _triples(scorer, n, seed=0):
    g = scorer.dm.graph
    pick = np.random.default_rng(seed).integers(0, g.num_edges, n)
    return [(scorer.id_to_name[int(g.edge_index[0, e])],
             scorer.dm.edge_map_index[int(g.edge_type[e])],
             scorer.id_to_name[int(g.edge_index[1, e])]) for e in pick]


def test_layouts_and_embeddings(scorers):
    jax_scorer, scorer, _ = scorers
    assert jax_scorer.module.edge_layout == "relation"
    assert scorer.module.edge_layout == "dst"
    np.testing.assert_allclose(scorer.z.numpy(), np.asarray(jax_scorer.z),
                               rtol=1e-4, atol=1e-4)


def test_score(scorers):
    jax_scorer, scorer, _ = scorers
    for t in _triples(scorer, 5) + [(_triples(scorer, 1)[0][0],
                                     "drug_drug", "drug_000001")]:
        assert scorer.score(*t) == pytest.approx(jax_scorer.score(*t),
                                                 abs=1e-5)


@pytest.mark.parametrize("n", [1, 65, 4097])
def test_score_many(scorers, n):
    jax_scorer, scorer, _ = scorers
    triples = _triples(scorer, n, seed=n)
    got = scorer.score_many(triples)
    assert len(got) == n
    np.testing.assert_allclose(got, jax_scorer.score_many(triples),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:3], [scorer.score(*t)
                                         for t in triples[:3]], atol=1e-6)


@pytest.mark.parametrize("k", [1, 10, 100000])
def test_topk_tails(scorers, k):
    jax_scorer, scorer, _ = scorers
    for head, rel, _ in _triples(scorer, 3, seed=k):
        want = jax_scorer.topk_tails(head, rel, k)
        got = scorer.topk_tails(head, rel, k)
        assert len(got) == len(want)
        wp = np.array([p for _, p in want])
        np.testing.assert_allclose([p for _, p in got], wp, rtol=0,
                                   atol=1e-5)
        gap = np.abs(np.diff(wp))
        untied = np.ones(len(wp), bool)
        untied[:-1] &= gap > 1e-5
        untied[1:] &= gap > 1e-5
        for i in np.flatnonzero(untied):
            assert got[i][0] == want[i][0]


def test_same_errors(scorers):
    jax_scorer, scorer, _ = scorers
    head, rel, tail = _triples(scorer, 1)[0]
    calls = [
        (KeyError, lambda s: s.score("nonexistent_node", rel, tail)),
        (KeyError, lambda s: s.score(head, rel, "nonexistent_node")),
        (KeyError, lambda s: s.score(head, "no_such_relation", tail)),
        (KeyError, lambda s: s.score_many([(head, rel, tail),
                                           (head, rel, "nonexistent_node")])),
        (KeyError, lambda s: s.topk_tails("nonexistent_node", rel)),
        (ValueError, lambda s: s.topk_tails(head, rel, 0)),
    ]
    for err, call in calls:
        with pytest.raises(err) as jax_exc:
            call(jax_scorer)
        with pytest.raises(err) as exc:
            call(scorer)
        assert str(exc.value) == str(jax_exc.value)
    assert scorer.score_many([]) == jax_scorer.score_many([]) == []


def test_serve_loop(scorers):
    _, scorer, _ = scorers
    g = scorer.dm.graph
    head = scorer.id_to_name[int(g.edge_index[0, 0])]
    tail = scorer.id_to_name[int(g.edge_index[1, 0])]
    rel = scorer.dm.edge_map_index[int(g.edge_type[0])]
    out = io.StringIO()
    serve.serve_loop(scorer, [f"score {head} {rel} {tail}", "",
                              f"topk {head} {rel} 2", "topk x y",
                              f"topk {head} {rel} two", "what", "quit",
                              "never read"], out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("ready.")
    assert lines[1] == f"{scorer.score(head, rel, tail):.6f}"
    top = scorer.topk_tails(head, rel, 2)
    assert lines[2:4] == [f"  {p:.6f}  {n}" for n, p in top]
    assert lines[4] == "error: \"unknown node: 'x'\""
    assert lines[5].startswith("error: invalid literal")
    assert lines[6:] == ["unrecognized command"]


def test_serve_main(tmp_path, monkeypatch, capsys):
    """The CLI: config defaults (768-wide features), key=value args."""
    module = KGEModule(**dict(HPARAMS, in_dim=768, hidden_dim=4, out_dim=4))
    module.init(torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, "kge", module.hparams, to_jax_params(module.model))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO("topk drug_000001 "
                                                 "drug_drug 3\nquit\n"))
    serve.main([f"pretrained_path={ckpt}", "seed=7", "device=cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("ready.") and len(lines) == 4
    assert all(line.split()[1].startswith("drug_") for line in lines[1:])
    with pytest.raises(SystemExit):
        serve.parse_args(["ckpt=x"])
    with pytest.raises(SystemExit):
        serve.parse_args(["seed=1"])


@pytest.fixture(scope="module", params=["transe", "complex", "rotate",
                                        "rgat"])
def decoder_scorers(request, tmp_path_factory):
    """The JAX and port scorers over one JAX checkpoint of each of the
    other decoders (DistMult's is ``scorers``), and of RGAT + DistMult."""
    tmp = tmp_path_factory.mktemp(f"serving_{request.param}")
    over = ({"encoder_name": "rgat"} if request.param == "rgat"
            else {"decoder_name": request.param})
    module = JaxKGEModule(**dict(HPARAMS, **over))
    params = module.init(jax.random.PRNGKey(4))
    ckpt = str(tmp / "kge.ckpt")
    jax_save(ckpt, "kge", module.hparams, params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_primekg, "_download_csv", lambda path: False)
        jax_scorer = JaxScorer(ckpt, JaxModule(**_data_kw(tmp / "jax")))
    scorer = KGEScorer(ckpt, PrimeKGModule(**_data_kw(tmp / "port")),
                       device="cpu")
    for part in ("encoder", "decoder"):
        assert type(getattr(scorer.module.model, part)).__name__ == \
            type(getattr(jax_scorer.module.model, part)).__name__
    assert scorer.module.edge_layout == (
        "relation" if request.param == "rgat" else "dst")
    return jax_scorer, scorer


def test_decoder_score_and_score_many(decoder_scorers):
    jax_scorer, scorer = decoder_scorers
    np.testing.assert_allclose(scorer.z.numpy(), np.asarray(jax_scorer.z),
                               rtol=1e-4, atol=1e-4)
    triples = _triples(scorer, 65, seed=1)
    got = scorer.score_many(triples)
    np.testing.assert_allclose(got, jax_scorer.score_many(triples), rtol=0,
                               atol=1e-5)
    for t in triples[:4]:
        assert scorer.score(*t) == pytest.approx(jax_scorer.score(*t),
                                                 abs=1e-5)


@pytest.mark.parametrize("k", [1, 10])
def test_decoder_topk_tails(decoder_scorers, k):
    jax_scorer, scorer = decoder_scorers
    for head, rel, _ in _triples(scorer, 3, seed=k + 1):
        want = jax_scorer.topk_tails(head, rel, k)
        got = scorer.topk_tails(head, rel, k)
        assert len(got) == len(want)
        wp = np.array([p for _, p in want])
        np.testing.assert_allclose([p for _, p in got], wp, rtol=0,
                                   atol=1e-5)
        gap = np.abs(np.diff(wp))
        untied = np.ones(len(wp), bool)
        untied[:-1] &= gap > 1e-5
        untied[1:] &= gap > 1e-5
        for i in np.flatnonzero(untied):
            assert got[i][0] == want[i][0]

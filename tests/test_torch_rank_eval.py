"""The port's ``rank_eval``, ``test_kge`` and ``train_kge`` with the
unseen-node keys, end to end on the CPU (``device=cpu``) on the small
default PrimeKG-schema graph, against the JAX package on the same
checkpoint: one ``train_kge`` run (``data.unseen_node_ratio=0.1``,
``model.cold_start_dropout=0.1``) writes the checkpoint the others read.

Each prints the JAX entry points' metric names. The deterministic values
are held against JAX's: ``rank_eval``'s against the root ``rank_eval.py``
run in-process (MRR and Hits within 1e-6, mean rank 1e-4 relative: JAX
encodes in the "relation" layout, the port in "dst", so z differs by
summation order), and the ``unseen_*`` metrics of ``test_kge`` and
``train_kge`` against JAX's ``run_entrypoint_inductive_eval`` on the same
weights (ranking 1e-6; the binary ones 1e-4, exact score ties made or
broken by a 1-ulp difference, tests/test_torch_inductive.py). The
``test_*`` values come from each package's own random negatives and are
held by name.
"""

import contextlib
import io
import os
import runpy
import sys

import numpy as np
import pytest

from biomedkg_tpu import config as jax_config
from biomedkg_tpu.data import primekg as jax_primekg
from biomedkg_tpu.data.modules import PrimeKGModule as JaxPrimeKGModule
from biomedkg_tpu.eval.inductive import \
    run_entrypoint_inductive_eval as jax_inductive_entry
from biomedkg_tpu.training.kge_module import load_kge_module as jax_load
from biomedkg_tpu_torch import rank_eval, test_kge
from biomedkg_tpu_torch.serve import PRIMEKG_DATA
from biomedkg_tpu_torch.train_kge import main as train_kge_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNSEEN = ["data.unseen_node_ratio=0.1", "unseen_rank_max_triples=256"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(checkpoint, train_kge's stdout) of a 2-step cold-start run."""
    tmp = tmp_path_factory.mktemp("train")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            path = train_kge_main(UNSEEN + [
                "model.cold_start_dropout=0.1", "steps=2", "epochs=1",
                "val_every_epoch=1", "device=cpu", "neg_ratio=3",
                f"ckpt_dir={tmp / 'ck'}", f"log_dir={tmp / 'log'}"])
    finally:
        os.chdir(cwd)
    return path, out.getvalue()


def _printed(stdout: str, header: str) -> dict:
    """The ``  key: value`` lines under ``header``."""
    lines = stdout.split(header + "\n", 1)[1].splitlines()
    out = {}
    for line in lines:
        if not line.startswith("  "):
            break
        key, value = line.strip().rsplit(": ", 1)
        out[key] = float(value)
    return out


def _jax_data(tmp_path, monkeypatch, **over):
    monkeypatch.setattr(jax_primekg, "_download_csv", lambda path: False)
    dm = JaxPrimeKGModule(**dict(PRIMEKG_DATA,
                                 data_dir=str(tmp_path / "jax_primekg")),
                          seed=42, **over)
    dm.setup(stage="split")
    return dm


def _jax_unseen(path, tmp_path, monkeypatch, neg_ratio):
    """JAX's closing cold-start eval of the checkpoint, as its test_kge
    runs it: RGCN in the "dst" layout, the tested params."""
    dm = _jax_data(tmp_path, monkeypatch, unseen_node_ratio=0.1)
    module, params = jax_load(path)
    module.neg_ratio = neg_ratio
    module.edge_layout = "dst"

    class Tested:
        tested_params = params
        logger = None
        global_step = 0

    cfg = jax_config.Config(seed=42, unseen_ranking=True,
                            unseen_rank_max_triples=256)
    return jax_inductive_entry(module, Tested(), dm, cfg)


def _assert_unseen_close(got, want):
    assert set(got) == set(want) and "unseen_mrr" in want
    for k in want:
        exact = any(w in k for w in ("mrr", "rank", "hits", "num"))
        tol = 1e-6 * max(1.0, abs(want[k])) if exact else 1e-4
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_train_kge_runs_the_cold_start_eval(trained, tmp_path, monkeypatch):
    path, stdout = trained
    assert os.path.exists(path)
    test = _printed(stdout, "test metrics:")
    unseen = _printed(stdout, "unseen-node (inductive) metrics:")
    assert "test_AUROC" in test and "test_loss" in test
    assert all(np.isfinite(v) for v in unseen.values())
    assert 0.0 < unseen["unseen_mrr"] <= 1.0
    want = _jax_unseen(path, tmp_path, monkeypatch, neg_ratio=3)
    # printed to 6 decimals
    assert set(unseen) == set(want)
    for k in want:
        assert abs(unseen[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), k


def test_test_kge_matches_jax(trained, tmp_path, monkeypatch, capsys):
    path, _ = trained
    monkeypatch.chdir(tmp_path)
    got = test_kge.main(UNSEEN + [f"pretrained_path={path}", "neg_ratio=5",
                                  "filter_neg=true", "steps=20",
                                  "device=cpu"])
    stdout = capsys.readouterr().out
    assert "Neg Ratio: 5" in stdout
    test = _printed(stdout, "test metrics:")
    unseen = _printed(stdout, "unseen-node (inductive) metrics:")
    dm = _jax_data(tmp_path, monkeypatch)
    module, _ = jax_load(path)
    module.edge_mapping = dm.edge_map_index
    nrel = module.hparams["num_relation"]
    hist = np.zeros((2, 32768))
    hist[0, -1] = hist[1, 0] = 1.0          # one positive, one negative
    names = module._eval_epoch_from_states([{
        "hist": hist, "f1_counts": np.array([1.0, 0.0, 0.0]),
        "edge_counts": np.ones(nrel), "edge_above": np.ones(nrel),
        "loss": 0.0}], "test")
    assert set(test) == set(names)
    assert all(np.isfinite(v) for v in test.values())
    _assert_unseen_close({k: v for k, v in got.items() if k in unseen},
                         _jax_unseen(path, tmp_path, monkeypatch,
                                     neg_ratio=5))


def test_rank_eval_matches_jax(trained, tmp_path, monkeypatch, capsys):
    path, _ = trained
    monkeypatch.chdir(tmp_path)
    got = rank_eval.main([f"pretrained_path={path}", "device=cpu"])
    printed = _printed(capsys.readouterr().out, "filtered-ranking metrics:")
    assert set(printed) == {"mrr", "mean_rank", "hits@1", "hits@3",
                            "hits@10"}
    monkeypatch.setattr(jax_primekg, "_download_csv", lambda path: False)
    monkeypatch.setattr(sys, "argv", [os.path.join(ROOT, "rank_eval.py"),
                                      f"pretrained_path={path}"])
    want = runpy.run_path(os.path.join(ROOT, "rank_eval.py"))["main"]()
    assert set(got) == set(want)
    for k in want:
        tol = 1e-4 * want[k] if k == "mean_rank" else 1e-6
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])

"""The port's training loop against the JAX package's: the callbacks
(``ModelCheckpoint``, ``EarlyStopping``) driven by the same scripted
``val_loss`` through a stub trainer, ``MetricsLogger``'s files,
``prefetch`` / ``prefetch_to_device``, the ``Trainer`` on a tiny graph
(resume, ``fast_dev_run``, ``check_val_every_n_epoch``,
``test(ckpt_path="best")``, an async save during ``fit``, the refusals,
``history`` keys against the JAX Trainer's, full-batch training) and
``train_kge`` / ``train_gcl`` end to end on the CPU, and their Trainer on a
host with two cards.

Tolerances: the callbacks' kept files, best path, stop epoch and
``state_dict`` equal; the loggers' CSV and JSONL equal but for the
``time`` column; a resumed run's losses, validation metrics and final
parameters bit-equal to the uninterrupted run's (on the CPU every sum is
in a fixed order; on the card the float32 atomics of the segsum and
``index_add_`` make them equal only within the step tolerances)."""

import csv
import glob
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.training import checkpoint as jax_ckpt
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu.training.logger import MetricsLogger as JaxLogger
from biomedkg_tpu.training.trainer import Trainer as JaxTrainer
from biomedkg_tpu_torch.data.modules import RepeatedBatch
from biomedkg_tpu_torch.sampling.batch import batch_to_device, \
    pad_graph_batch
from biomedkg_tpu_torch.sampling.loaders import prefetch, \
    prefetch_to_device
from biomedkg_tpu_torch import train_gcl, train_kge
from biomedkg_tpu_torch.train_gcl import main as train_gcl_main
from biomedkg_tpu_torch.train_kge import main as train_kge_main
from biomedkg_tpu_torch.training import checkpoint
from biomedkg_tpu_torch.training.checkpoint import load_checkpoint
from biomedkg_tpu_torch.training.kge_module import KGEModule
from biomedkg_tpu_torch.training.logger import MetricsLogger
from biomedkg_tpu_torch.training.trainer import Trainer

from test_torch_train_step import D_IN, N_REAL, R, _hparams

MAPPING = {i: f"rel{i}" for i in range(R)}


# -- callbacks -------------------------------------------------------------

class _StubTrainer:
    """What the callbacks use of a trainer: the epoch and ``save``."""

    def __init__(self):
        self.current_epoch = 0
        self.saved = []

    def save(self, path):
        with open(path, "w") as f:
            f.write(str(self.current_epoch))
        self.saved.append(os.path.basename(path))


LOSSES = [0.9, 0.7, 0.8, 0.75, 0.6, 0.65, 0.61, 0.62, 0.66, 0.7, 0.64]


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("top_k,last", [(3, True), (1, False), (0, True),
                                        (-1, False)])
def test_callbacks_match_jax(top_k, last, mode, tmp_path):
    runs = []
    for pkg in (checkpoint, jax_ckpt):
        d = tmp_path / pkg.__name__.split(".")[0]
        ckpt = pkg.ModelCheckpoint(str(d), monitor="val_loss",
                                   save_top_k=top_k, mode=mode,
                                   save_last=last)
        stop = pkg.EarlyStopping(monitor="val_loss", mode=mode, patience=3)
        trainer, stopped = _StubTrainer(), None
        for epoch, loss in enumerate(LOSSES):
            trainer.current_epoch = epoch
            for cb in (ckpt, stop):
                cb.on_validation_end(trainer, {"val_loss": loss})
                cb.on_validation_end(trainer, {"other": 1.0})  # ignored
            if stop.should_stop and stopped is None:
                stopped = epoch
        best = ckpt.best_model_path
        kept = sorted(os.listdir(d))
        state = ckpt.state_dict()
        state["kept"] = [[v, os.path.basename(p)] for v, p in state["kept"]]
        runs.append((kept, best and os.path.basename(best), stopped,
                     stop.state_dict(), state, trainer.saved))
        again = pkg.EarlyStopping(monitor="val_loss", mode=mode)
        again.load_state_dict(stop.state_dict())
        assert again.state_dict() == stop.state_dict()
    assert runs[0] == runs[1]
    assert ("last.ckpt" in runs[0][0]) == last


# -- logger ----------------------------------------------------------------

def _read_logs(d):
    with open(os.path.join(d, "metrics.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    with open(os.path.join(d, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    for r in rows + lines:
        r.pop("time")
    return rows, lines


def test_logger_matches_jax(tmp_path, monkeypatch):
    """Two loggers over one directory (the second continues the files),
    the CSV's columns widening with new keys; no Comet without a key."""
    monkeypatch.delenv("COMET_API_KEY", raising=False)
    calls = [({"train_loss": 0.5}, 10), ({"train_loss": 0.25}, 20),
             ({"epoch": 0, "val_loss": 0.4, "val_AUROC": 0.6}, 20),
             ({"test_loss": 0.3}, 20)]
    out = []
    for cls in (MetricsLogger, JaxLogger):
        d = str(tmp_path / cls.__module__.split(".")[0])
        for part in (calls[:2], calls[2:]):
            logger = cls(save_dir=d, experiment_name="x")
            assert logger._comet is None
            for metrics, step in part:
                logger.log(metrics, step)
            logger.close()
        out.append(_read_logs(d))
    assert out[0] == out[1]
    rows, lines = out[0]
    assert len(rows) == len(lines) == 4 and rows[3]["test_loss"] == "0.3"


# -- prefetch --------------------------------------------------------------

def _live_workers():
    return [t for t in threading.enumerate()
            if t is not threading.current_thread() and t.daemon]


def test_prefetch_keeps_order_raises_and_stops():
    before = len(_live_workers())
    assert list(prefetch(iter(range(50)), size=2)) == list(range(50))

    def failing():
        yield 1
        yield 2
        raise KeyError("worker")

    got = []
    with pytest.raises(KeyError, match="worker"):
        for item in prefetch(failing()):
            got.append(item)
    assert got == [1, 2]

    produced = []

    def endless():
        for i in range(10 ** 9):
            produced.append(i)
            yield i

    gen = prefetch(endless(), size=2)
    for i in gen:
        if i == 3:
            break
    gen.close()
    assert len(_live_workers()) == before
    assert len(produced) <= 3 + 1 + 2 + 1


def test_prefetch_to_device_on_cpu():
    """Every GraphBatch of an item becomes tensors on the device (the
    widening of ``batch_to_device``); one host batch yielded twice is
    copied once."""
    host = [_host_batch(0, 0, i) for i in range(3)]
    items = [(host[:2], 5), (host[2:], 7), ([host[2]], 9)]
    out = list(prefetch_to_device(iter(items), "cpu"))
    assert [e for _, e in out] == [5, 7, 9]
    assert out[2][0][0] is out[1][0][0]
    for (batches, _), (want, _) in zip(out, items):
        for b, h in zip(batches, want):
            assert b.edge_index.dtype == torch.int64
            np.testing.assert_array_equal(b.edge_index.numpy(),
                                          h.edge_index)
            np.testing.assert_array_equal(b.x.numpy(), h.x)


# -- the Trainer on a tiny graph ----------------------------------------------

STEPS, EPOCHS = 4, 2
KW = dict(num_relations=R, node_budget=64, edge_budget=256, block_size=32,
          num_seed=N_REAL, layout="dst")


def _host_batch(seed, epoch, i, pad=pad_graph_batch):
    rng = np.random.default_rng((seed, epoch, i))
    x = np.random.default_rng(seed).standard_normal(
        (N_REAL, D_IN)).astype(np.float32)
    n = int(rng.integers(150, 200))
    ei = rng.integers(0, N_REAL, (2, n))
    return pad(x, ei, rng.integers(0, R, n), **KW)


class TinyLoader:
    """Epoch-keyed padded batches over 40 nodes (host numpy)."""

    def __init__(self, steps=STEPS, seed=0, pad=pad_graph_batch):
        self.steps, self.seed, self.pad, self.epoch = steps, seed, pad, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        for i in range(self.steps):
            yield _host_batch(self.seed, self.epoch, i, self.pad)

    def __len__(self):
        return self.steps


def _module():
    module = KGEModule(**_hparams())
    module.edge_layout = "dst"
    module.edge_mapping = MAPPING
    return module


def _params(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


class _SaveAt:
    """Saves at a validation of ``epoch``, remembering the weights then."""

    def __init__(self, path, epoch):
        self.path, self.epoch, self.params = path, epoch, None

    def on_validation_end(self, trainer, metrics):
        if trainer.current_epoch == self.epoch:
            trainer.save(self.path)
            self.params = _params(trainer.module)


def _fit(callbacks=(), resume_from=None, epochs=EPOCHS, **kw):
    module = _module()
    trainer = Trainer(max_epochs=epochs, callbacks=list(callbacks),
                      enable_progress_bar=False, **kw)
    trainer.fit(module, TinyLoader(), TinyLoader(steps=2, seed=1),
                resume_from=resume_from)
    return trainer, module


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """From the end of epoch 0 (a callback's save) and from the middle of
    epoch 1 (``checkpoint_every_n_steps``), a fresh Trainer resumes to the
    uninterrupted run's losses, metrics and weights, bit for bit."""
    snap = _SaveAt(str(tmp_path / "epoch0.ckpt"), 0)
    full, module = _fit([snap], steps_per_execution=3,
                        checkpoint_every_n_steps=3,
                        default_root_dir=str(tmp_path))
    mid = load_checkpoint(str(tmp_path / "step_last.ckpt"))
    # items of 3 and 1 steps: saved after global steps 3 and 7 (latest)
    assert mid["step"] == 7 and full.global_step == STEPS * EPOCHS
    for path, offset in ((snap.path, 0), (str(tmp_path / "step_last.ckpt"),
                                          3)):
        resumed, again = _fit(resume_from=path, steps_per_execution=2)
        assert resumed.history[0]["epoch"] == 1
        assert {k: v for k, v in resumed.history[0].items()
                if "_per_sec" not in k} == \
            {k: v for k, v in full.history[1].items()
             if "_per_sec" not in k}, offset
        for n, p in _params(module).items():
            assert torch.equal(p, dict(again.named_parameters())[n]), n


def test_async_save_holds_its_own_step(tmp_path):
    snap = _SaveAt(str(tmp_path / "epoch0.ckpt"), 0)
    _, module = _fit([snap])
    ckpt = load_checkpoint(snap.path)
    assert ckpt["step"] == STEPS
    saved = KGEModule(**_hparams())
    checkpoint.load_jax_params(saved.model, ckpt["params"])
    final = _params(module)
    for n, p in saved.named_parameters():
        assert torch.equal(p, snap.params[n]), n
    assert any(not torch.equal(final[n], snap.params[n]) for n in final)
    assert ckpt["extras"]["callback_states"] == [None]


def test_fast_dev_run_and_val_every(monkeypatch):
    calls = {"train": 0, "eval": 0}
    module = _module()
    train_step, eval_step = module.train_step, module.eval_step

    def counted(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    module.train_step = counted("train", train_step)
    module.eval_step = counted("eval", eval_step)
    trainer = Trainer(max_epochs=5, fast_dev_run=True,
                      steps_per_execution=4, enable_progress_bar=False)
    trainer.fit(module, TinyLoader(), TinyLoader(steps=3, seed=1))
    assert calls == {"train": 1, "eval": 1} and len(trainer.history) == 1

    trainer, _ = _fit(epochs=4, check_val_every_n_epoch=2)
    assert [("val_loss" in h) for h in trainer.history] == \
        [False, True, False, True]
    assert trainer.global_step == 4 * STEPS


def test_test_loads_the_best_checkpoint(tmp_path):
    ckpt = checkpoint.ModelCheckpoint(str(tmp_path), save_top_k=2,
                                      save_last=True)
    trainer, module = _fit([ckpt], epochs=3)
    kept = sorted(glob.glob(str(tmp_path / "epoch=*.ckpt")))
    assert len(kept) == 2 and os.path.exists(tmp_path / "last.ckpt")
    best = min(kept, key=lambda p: float(p.split("val_loss=")[1][:-5]))
    metrics = trainer.test(module, TinyLoader(steps=2, seed=2),
                           ckpt_path="best")
    assert trainer.tested_ckpt_path == best
    want = load_checkpoint(best)["params"]
    got = checkpoint.to_jax_params(module.model)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert {"test_loss", "test_AUROC", "rel0_pre"} <= set(metrics)
    assert np.isfinite(trainer.validate(module, TinyLoader(steps=2,
                                                           seed=2))["val_loss"])


def test_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="item 6"):
        Trainer(checkpoint_backend="orbax")
    # two devices present and no group of two ranks: it says how to start
    # one (parallel/launch.py) instead of training each card alone
    class TwoPresent(Trainer):
        def _resolve_dp(self, device):
            return 2

    with pytest.raises(RuntimeError, match="parallel.launch"):
        TwoPresent(devices=2).fit(_module(), TinyLoader(steps=1))
    # ids are clamped to the devices present (one on the CPU)
    with pytest.warns(UserWarning, match="present"):
        Trainer(devices="0,1", enable_progress_bar=False).fit(
            _module(), TinyLoader(steps=1))
    os.makedirs(tmp_path / "orbax.ckpt")
    with pytest.raises(NotImplementedError, match="item 6"):
        checkpoint.load_any(str(tmp_path / "orbax.ckpt"))


def test_history_keys_match_jax():
    trainer, _ = _fit()
    jm = jax_kge.KGEModule(**_hparams())
    jm.edge_layout = "dst"
    jm.edge_mapping = MAPPING
    jt = JaxTrainer(max_epochs=EPOCHS, enable_progress_bar=False)
    jt.fit(jm, TinyLoader(pad=jax_pad), TinyLoader(steps=2, seed=1,
                                                   pad=jax_pad))
    assert [sorted(h) for h in trainer.history] == \
        [sorted(h) for h in jt.history]


def test_full_batch_training():
    """One host batch yielded STEPS times (``RepeatedBatch``) trains
    through the Trainer; ``train_fullbatch`` takes STEPS steps on it."""
    class One:
        def batch(self):
            return _host_batch(0, 0, 0)

    trainer = Trainer(max_epochs=1, enable_progress_bar=False)
    trainer.fit(_module(), RepeatedBatch(One(), STEPS))
    assert trainer.global_step == STEPS
    assert np.isfinite(trainer.history[0]["train_loss_epoch"])
    module = _module()
    module.configure_optimizers(STEPS)
    state, loss = module.train_fullbatch(
        module.init_state(torch.Generator().manual_seed(0)),
        batch_to_device(One().batch(), "cpu"),
        torch.Generator().manual_seed(1), STEPS)
    assert state.step == STEPS and bool(torch.isfinite(loss))


# -- the entry points ------------------------------------------------------

def test_train_kge_and_train_gcl_end_to_end(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BIOMEDKG_SYNTHETIC_SCALE", raising=False)
    common = ["device=cpu", "steps=2", "epochs=2", "val_every_epoch=1",
              f"ckpt_dir={tmp_path}/ck", f"log_dir={tmp_path}/log"]
    path = train_kge_main(common + ["seed=3"])
    (run,) = glob.glob(f"{tmp_path}/ck/kge/*")
    kept = sorted(os.listdir(run))
    assert len(kept) == 3 and kept[-1] == "last.ckpt"
    assert path == min((os.path.join(run, k) for k in kept[:-1]),
                       key=lambda p: float(p.split("val_loss=")[1][:-5]))
    (log,) = glob.glob(f"{tmp_path}/log/kge/*/metrics.jsonl")
    with open(log) as f:
        keys = set().union(*(json.loads(line) for line in f))
    assert {"train_loss_epoch", "val_loss", "val_AUROC", "test_loss",
            "test_AUROC", "test_F1_std", "protein_protein_pre"} <= keys
    assert sum(k.endswith("_pre") for k in keys) == 8

    path = train_gcl_main(common + ["model.model_name=dgi",
                                    "data.node_type=drug"])
    assert glob.glob(f"{tmp_path}/ck/gcl/drug/dgi_none_random_*/*.ckpt") \
        == [path]
    (log,) = glob.glob(f"{tmp_path}/log/gcl/drug/*/metrics.csv")
    with open(log, newline="") as f:
        rows = list(csv.DictReader(f))
    assert {"val_loss", "test_loss", "train_loss_epoch"} <= set(rows[0])
    assert rows[-1]["test_loss"] != ""


class _Reached(Exception):
    pass


@pytest.mark.parametrize("entry,argv", [
    (train_kge, []), (train_gcl, ["model.model_name=dgi",
                                  "data.node_type=drug"])],
    ids=["train_kge", "train_gcl"])
def test_entry_points_train_on_one_card_of_two(entry, argv, tmp_path,
                                               monkeypatch):
    """On a host with two cards the entry points hand the config's
    ``devices: 0,1`` to the Trainer, which resolves it to both cards (data
    parallelism, one rank a card); ``device=cpu`` runs in this one
    process, not re-launched per card."""
    class CheckOnly(Trainer):
        def fit(self, *args, **kwargs):
            assert self._resolve_dp(torch.device("cuda")) == 2
            raise _Reached

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BIOMEDKG_SYNTHETIC_SCALE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(entry, "Trainer", CheckOnly)
    with pytest.raises(_Reached):
        entry.main(["device=cpu", "steps=2", f"ckpt_dir={tmp_path}/ck",
                    f"log_dir={tmp_path}/log"] + argv)

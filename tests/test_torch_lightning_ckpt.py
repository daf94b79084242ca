"""The port's import of the reference's Lightning checkpoints
(interop/torch_ckpt.py) against the JAX package's
(biomedkg_tpu/interop/torch_ckpt.py): the committed fixtures and files
written here in the reference's key vocabulary (RGCN and GCN encoders,
the four decoders, ComplEx's half- and full-width tables, both fusers, the
three GCL heads, missing hyper-parameters) import to the same payload,
params bitwise; every loader of a ``.ckpt`` takes them; and the restricted
unpicklers turn a name they do not admit (``os.system``, numpy's
``f2py.crackfortran.myeval``, which evaluates a string) into an inert
stand-in without calling it."""

import io
import os
import pickle
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from biomedkg_tpu.interop.torch_ckpt import from_torch_checkpoint as jax_import
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.interop import torch_ckpt
from biomedkg_tpu_torch.interop.jax_params import flatten_tree
from biomedkg_tpu_torch.serve import PRIMEKG_DATA
from biomedkg_tpu_torch.serving import KGEScorer
from biomedkg_tpu_torch.training.checkpoint import (CheckpointUnpickler,
                                                    Inert, load_any,
                                                    load_checkpoint,
                                                    load_train_state,
                                                    save_checkpoint)
from biomedkg_tpu_torch.training.gcl_module import load_gcl_module
from biomedkg_tpu_torch.training.kge_module import KGEModule, load_kge_module

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PARSING = "lightning.pytorch.utilities.parsing"
KGE_KEYS = ("encoder_name", "decoder_name", "in_dim", "hidden_dim",
            "out_dim", "num_hidden_layers", "num_relation", "num_heads",
            "scheduler_type", "learning_rate", "warm_up_ratio", "fuse_method",
            "neg_ratio", "node_init_method")


def _attribute_dict():
    """Lightning's AttributeDict under its import path, for the save."""
    parts = PARSING.split(".")
    for i in range(1, len(parts) + 1):
        sys.modules.setdefault(".".join(parts[:i]),
                               types.ModuleType(".".join(parts[:i])))
    mod = sys.modules[PARSING]
    if not hasattr(mod, "AttributeDict"):
        mod.AttributeDict = type("AttributeDict", (dict,),
                                 {"__module__": PARSING})
    return mod.AttributeDict


def _lin(g, sd, prefix, dout, din):
    sd[prefix + ".weight"] = torch.randn(dout, din, generator=g) * 0.2
    sd[prefix + ".bias"] = torch.randn(dout, generator=g) * 0.05


def write_kge(path, encoder="rgcn", decoder="dismult", fuse=None,
              half=False, drop=(), d=8, r=3, hidden_layers=1, seed=0):
    """A reference KGEModule save: PyG RGCNConv (weight, root, bias) or
    GCNConv (lin.weight, bias) layers, the decoder's rel tables, a fuser."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for i in range(hidden_layers + 2):
        p = f"model.encoder.graph_layers.{i}"
        if encoder == "rgcn":
            sd[p + ".weight"] = torch.randn(r, d, d, generator=g) * 0.2
            sd[p + ".root"] = torch.randn(d, d, generator=g) * 0.2
            sd[p + ".bias"] = torch.randn(d, generator=g) * 0.05
        else:
            _lin(g, sd, p + ".lin", d, d)
            sd[p + ".bias"] = sd.pop(p + ".lin.bias")
    width = d // 2 if half or decoder == "rotate" else d
    sd["model.decoder.rel_emb"] = torch.randn(r, width, generator=g) * 0.2
    if decoder == "complex":
        sd["model.decoder.rel_emb_imag"] = torch.randn(r, width,
                                                       generator=g) * 0.2
    if fuse == "attention":
        for name in ("q", "k", "v"):
            _lin(g, sd, f"modality_transform.{name}_proj", d, d)
    elif fuse == "redaf":
        sd["modality_transform.modal_weights"] = torch.rand(2, 1, d,
                                                            generator=g)
        sd["modality_transform.sub_type_embeddings.weight"] = torch.randn(
            2, d, generator=g)
        _lin(g, sd, "modality_transform.transform_layer", d, d)
        _lin(g, sd, "modality_transform.relational_context_layer", d, d)
    hp = dict(encoder_name=encoder, decoder_name=decoder, in_dim=d,
              hidden_dim=d, out_dim=d, num_hidden_layers=hidden_layers,
              num_relation=r, num_heads=1, scheduler_type="linear",
              learning_rate=5e-4, warm_up_ratio=0.1, fuse_method=fuse,
              neg_ratio=4, node_init_method="lm" if fuse else "random")
    for k in drop:
        hp.pop(k)
    torch.save({"state_dict": sd, "hyper_parameters": _attribute_dict()(hp),
                "global_step": 17, "epoch": 2}, path)
    return str(path)


def write_gcl(path, model, d=8, seed=0, fuse=None):
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for i in range(3):
        _lin(g, sd, f"model.encoder.graph_layers.{i}.lin", d, d)
        sd[f"model.encoder.graph_layers.{i}.bias"] = sd.pop(
            f"model.encoder.graph_layers.{i}.lin.bias")
    if model == "dgi":
        _lin(g, sd, "model.project", d, d)
    elif model == "grace":
        _lin(g, sd, "model.fc1", d, d)
        _lin(g, sd, "model.fc2", d, d)
    else:
        _lin(g, sd, "model.mlp.0", d, d)
        _lin(g, sd, "model.mlp.1", d, d)
    if fuse == "attention":
        for name in ("q", "k", "v"):
            _lin(g, sd, f"modality_transform.{name}_proj", d, d)
    torch.save({"state_dict": sd, "hyper_parameters": _attribute_dict()(
        in_dim=d, hidden_dim=d, out_dim=d, num_hidden_layers=1,
        scheduler_type="cosine", learning_rate=2e-4, warm_up_ratio=0.05,
        fuse_method=fuse), "global_step": 9}, path)
    return str(path)


def _both(path):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jax_import(path)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = load_checkpoint(path)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    return want, got


def _assert_same_payload(want, got):
    assert set(got) == {"kind", "hparams", "params", "opt_state", "step",
                        "extras"}
    for key in ("kind", "hparams", "opt_state", "step", "extras"):
        assert got[key] == want[key], key
    a, b = flatten_tree(want["params"]), flatten_tree(got["params"])
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == a[k].dtype == np.float32, k
        assert b[k].shape == a[k].shape, k
        assert b[k].tobytes() == np.ascontiguousarray(a[k]).tobytes(), k


@pytest.mark.parametrize("name", ["ref_kge_tiny.ckpt", "ref_grace_tiny.ckpt"])
def test_committed_fixtures_import_as_jax(name):
    want, got = _both(os.path.join(FIXTURES, name))
    _assert_same_payload(want, got)


@pytest.mark.parametrize("kw", [
    dict(), dict(decoder="complex", half=True), dict(decoder="complex"),
    dict(decoder="transe"), dict(decoder="rotate"),
    dict(fuse="attention"), dict(fuse="redaf"), dict(encoder="gcn"),
    dict(drop=("decoder_name", "num_relation", "learning_rate")),
    dict(drop=KGE_KEYS)], ids=lambda kw: "-".join(
        f"{k}={v if not isinstance(v, tuple) else len(v)}"
        for k, v in kw.items()) or "dismult")
def test_kge_checkpoints_import_as_jax(tmp_path, kw):
    want, got = _both(write_kge(tmp_path / "m.ckpt", **kw))
    _assert_same_payload(want, got)


@pytest.mark.parametrize("model, fuse", [("dgi", None), ("grace", None),
                                         ("ggd", None), ("ggd", "attention")])
def test_gcl_checkpoints_import_as_jax(tmp_path, model, fuse):
    want, got = _both(write_gcl(tmp_path / "g.ckpt", model, fuse=fuse))
    _assert_same_payload(want, got)
    assert got["extras"]["model_name"] == model


def test_loaders_take_a_lightning_checkpoint(tmp_path):
    """load_kge_module and KGEScorer serve the reference's weights;
    load_gcl_module loads GRACE's; a Lightning file carries no optimizer
    state, so resuming from it raises; an orbax directory still raises."""
    path = write_kge(tmp_path / "k.ckpt", r=8, d=8)
    module = load_kge_module(path, device="cpu")
    want = flatten_tree(jax_import(path)["params"])
    for name, p in module.named_parameters():
        assert p.detach().numpy().tobytes() == want[name].tobytes(), name
    dm = PrimeKGModule(**dict(PRIMEKG_DATA, data_dir=str(tmp_path / "d"),
                              embed_dim=8), seed=1)
    scorer = KGEScorer(path, dm, device="cpu")
    assert 0.0 < scorer.score("gene_000000", "protein_protein",
                              "gene_000001") < 1.0
    gcl = load_gcl_module(os.path.join(FIXTURES, "ref_grace_tiny.ckpt"),
                          device="cpu")
    assert type(gcl).__name__ == "GRACEModule"
    again = KGEModule(**load_checkpoint(path)["hparams"])
    again.configure_optimizers(4)
    with pytest.raises(ValueError, match="no optimizer state"):
        load_train_state(path, again)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        load_any(str(tmp_path / "orbax"))


class _Evil:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


def test_unadmitted_class_is_an_inert_stub(tmp_path):
    """A pickle that names os.system loads as an inert stand-in holding the
    call's arguments; nothing runs. The checkpoint beside it still imports."""
    marker = tmp_path / "ran"
    path = tmp_path / "evil.ckpt"
    src = write_kge(tmp_path / "k.ckpt")
    raw = torch.load(src, weights_only=False)
    raw["callbacks"] = _Evil(marker)
    torch.save(raw, path)
    loaded = torch_ckpt._load_torch_file(str(path))
    stub = loaded["callbacks"]
    assert isinstance(stub, Inert)
    assert type(stub).__name__ == "system"
    assert stub.args == (f"touch {marker}",)
    assert type(loaded["hyper_parameters"]).__name__ == "AttributeDict"
    assert isinstance(loaded["hyper_parameters"], Inert)
    assert loaded["hyper_parameters"]["num_relation"] == 3
    assert not marker.exists()
    ckpt = load_checkpoint(str(path))
    assert ckpt["kind"] == "kge" and ckpt["step"] == 17
    assert not marker.exists()


class _NumpyEval:
    """A call of numpy's ``f2py.crackfortran.myeval``, which evaluates its
    string argument."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        from numpy.f2py.crackfortran import myeval
        return myeval, (f"__import__('os').system('touch {self.marker}')",)


@pytest.mark.parametrize("container", ["lightning", "native"])
def test_numpy_eval_gadget_does_not_run(tmp_path, container):
    """numpy is admitted only for arrays, scalars and dtypes: a pickle
    naming ``numpy.f2py.crackfortran.myeval`` loads it as an inert
    stand-in, in a Lightning zip and in a native checkpoint alike, and
    the string is never evaluated. The weights beside it still load."""
    marker = tmp_path / "ran"
    path = tmp_path / "evil.ckpt"
    if container == "lightning":
        raw = torch.load(write_kge(tmp_path / "k.ckpt"), weights_only=False)
        raw["callbacks"] = _NumpyEval(marker)
        torch.save(raw, path)
        loaded = torch_ckpt._load_torch_file(str(path))
        gadget = loaded["callbacks"]
    else:
        save_checkpoint(str(path), "kge", {"in_dim": 8},
                        {"w": np.arange(4, dtype=np.float32)},
                        extras={"callbacks": _NumpyEval(marker)})
        loaded = load_checkpoint(str(path))
        gadget = loaded["extras"]["callbacks"]
        assert loaded["params"]["w"].tobytes() == \
            np.arange(4, dtype=np.float32).tobytes()
    assert isinstance(gadget, Inert)
    assert type(gadget).__module__ == "numpy.f2py.crackfortran"
    assert type(gadget).__name__ == "myeval"
    assert not marker.exists()
    if container == "lightning":
        assert load_checkpoint(str(path))["kind"] == "kge"
        assert not marker.exists()


@pytest.mark.parametrize("obj", [
    np.arange(6, dtype=np.float32).reshape(2, 3).T, np.float32(1.5),
    np.int64(-3), np.dtype([("a", "<f4"), ("b", "<i8")]),
    np.zeros(2, "M8[s]"), type(np.dtype("float32"))],
    ids=["array", "f32-scalar", "i64-scalar", "record-dtype", "datetime",
         "dtype-class"])
@pytest.mark.parametrize("protocol", [2, 5])
def test_numpy_values_still_load(obj, protocol):
    """What the narrowed numpy rule still admits: arrays (protocol 5's
    ``_frombuffer`` too), scalars, dtypes and the dtype classes load as
    themselves, not as stand-ins."""
    got = CheckpointUnpickler(io.BytesIO(pickle.dumps(
        obj, protocol=protocol))).load()
    assert type(got) is type(obj)
    if isinstance(obj, np.ndarray):
        assert got.dtype == obj.dtype and np.array_equal(got, obj)
    else:
        assert got == obj

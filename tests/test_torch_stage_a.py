"""Stage A end to end: the port's ``LMMultiModalsEncode._build_cache``
(data/node_encoders.py over data/lm_embed.py) against the JAX package's,
on the CPU, over one modality yaml of the default's structure (gene/protein
nested in ``amino_acid`` then ``dna``, a name in both, disease and drug)
whose csvs hold missing fields (empty and ``NA``), duplicate rows and
quoted commas, every column on one tiny random BERT (tests/
test_torch_bert.py), in slices of 3 rows: the same names, every row within
rtol = atol = 2e-4 (tests/test_stage_a.py's flax-against-torch
tolerance), the missing fields' xavier rows bit-equal before the
normalisation, and each package reading the other's cache. Also: the
data module passes its ``device``, without CUDA the default device is
refused, and a model missing from the cache or not ported raises before
any text is encoded."""

import csv
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from biomedkg_tpu.data import node_encoders as jax_nodes
from biomedkg_tpu_torch.data import node_encoders
from biomedkg_tpu_torch.data.lm_embed import NodeEmbedding
from biomedkg_tpu_torch.data.modules import get_node_encode_method
from test_torch_bert import write_tiny_bert

TOL = dict(rtol=2e-4, atol=2e-4)
DIM = 768
SLICE = 3
STEM = "stage_a_modality"
CSVS = {
    "amino.csv": (["protein_name", "protein_seq", "ncbi_summary"], [
        ["TP53", "MEEPQSDPSV", "tumor protein p53, the receptor"],
        ["BRCA1", "", "breast cancer gene"],
        ["EGFR", "MRPSGTAGAA", "NA"],
        ["TP53", "MEEPQSDPSV", "tumor protein p53, the receptor"],
        ["MDM2", "NA", ""],
        ["KRAS", "mteyklvvvg", "kinase of the cell " * 40],
        ["EGFR", "MRPSGTAGAA", "another summary"],
    ]),
    "dna.csv": (["protein_name", "protein_seq", "ncbi_summary"], [
        ["TP53", "acgtacgtac", "tumor protein p53 dna"],
        ["GATA1", "ggcatt", "NA"],
        ["GATA1", "ggcatt", "NA"],
        ["SOX2", "", "sex determining region"],
    ]),
    "disease.csv": (["mondo_name", "mondo_definition", "umls_description"], [
        ["asthma", "a disease of the airways", "NA"],
        ["diabetes", "", "a disorder of glucose"],
        ["asthma", "a disease of the airways", "NA"],
        ["gout", "arthritis, with urate", "joint pain"],
    ]),
    "drug.csv": (["generic_name", "smiles", "description"], [
        ["aspirin", "CC(=O)OC1=CC=CC=C1C(=O)O", "an analgesic"],
        ["NA", "C", "a name that pandas reads as missing"],
        ["metformin", "NA", ""],
        ["imatinib", "CC1=C(C=C(C=C1)NC(=O)C2", "a kinase inhibitor"],
    ]),
}


def write_workspace(root, model_dir):
    """The csvs and the modality yaml (the default's layout) in ``root``."""
    os.makedirs(root, exist_ok=True)
    for name, (header, rows) in CSVS.items():
        with open(os.path.join(root, name), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(header)
            writer.writerows(rows)

    def spec(file_name, columns, indent):
        pad = " " * indent
        header = CSVS[file_name][0]
        return (f"{pad}file_name: {os.path.join(root, file_name)}\n"
                f"{pad}idetifier_column: {header[0]}\n"
                f"{pad}modality_columns:\n"
                + "".join(f"{pad}  - {c}\n" for c in header[1:])
                + f"{pad}model_name_for_each_modality:\n"
                + "".join(f"{pad}  - {model_dir}\n" for _ in columns))

    text = ("gene/protein:\n  amino_acid:\n" + spec("amino.csv", "ab", 4)
            + "  dna:\n" + spec("dna.csv", "ab", 4)
            + "disease:\n" + spec("disease.csv", "ab", 2)
            + "drug:\n" + spec("drug.csv", "ab", 2))
    path = os.path.join(root, f"{STEM}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


class Recorder:
    """Wraps a module's ``xavier_normal_np`` and keeps every draw."""

    def __init__(self, fn):
        self.fn, self.draws = fn, []

    def __call__(self, rng, shape):
        out = self.fn(rng, shape)
        self.draws.append(out.copy())
        return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both packages' caches from one workspace; the JAX draws."""
    root = tmp_path_factory.mktemp("stage_a")
    model_dir = write_tiny_bert(root / "tiny-bert")
    yaml_path = write_workspace(str(root), model_dir)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("BIOMEDKG_LM_BACKEND", "flax")
        recorder = Recorder(jax_nodes.xavier_normal_np)
        mp.setattr(jax_nodes, "xavier_normal_np", recorder)
        for pkg in ("jax", "port"):
            os.makedirs(root / pkg)
            mp.chdir(root / pkg)
            if pkg == "jax":
                jax_nodes.LMMultiModalsEncode(yaml_path, embed_dim=DIM,
                                              batch_size=SLICE)
            else:
                node_encoders.LMMultiModalsEncode(yaml_path, embed_dim=DIM,
                                                  batch_size=SLICE,
                                                  device="cpu")
    finally:
        mp.undo()
    caches = {}
    for pkg in ("jax", "port"):
        with open(root / pkg / "data" / "embed" / f"{STEM}_lm.pickle",
                  "rb") as f:
            caches[pkg] = pickle.load(f)
    return dict(root=root, yaml=yaml_path, model=model_dir, caches=caches,
                draws=recorder.draws)


def test_caches_agree(built):
    jax_cache, port_cache = built["caches"]["jax"], built["caches"]["port"]
    # NaN names (the drug csv's "NA") are distinct keys in both
    named = lambda c: {k for k in c if k == k}
    assert named(port_cache) == named(jax_cache)
    assert len(port_cache) == len(jax_cache)
    assert port_cache["TP53"].shape == (2, DIM)
    for key in named(jax_cache):
        got, want = port_cache[key], jax_cache[key]
        assert got.dtype == np.float32 and got.shape == (2, DIM)
        np.testing.assert_allclose(got, want, err_msg=str(key), **TOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0,
                                   rtol=1e-5)
    # TP53 is in both gene sub-specs: the dna spec's row wins
    dna_only = built["caches"]["port"]["TP53"]
    assert not np.allclose(dna_only, built["caches"]["port"]["BRCA1"])


def test_missing_fields_draw_the_jax_rows(built):
    """The xavier rows of missing fields, before the normalisation, are
    the JAX package's draws bit for bit, in its order."""
    enc = node_encoders.LMMultiModalsEncode.__new__(
        node_encoders.LMMultiModalsEncode)
    enc.conf = node_encoders.load_yaml_file(built["yaml"])
    enc.embed_dim, enc.batch_size, enc.device = DIM, SLICE, "cpu"
    draws = iter(built["draws"])
    n_missing = 0
    for spec in enc.specs():
        _, columns = node_encoders.unique_rows(
            spec["file_name"], spec["idetifier_column"],
            spec["modality_columns"])
        lo = 0
        for names, stacked in enc.modality_rows(**spec):
            for m, modality in enumerate(spec["modality_columns"]):
                mask = columns[modality][1][lo:lo + len(names)]
                want = next(draws)
                np.testing.assert_array_equal(stacked[mask, m], want)
                n_missing += int(mask.sum())
            lo += len(names)
    assert next(draws, None) is None
    assert n_missing == 10


def test_each_reads_the_others_cache(built, tmp_path, monkeypatch):
    for writer, reader in (("port", "jax"), ("jax", "port")):
        ws = tmp_path / f"{writer}-for-{reader}"
        (ws / "data" / "embed").mkdir(parents=True)
        src = built["root"] / writer / "data" / "embed" / f"{STEM}_lm.pickle"
        (ws / "data" / "embed" / src.name).write_bytes(src.read_bytes())
        monkeypatch.chdir(ws)
        module = jax_nodes if reader == "jax" else node_encoders
        enc = module.LMMultiModalsEncode(built["yaml"], embed_dim=DIM)
        names = ["TP53", "asthma", "imatinib", "__missing__"]
        rows = enc(names)
        for i, name in enumerate(names[:3]):
            np.testing.assert_array_equal(rows[i],
                                          built["caches"][writer][name])
        assert enc.random_init_ratio == 0.25


def test_data_module_builds_on_its_device(built, tmp_path, monkeypatch):
    """``node_init_method="lm"`` with a missing cache builds it on the data
    module's ``device``, in the default 128-row slices: the rows without a
    missing field do not depend on the slicing (the xavier draws do)."""
    monkeypatch.chdir(tmp_path)
    enc = get_node_encode_method("lm", DIM, modality_config_path=built["yaml"],
                                 device="cpu")
    assert enc.device == "cpu" and enc.batch_size == 128
    port = built["caches"]["port"]
    assert {k for k in enc.node_mapping if k == k} == \
        {k for k in port if k == k}
    for key in ("TP53", "KRAS", "EGFR", "gout", "aspirin", "imatinib"):
        np.testing.assert_allclose(enc.node_mapping[key], port[key],
                                   rtol=1e-5, atol=1e-6)


def test_no_cuda_refuses_the_default_device(built, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the no-CUDA refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA"):
        NodeEmbedding(built["model"])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        node_encoders.LMMultiModalsEncode(built["yaml"], embed_dim=DIM)


def test_missing_model_names_the_cache(built, tmp_path, monkeypatch):
    """A model name that is neither a directory nor in the Hugging Face
    cache raises before anything is written."""
    yaml_path = tmp_path / "other.yaml"
    yaml_path.write_text(open(built["yaml"]).read().replace(
        built["model"], "dmis-lab/biobert-v1.1"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        node_encoders.LMMultiModalsEncode(str(yaml_path), embed_dim=DIM,
                                          device="cpu")
    assert not os.path.exists(os.path.join("data", "embed",
                                           "other_lm.pickle"))


def test_unported_model_raises_before_encoding(built, tmp_path, monkeypatch):
    """A later spec's model the port cannot run (here the drug spec on a
    remote-code config, as MoLFormer's) raises naming ROADMAP.md before
    the first spec's texts are encoded."""
    other = tmp_path / "molformer"
    shutil.copytree(built["model"], other)
    path = other / "config.json"
    cfg = json.load(open(path))
    cfg.update(model_type="molformer",
               auto_map={"AutoModel": "modeling_molformer.MolformerModel"})
    json.dump(cfg, open(path, "w"))
    head, drug = open(built["yaml"]).read().split("drug:\n")
    yaml_path = tmp_path / "unported.yaml"
    yaml_path.write_text(head + "drug:\n"
                         + drug.replace(built["model"], str(other)))

    def encoded(*args, **kwargs):
        raise AssertionError("a text was encoded before the models were "
                             "checked")

    monkeypatch.setattr(NodeEmbedding, "__init__", encoded)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md"):
        node_encoders.LMMultiModalsEncode(str(yaml_path), embed_dim=DIM,
                                          device="cpu")
    assert not os.path.exists(os.path.join("data", "embed",
                                           "unported_lm.pickle"))

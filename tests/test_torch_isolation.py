"""The PyTorch port stands alone: no JAX, no biomedkg_tpu, no pandas, no
PyYAML, no transformers, tokenizers or safetensors — in its sources, in
chip_smoke.py, and at run time in a process where those imports fail —
and no silent CPU fallback without CUDA."""

import os
import re
import shutil
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from biomedkg_tpu.training.checkpoint import save_checkpoint as jax_save
from biomedkg_tpu.training.kge_module import KGEModule as JaxKGEModule
from biomedkg_tpu_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "biomedkg_tpu", "pandas", "yaml", "optax",
             "transformers", "tokenizers", "safetensors")


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT,
                                                  "biomedkg_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_import_nothing_forbidden():
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:%s)\b"
                         % "|".join(FORBIDDEN), re.M)
    hits = []
    for path in _port_sources():
        with open(path) as f:
            hits += [(path, m.group(0)) for m in pattern.finditer(f.read())]
    assert not hits


# the modules of the ranking and unseen-node slice, which the source scan
# and the import walk below must reach
SLICE_MODULES = ("eval/__init__.py", "eval/ranking.py", "eval/inductive.py",
                 "data/inductive.py", "rank_eval.py", "test_kge.py")


def test_slice_modules_are_scanned():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "biomedkg_tpu_torch"))
               for p in _port_sources()}
    assert set(SLICE_MODULES) <= scanned
    assert set(CONFIG_SLICE_MODULES) <= scanned
    assert set(DPI_SLICE_MODULES) <= scanned
    assert set(STAGE_A_SLICE_MODULES) <= scanned
    assert set(TYPED_SLICE_MODULES) <= scanned


# the config layer and the modules of Stage B's multimodal remainder
CONFIG_SLICE_MODULES = ("config.py", "models/fusion.py",
                        "data/node_encoders.py")

_MODULE_CHILD = textwrap.dedent("""
    import importlib, sys
    for name in {forbidden!r}:
        sys.modules[name] = None          # any import of it now fails
    module = importlib.import_module(sys.argv[1])
    if sys.argv[1].endswith("config"):
        cfg = module.load_config("configs", "gcl", ["data.node_type=gene"])
        assert cfg.model.fuse_method == "none", cfg
    elif sys.argv[1].endswith("fusion"):
        import torch
        x = torch.randn(5, 2, 8)
        for fuser in (module.AttentionFusion(8), module.ReDAF(8)):
            fuser.init(torch.Generator().manual_seed(0))
            assert fuser(x).shape == (5, 8)
    else:
        try:
            module.LMMultiModalsEncode(
                "configs/lm_modality/primekg_modality.yaml", device="cpu")
        except FileNotFoundError as e:
            assert "protein_aminoacid_sequence.csv" in str(e), e
        else:
            raise AssertionError("no LM cache, no csv, and nothing raised")
    print(sorted(m for m, mod in sys.modules.items()
                 if mod is not None and m.split(".")[0] in {forbidden!r}))
""")


@pytest.mark.parametrize("path", CONFIG_SLICE_MODULES)
def test_config_slice_module_runs_without_jax_pandas_yaml(path, tmp_path):
    """Each module of the config and fusion slice imports and runs (the
    config composed from the repository's configs/, both fusers applied,
    the LM cache build's refusal without the modality csvs) in a process
    where JAX, biomedkg_tpu, pandas, PyYAML, optax and the Hugging Face
    packages cannot be imported."""
    name = "biomedkg_tpu_torch." + path[:-3].replace("/", ".")
    code = _MODULE_CHILD.format(forbidden=FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, name], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# the csv on-ramps, the Lightning importer and DPI fine-tuning
DPI_SLICE_MODULES = ("data/csv_columns.py", "data/dpi.py",
                     "interop/torch_ckpt.py", "train_dpi.py", "test_dpi.py")

_DPI_CHILD = textwrap.dedent("""
    import contextlib, importlib, io, os, sys
    for name in {forbidden!r}:
        sys.modules[name] = None          # any import of it now fails
    module = importlib.import_module(sys.argv[1])
    fixture = sys.argv[2]
    from biomedkg_tpu_torch.data.csv_columns import write_csv_columns
    from biomedkg_tpu_torch.data.synthetic import synthetic_dpi
    columns = synthetic_dpi(num_drug=40, num_gene=60, num_edges=300)
    columns["x_name"][3] = "NA"
    write_csv_columns("dpi.csv", columns)
    name = sys.argv[1].rsplit(".", 1)[1]
    if name == "csv_columns":
        table = module.read_csv_columns("dpi.csv", ["x_name"], any_na=True)
        assert table.any_na.tolist().count(True) == 1
    elif name == "dpi":
        graph = module.DPI("dpi.csv").graph
        assert graph.num_relations == 1 and graph.num_edges > 0
    elif name == "torch_ckpt":
        ckpt = module.from_torch_checkpoint(fixture)
        assert ckpt["kind"] == "kge" and ckpt["step"] == 123
    else:
        from biomedkg_tpu_torch import train_dpi
        args = ["device=cpu", "steps=1", "epochs=1", "val_every_epoch=1",
                "data.embed_dim=8", "data.data_dir=dpi.csv",
                "data.batch_size=8", "ckpt_dir=ck", "log_dir=log"]
        with contextlib.redirect_stdout(io.StringIO()):
            path = train_dpi.main(args + ["pretrained_path=" + fixture])
            if name == "test_dpi":
                module.main(["device=cpu", "steps=10", "data.embed_dim=8",
                             "data.data_dir=dpi.csv", "data.batch_size=8",
                             "pretrained_path=" + path])
        assert os.path.exists(path)
    print(sorted(m for m, mod in sys.modules.items()
                 if mod is not None and m.split(".")[0] in {forbidden!r}))
""")


@pytest.mark.parametrize("path", DPI_SLICE_MODULES)
def test_dpi_slice_module_runs_without_jax_pandas_yaml(path, tmp_path):
    """Each module of the DPI slice imports and runs (the csv reader, the
    DPI graph from a csv with an NA row, the Lightning fixture's import,
    train_dpi warm-started from it and test_dpi on the result, on the
    CPU) in a process where JAX, biomedkg_tpu, pandas, PyYAML and optax
    cannot be imported."""
    name = "biomedkg_tpu_torch." + path[:-3].replace("/", ".")
    code = _DPI_CHILD.format(forbidden=FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=ROOT)
    fixture = os.path.join(ROOT, "tests", "fixtures", "ref_kge_tiny.ckpt")
    proc = subprocess.run([sys.executable, "-c", code, name, fixture],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# Stage A: the checkpoint reader, the WordPiece tokenizer, the BERT
# encoder and NodeEmbedding
STAGE_A_SLICE_MODULES = ("interop/hf_files.py", "data/wordpiece.py",
                         "models/bert.py", "data/lm_embed.py")

_STAGE_A_CHILD = textwrap.dedent("""
    import importlib, os, sys
    for name in {forbidden!r}:
        sys.modules[name] = None          # any import of it now fails
    module = importlib.import_module(sys.argv[1])
    model_dir, yaml_path = sys.argv[2], sys.argv[3]
    name = sys.argv[1].rsplit(".", 1)[1]
    if name == "hf_files":
        assert module.resolve_model_dir(model_dir) == model_dir
        state = module.load_state_dict(model_dir, "bert.")
        assert state["embeddings.word_embeddings.weight"].shape[1] == 768
    elif name == "wordpiece":
        tokens = module.WordPieceTokenizer.from_dir(model_dir)(["a b", ""])
        assert tokens["input_ids"].shape == (2, 4), tokens
    elif name == "bert":
        import torch
        model = module.BertModel.from_pretrained(model_dir)
        ids = torch.tensor([[2, 5, 3]])
        assert model(ids, 0 * ids, 1 + 0 * ids).shape == (1, 768)
    else:
        assert module.NodeEmbedding(model_dir, device="cpu")(
            ["protein"]).shape == (1, 768)
        from biomedkg_tpu_torch.data.node_encoders import LMMultiModalsEncode
        enc = LMMultiModalsEncode(yaml_path, device="cpu")
        assert enc(["TP53"]).shape == (1, 2, 768)
        assert enc.random_init_ratio == 0
        assert os.path.exists("data/embed/stage_a_modality_lm.pickle")
    print(sorted(m for m, mod in sys.modules.items()
                 if mod is not None and m.split(".")[0] in {forbidden!r}))
""")


@pytest.fixture(scope="module")
def stage_a_workspace(tmp_path_factory):
    from test_torch_bert import write_tiny_bert
    from test_torch_stage_a import write_workspace

    root = tmp_path_factory.mktemp("stage_a")
    model_dir = write_tiny_bert(root / "tiny-bert", layers=1)
    return model_dir, write_workspace(str(root), model_dir)


@pytest.mark.parametrize("path", STAGE_A_SLICE_MODULES)
def test_stage_a_slice_module_runs_without_hf_jax_pandas_yaml(
        path, stage_a_workspace, tmp_path):
    """Each module of Stage A imports and runs (the checkpoint read, the
    tokenizer, the encoder, NodeEmbedding and the LM cache built from a
    modality yaml, on the CPU) in a process where transformers, tokenizers,
    safetensors, JAX, biomedkg_tpu, pandas, PyYAML and optax cannot be
    imported."""
    name = "biomedkg_tpu_torch." + path[:-3].replace("/", ".")
    code = _STAGE_A_CHILD.format(forbidden=FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, name,
                           *stage_a_workspace], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# typed tables, ml_exp, the opt-in variants, profiling and the aliases
TYPED_SLICE_MODULES = ("models/typed.py", "sampling/typed_batch.py",
                       "training/typed_train.py", "ml_exp.py",
                       "ops/aggconv.py", "utils/profiling.py",
                       "data_module.py", "factory.py", "gcl_module.py",
                       "kge_module.py")

_TYPED_CHILD = textwrap.dedent("""
    import contextlib, importlib, io, sys
    for name in {forbidden!r} + ("sklearn", "xgboost"):
        sys.modules[name] = None          # any import of it now fails
    for path in {modules!r}:
        importlib.import_module(
            "biomedkg_tpu_torch." + path[:-3].replace("/", "."))
    import numpy as np
    from biomedkg_tpu_torch import ml_exp
    from biomedkg_tpu_torch.train_kge import main as train_kge
    from biomedkg_tpu_torch.training.kge_module import KGEModule
    from biomedkg_tpu_torch.utils import profiling
    args = ["typed_tables=true", "typed_steps=2", "epochs=1",
            "device=cpu", "data.embed_dim=8", "model.hidden_dim=8",
            "model.out_dim=8", "model.num_hidden_layers=0"]
    with contextlib.redirect_stdout(io.StringIO()):
        for loader in ("full", "saint"):
            out = train_kge(args + ["typed_loader=" + loader])
            assert 0.0 <= out["test_AUROC"] <= 1.0, out
    hp = dict(encoder_name="rgcn", decoder_name="dismult", in_dim=8,
              hidden_dim=8, out_dim=8, num_hidden_layers=1, num_relation=4,
              num_heads=1, scheduler_type="cosine", learning_rate=1e-3,
              warm_up_ratio=0.1, fuse_method="none", neg_ratio=1,
              node_init_method="random", remat=True)
    module = KGEModule(**hp)
    module.dst_bwd = "agg"
    profiling.start()
    with profiling.span("trainer.step", counters=(profiling.LAUNCHES,)):
        pass
    assert profiling.stop()[0].counts == {{profiling.LAUNCHES: 0}}
    try:
        ml_exp.evaluate(np.zeros((4, 2)), np.arange(4) % 2)
    except ModuleNotFoundError as err:
        assert "scikit-learn" in str(err)
    else:
        raise AssertionError("evaluate ran without scikit-learn")
    print(sorted(m for m, mod in sys.modules.items()
                 if mod is not None and m.split(".")[0] in
                 {forbidden!r} + ("sklearn", "xgboost")))
""")


def test_typed_slice_runs_without_jax_pandas_yaml_sklearn(tmp_path):
    """The modules of the typed-tables slice import, and train_kge trains
    typed tables (full-batch and typed SAINT) on the CPU, in a process
    where JAX, biomedkg_tpu, pandas, PyYAML, optax, the Hugging Face
    packages, scikit-learn and xgboost cannot be imported; ml_exp's
    classifier refuses there."""
    code = _TYPED_CHILD.format(forbidden=FORBIDDEN,
                               modules=TYPED_SLICE_MODULES)
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("BIOMEDKG_SYNTHETIC_SCALE", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# the parallel strategies
PARALLEL_SLICE_MODULES = tuple(
    f"parallel/{name}.py" for name in (
        "__init__", "mesh", "collectives", "dp", "launch", "graph_shard",
        "typed_shard", "sharding", "dryrun"))

_PARALLEL_CHILD = textwrap.dedent("""
    import contextlib, importlib, io, sys
    for name in {forbidden!r}:
        sys.modules[name] = None          # any import of it now fails
    for path in {modules!r}:
        importlib.import_module("biomedkg_tpu_torch."
                                + path[:-3].replace("/", ".")
                                .replace(".__init__", ""))
    import torch
    import torch.distributed as dist
    from biomedkg_tpu_torch.parallel.dryrun import dryrun_multichip
    torch.set_num_threads(1)              # as a launched rank runs
    from biomedkg_tpu_torch.parallel.launch import free_port
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                            % free_port(), rank=0, world_size=1)
    with contextlib.redirect_stdout(io.StringIO()):
        out = dryrun_multichip(1)
    dist.destroy_process_group()
    assert out["n_devices"] == 1, out
    print(sorted(m for m, mod in sys.modules.items()
                 if mod is not None and m.split(".")[0] in {forbidden!r}))
""")


def test_parallel_slice_runs_without_jax_pandas_yaml(tmp_path):
    """The parallel modules import, and the dry run of every strategy
    runs in a one-rank gloo group, in a process where JAX, biomedkg_tpu,
    pandas, PyYAML, optax and the Hugging Face packages cannot be
    imported."""
    scanned = {os.path.relpath(p, os.path.join(ROOT, "biomedkg_tpu_torch"))
               for p in _port_sources()}
    assert set(PARALLEL_SLICE_MODULES) <= scanned
    code = _PARALLEL_CHILD.format(forbidden=FORBIDDEN,
                                  modules=PARALLEL_SLICE_MODULES)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


_CHILD = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    for name in {forbidden!r}:
        sys.modules[name] = None          # any import of it now fails
    import torch
    import biomedkg_tpu_torch
    for info in pkgutil.walk_packages(biomedkg_tpu_torch.__path__,
                                      "biomedkg_tpu_torch."):
        importlib.import_module(info.name)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", {root!r} + "/chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))

    from biomedkg_tpu_torch.data.modules import PrimeKGModule
    from biomedkg_tpu_torch.serving import KGEScorer
    ckpt, data_dir = sys.argv[1], sys.argv[2]
    dm = PrimeKGModule(data_dir=data_dir, embed_dim=8,
                       node_type=["gene/protein", "drug", "disease"],
                       batch_size=8, val_ratio=0.2, test_ratio=0.2)
    assert not torch.cuda.is_available()
    try:
        KGEScorer(ckpt, dm)
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("KGEScorer without CUDA did not raise")
    scorer = KGEScorer(ckpt, dm, device="cpu")
    print(scorer.score("gene_000000", "protein_protein", "gene_000001"))
    import contextlib, io
    from biomedkg_tpu_torch.train_kge import main as train_kge
    with contextlib.redirect_stdout(io.StringIO()):
        trained = train_kge(["steps=1", "epochs=1", "val_every_epoch=1",
                             "device=cpu", "ckpt_dir=" + sys.argv[3],
                             "log_dir=" + sys.argv[3] + "/log"])
    dm768 = PrimeKGModule(data_dir=data_dir, embed_dim=768,
                          node_type=["gene/protein", "drug", "disease"],
                          batch_size=8, val_ratio=0.2, test_ratio=0.2)
    KGEScorer(trained, dm768, device="cpu")
    from biomedkg_tpu_torch import rank_eval, test_kge
    with contextlib.redirect_stdout(io.StringIO()):
        rank_eval.main(["pretrained_path=" + trained, "device=cpu"])
        unseen = test_kge.main(["pretrained_path=" + trained, "steps=10",
                                "data.unseen_node_ratio=0.1",
                                "unseen_rank_max_triples=64", "device=cpu"])
    assert "unseen_mrr" in unseen
    from biomedkg_tpu_torch.train_gcl import main as train_gcl
    from biomedkg_tpu_torch.training.gcl_module import load_gcl_module
    with contextlib.redirect_stdout(io.StringIO()):
        gcl = train_gcl(["model.model_name=dgi", "data.node_type=drug",
                         "steps=1", "epochs=1", "val_every_epoch=1",
                         "device=cpu", "ckpt_dir=" + sys.argv[3],
                         "log_dir=" + sys.argv[3] + "/log"])
    load_gcl_module(gcl, device="cpu")
    print(sorted(m for m, mod in sys.modules.items()
                 if mod is not None and m.split(".")[0] in {forbidden!r}))
""")


def test_serves_without_jax_pandas_yaml(tmp_path):
    """A JAX-written checkpoint (its optax optimizer state included) serves
    on the CPU in a process where JAX, biomedkg_tpu, pandas, PyYAML and
    optax cannot be imported; every port module and chip_smoke.py import
    there too, train_kge trains a step and writes a checkpoint that
    serves, rank_eval ranks with it and test_kge tests it with the
    unseen-node eval, and train_gcl trains a DGI step and writes a
    checkpoint that loads."""
    hp = dict(encoder_name="rgcn", decoder_name="dismult", in_dim=8,
              hidden_dim=8, out_dim=8, num_hidden_layers=1, num_relation=8,
              num_heads=1, scheduler_type="cosine", learning_rate=1e-3,
              warm_up_ratio=0.1, fuse_method="none", neg_ratio=1,
              node_init_method="random")
    module = JaxKGEModule(**hp)
    params = module.init(jax.random.PRNGKey(0))
    module.configure_optimizers(num_training_steps=4)
    ckpt = str(tmp_path / "kge.ckpt")
    jax_save(ckpt, "kge", module.hparams, params,
             opt_state=module.tx.init(params), step=1)
    code = _CHILD.format(forbidden=FORBIDDEN, root=ROOT)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, ckpt,
                           str(tmp_path / "primekg"), str(tmp_path / "ck")],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    score, loaded = proc.stdout.strip().splitlines()
    assert 0.0 < float(score) < 1.0
    assert loaded == "[]"


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the repo (and here, without
    CUDA) exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_without_cuda_fails():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA" in proc.stderr


def test_device_rule():
    """No CUDA: device=None refuses instead of running on the CPU; TF32
    matmuls are refused on every device."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the no-CUDA refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            resolve_device("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

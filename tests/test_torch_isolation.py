"""The PyTorch port stands alone: no JAX, no biomedkg_tpu, no pandas, no
PyYAML — in its sources, in chip_smoke.py, and at run time in a process
where those imports fail — and no silent CPU fallback without CUDA."""

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
FORBIDDEN = ("jax", "biomedkg_tpu", "pandas", "yaml", "optax")


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
    serves, and train_gcl trains a DGI step and writes a checkpoint that
    loads."""
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

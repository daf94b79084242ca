"""The port's ``ml_exp`` against the root ``ml_exp.py``: the same injected
KGE embedding mapping into both gives bit-identical X and y and equal
per-fold F1 / AveragePrecision; more than half the names missing from the
cache raises; the module imports where scikit-learn and xgboost do not."""

import os
import subprocess
import sys

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import ml_exp as jax_ml_exp
from biomedkg_tpu_torch import ml_exp
from biomedkg_tpu_torch.data.csv_columns import write_csv_columns

D = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csv(path, n=60, seed=0):
    """A small DPI csv (pairs over 20 drugs and 30 genes) with one row
    missing a field, which both readers drop."""
    rng = np.random.default_rng(seed)
    x = np.array([f"drug_{i:06d}" for i in rng.integers(0, 20, n)])
    y = np.array([f"gene_{i:06d}" for i in rng.integers(0, 30, n)])
    rel = np.full(n, "drug_protein")
    rel[7] = ""
    write_csv_columns(str(path), {
        "x_type": np.full(n, "drug"), "x_name": x, "relation": rel,
        "y_type": np.full(n, "gene/protein"), "y_name": y})
    return path


def _stub(mapping, miss=0.0):
    class Encode:
        def __init__(self, **kw):
            self.random_init_ratio = miss

        def __call__(self, names):
            return np.stack([mapping[n] for n in names])

    return Encode


@pytest.fixture
def mapping():
    rng = np.random.default_rng(1)
    names = [f"drug_{i:06d}" for i in range(20)] + \
        [f"gene_{i:06d}" for i in range(30)]
    return {n: rng.standard_normal((1, D)).astype(np.float32)
            for n in names}


def test_features_and_folds_match_the_root_script(tmp_path, monkeypatch,
                                                   mapping):
    path = _csv(tmp_path / "dpi.csv")
    flat = {n: v[0] for n, v in mapping.items()}
    seen, scores = {}, {"f1": [], "ap": []}

    class Folds(jax_ml_exp.StratifiedKFold):
        def split(self, X, y=None, groups=None):
            seen["X"], seen["y"] = X, y
            return super().split(X, y, groups)

    def record(name, fn):
        def wrapped(*args, **kw):
            value = fn(*args, **kw)
            scores[name].append(float(value))
            return value
        return wrapped

    monkeypatch.setattr(jax_ml_exp, "KGEEncode", _stub(mapping))
    monkeypatch.setattr(jax_ml_exp, "StratifiedKFold", Folds)
    monkeypatch.setattr(jax_ml_exp, "f1_score",
                        record("f1", jax_ml_exp.f1_score))
    monkeypatch.setattr(jax_ml_exp, "average_precision_score",
                        record("ap", jax_ml_exp.average_precision_score))
    # one OpenMP thread for the boosted trees: their spinning worker
    # threads would starve the other test workers
    with threadpool_limits(limits=1):
        want = jax_ml_exp.main("k.ckpt", "random", "grace", "none",
                               data_dir=str(path))

    monkeypatch.setattr(ml_exp, "KGEEncode", _stub(mapping))
    X, y, miss = ml_exp.features("k.ckpt", "random", "grace", "none",
                                 data_dir=str(path))
    assert miss == 0.0
    assert X.dtype == seen["X"].dtype and X.tobytes() == seen["X"].tobytes()
    assert y.dtype == seen["y"].dtype and y.tobytes() == seen["y"].tobytes()
    assert len(y) == 4 * 59          # the row with a missing field dropped
    np.testing.assert_array_equal(X[:59], (np.stack(
        [flat[n] for n in ml_exp.dpi_pairs(str(path))[0]])
        + np.stack([flat[n] for n in ml_exp.dpi_pairs(str(path))[1]])) / 2)
    with threadpool_limits(limits=1):
        out = ml_exp.evaluate(X, y)
    assert out["f1"] == scores["f1"] and out["ap"] == scores["ap"]
    assert (out["mean_f1"], out["mean_ap"]) == want


def test_synthetic_fallback_pairs():
    x, y = ml_exp.dpi_pairs("no/such/file.csv")
    assert len(x) == len(y) > 0
    assert all(n.startswith("drug_") for n in x[:20])


def test_miss_ratio_over_half_raises(tmp_path, monkeypatch, mapping):
    path = _csv(tmp_path / "dpi.csv")
    monkeypatch.setattr(ml_exp, "KGEEncode", _stub(mapping, miss=0.6))
    with pytest.raises(ValueError, match="60% of DPI node names missing"):
        ml_exp.features("k.ckpt", "random", "grace", "none",
                        data_dir=str(path))
    monkeypatch.setattr(ml_exp, "KGEEncode", _stub(mapping, miss=0.5))
    ml_exp.features("k.ckpt", "random", "grace", "none", data_dir=str(path))


BLOCKED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("sklearn", "xgboost"):
            raise ModuleNotFoundError(f"No module named {name!r}",
                                      name=name)
sys.meta_path.insert(0, Block())
import numpy as np
from biomedkg_tpu_torch import ml_exp
assert "sklearn" not in sys.modules and "xgboost" not in sys.modules
try:
    ml_exp.evaluate(np.zeros((10, 2)), np.arange(10) % 2)
except ModuleNotFoundError as err:
    assert "xgboost" in str(err) and "scikit-learn" in str(err), err
    print("refused")
"""


def test_imports_without_sklearn_and_xgboost():
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"


def test_main_parses_one_configuration(monkeypatch):
    calls = []
    monkeypatch.setattr(ml_exp, "run", lambda **kw: calls.append(kw))
    ml_exp.main(["ckpt_path=a.ckpt", "device=cpu"])
    assert calls == [dict(ml_exp.REFERENCE_CONFIGS[0], ckpt_path="a.ckpt",
                          device="cpu")]
    with pytest.raises(ValueError, match="unknown argument"):
        ml_exp.main(["epochs=3"])

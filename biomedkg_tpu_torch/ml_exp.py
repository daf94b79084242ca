"""Downstream drug-target classification over frozen KGE node embeddings
(counterpart of ml_exp.py at the repo root, the reference's ml_exp.py):

    python -m biomedkg_tpu_torch.ml_exp ckpt_path=<kge .ckpt>
        [node_init_method=random] [gcl_model=grace] [gcl_fuse_method=none]
        [data_dir=data/dpi/dpi_benchmark.csv] [device=cuda]

With no arguments it runs the reference's three placeholder
configurations, as the root script does.

* ``features``: the DPI pairs' (x_name, y_name) columns (the csv at
  ``data_dir`` read without pandas, rows with a missing field dropped,
  else ``synthetic_dpi(seed=43)``), each name's row of the KGE embedding
  cache (``KGEEncode``: the checkpoint's full-graph encode, on the card
  unless ``device`` says otherwise), then X: the mean of each pair's two
  rows, for the positives and for 3× as many random (head, tail)
  negatives from ``default_rng(42)``, and y. More than half the names
  missing from the cache raises (the rows would be random).
* ``evaluate``: 5-fold ``StratifiedKFold(shuffle=True, random_state=42)``;
  each fold fits the classifier (xgboost's ``XGBClassifier``, else
  scikit-learn's ``HistGradientBoostingClassifier``: 500 trees, depth 5,
  learning rate 0.01, seed 42) and scores F1 and AveragePrecision.

scikit-learn and xgboost are imported inside ``evaluate`` only: the
package imports without them. Where neither is installed (the H100
machine has neither), ``evaluate`` raises ``ModuleNotFoundError``; it
never substitutes another classifier.

One deliberate difference: the names are encoded in sorted order (the
root script's set order changes with the process's string hashing, and
with it the random rows of cache misses); X and y are the same for the
same embedding rows.
"""

from __future__ import annotations

import os
import random
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .data.csv_columns import read_csv_columns
from .data.node_encoders import KGEEncode
from .data.synthetic import synthetic_dpi

DPI_CSV = "data/dpi/dpi_benchmark.csv"
MAX_MISS = 0.5
REFERENCE_CONFIGS = [
    {"ckpt_path": "ckpt/path/to/best.ckpt", "node_init_method": "random",
     "gcl_model": "grace", "gcl_fuse_method": "none"},
    {"ckpt_path": "ckpt/path/to/best.ckpt", "node_init_method": "lm",
     "gcl_model": "grace", "gcl_fuse_method": "none"},
    {"ckpt_path": "ckpt/path/to/best.ckpt", "node_init_method": "gcl",
     "gcl_model": "grace", "gcl_fuse_method": "attention"},
]


def dpi_pairs(data_dir: str = DPI_CSV) -> Tuple[np.ndarray, np.ndarray]:
    """The DPI pairs' (x_name, y_name): the csv at ``data_dir`` without
    the rows that miss a field (pandas' ``dropna``), else the synthetic
    DTI graph."""
    if os.path.exists(data_dir):
        table = read_csv_columns(data_dir, ("x_name", "y_name"), any_na=True)
        keep = ~table.any_na
        return (table.columns["x_name"][keep].astype(str),
                table.columns["y_name"][keep].astype(str))
    print("[biomedkg_tpu_torch] DPI csv unavailable; using synthetic DTI.")
    columns = synthetic_dpi(seed=43)
    return columns["x_name"].astype(str), columns["y_name"].astype(str)


def pair_features(x_name, y_name, mapping: Dict[str, np.ndarray]):
    """(X, y): each pair's mean row, the positives then 3× random
    negatives (``default_rng(42)``)."""
    head = np.stack([mapping[n] for n in x_name])
    tail = np.stack([mapping[n] for n in y_name])
    num_pairs = len(x_name)
    pos = np.stack([head, tail], axis=1)
    rng = np.random.default_rng(42)
    neg_h = head[rng.integers(0, num_pairs, 3 * num_pairs)]
    neg_t = tail[rng.integers(0, num_pairs, 3 * num_pairs)]
    neg = np.stack([neg_h, neg_t], axis=1)
    X = np.concatenate([pos, neg], axis=0).mean(axis=1)
    y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    return X, y


def features(ckpt_path: str, node_init_method: str, gcl_model: str,
             gcl_fuse_method: str, data_dir: str = DPI_CSV,
             device: Optional[str] = None):
    """(X, y, miss ratio) of the DPI pairs over the checkpoint's KGE
    embeddings."""
    kge_encode = KGEEncode(ckpt_path=ckpt_path,
                           node_init_method=node_init_method,
                           gcl_model=gcl_model,
                           gcl_fuse_method=gcl_fuse_method, device=device)
    x_name, y_name = dpi_pairs(data_dir)
    node_names = sorted(set(x_name) | set(y_name))
    rows = np.asarray(kge_encode(node_names)).squeeze(1)
    # misses get random rows: past half, the metrics would score noise
    miss = float(getattr(kge_encode, "random_init_ratio", 0.0))
    print(f"[ml_exp] KGE-embedding cache miss ratio: {miss:.3f}")
    if miss > MAX_MISS:
        raise ValueError(
            f"{miss:.0%} of DPI node names missing from the KGE embedding "
            "cache — wrong checkpoint or mismatched node vocabulary; "
            "results would be random-embedding noise")
    X, y = pair_features(x_name, y_name, dict(zip(node_names, rows)))
    return X, y, miss


def _make_classifier():
    try:
        import xgboost as xgb

        return xgb.XGBClassifier(n_estimators=500, max_depth=5,
                                 learning_rate=0.01, random_state=42)
    except ModuleNotFoundError:
        from sklearn.ensemble import HistGradientBoostingClassifier

        return HistGradientBoostingClassifier(
            max_iter=500, max_depth=5, learning_rate=0.01, random_state=42)


def evaluate(X: np.ndarray, y: np.ndarray) -> Dict[str, object]:
    """Per-fold and mean F1 and AveragePrecision of the classifier over
    5 stratified folds."""
    try:
        from sklearn.metrics import average_precision_score, f1_score
        from sklearn.model_selection import StratifiedKFold
    except ModuleNotFoundError as err:
        raise ModuleNotFoundError(
            "ml_exp's classifier needs xgboost or scikit-learn (with "
            "scikit-learn for the folds and metrics); neither is "
            "installed") from err
    skf = StratifiedKFold(n_splits=5, shuffle=True, random_state=42)
    f1s: List[float] = []
    aps: List[float] = []
    for train_idx, val_idx in skf.split(X, y):
        clf = _make_classifier()
        clf.fit(X[train_idx], y[train_idx])
        pred = clf.predict(X[val_idx])
        proba = clf.predict_proba(X[val_idx])[:, 1]
        f1s.append(float(f1_score(y[val_idx], pred, pos_label=1)))
        aps.append(float(average_precision_score(y[val_idx], proba)))
    return {"f1": f1s, "ap": aps, "mean_f1": float(np.mean(f1s)),
            "mean_ap": float(np.mean(aps))}


def run(ckpt_path: str, node_init_method: str, gcl_model: str,
        gcl_fuse_method: str, data_dir: str = DPI_CSV,
        device: Optional[str] = None) -> Tuple[float, float]:
    """``features`` then ``evaluate``, printed as the root script prints;
    returns the mean F1 and AveragePrecision."""
    X, y, _ = features(ckpt_path, node_init_method, gcl_model,
                       gcl_fuse_method, data_dir, device)
    out = evaluate(X, y)
    print(f"Result for {ckpt_path}")
    print(f"F1-Scores for each fold: {out['f1']}")
    print(f"Average Precision for each fold: {out['ap']}")
    print(f"Mean F1-Score: {out['mean_f1']:.4f}")
    print(f"Mean Average Precision (AP): {out['mean_ap']:.4f}")
    print("=" * 20)
    return out["mean_f1"], out["mean_ap"]


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv: Optional[List[str]] = None):
    """key=value arguments name one configuration; none runs the
    reference's three."""
    argv = sys.argv[1:] if argv is None else argv
    seed_everything(42)
    if not argv:
        return [run(**config) for config in REFERENCE_CONFIGS]
    config = dict(REFERENCE_CONFIGS[0])
    for arg in argv:
        key, sep, value = arg.partition("=")
        if not sep or key not in ("ckpt_path", "node_init_method",
                                  "gcl_model", "gcl_fuse_method",
                                  "data_dir", "device"):
            raise ValueError(f"ml_exp: unknown argument {arg!r}")
        config[key] = value
    return [run(**config)]


if __name__ == "__main__":
    main()

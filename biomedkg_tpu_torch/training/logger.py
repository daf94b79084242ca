"""Experiment logging (counterpart of biomedkg_tpu/training/logger.py):
JSONL and CSV always, Comet only where ``comet_ml`` imports and a key is
set (``common.find_comet_api_key``).

Both files are continued, not truncated, when they exist, and the CSV's
columns widen as new keys appear (the epoch's ``val_*``, the final
``test_*``), its earlier rows rewritten under the wider header.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict

from ..common import find_comet_api_key


class MetricsLogger:
    def __init__(self, save_dir: str, experiment_name: str,
                 project_name: str = "BioMedKG-TPU"):
        self.save_dir = save_dir
        self.experiment_name = experiment_name
        os.makedirs(save_dir, exist_ok=True)
        self._jsonl = open(os.path.join(save_dir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(save_dir, "metrics.csv")
        self._csv_fields: list = ["step", "time"]
        self._csv_rows: list = []
        if os.path.exists(self._csv_path):
            with open(self._csv_path, newline="") as f:
                reader = csv.DictReader(f)
                if reader.fieldnames:
                    self._csv_fields = list(reader.fieldnames)
                    self._csv_rows = list(reader)
        self._comet = self._try_comet(project_name)

    def _try_comet(self, project_name: str):
        api_key = find_comet_api_key()
        if not api_key:
            return None
        try:  # pragma: no cover - needs comet_ml and a network
            import comet_ml

            exp = comet_ml.Experiment(api_key=api_key,
                                      project_name=project_name)
            exp.set_name(self.experiment_name)
            return exp
        except Exception:
            return None

    def log(self, metrics: Dict[str, float], step: int):
        record = {"step": int(step), "time": time.time(), **{
            k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        self._csv_rows.append(record)
        new_keys = [k for k in record if k not in self._csv_fields]
        if new_keys:
            # widen the schema and rewrite (metric logs are small)
            self._csv_fields.extend(new_keys)
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_fields,
                                   restval="")
                w.writeheader()
                w.writerows(self._csv_rows)
        else:
            write_header = not os.path.exists(self._csv_path)
            with open(self._csv_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_fields,
                                   restval="")
                if write_header:
                    w.writeheader()
                w.writerow(record)
        if self._comet is not None:  # pragma: no cover
            self._comet.log_metrics(metrics, step=step)

    def close(self):
        self._jsonl.close()
        if self._comet is not None:  # pragma: no cover
            self._comet.end()

"""Interactive KGE scoring CLI (counterpart of serve.py at the repo root).

    python -m biomedkg_tpu_torch.serve pretrained_path=ckpt/kge/exp/best.ckpt

then on stdin (or piped):
    score <head_name> <relation_name> <tail_name>
    topk <head_name> <relation_name> [k]
    quit

The arguments are overrides of configs/kge.yaml, read by the config layer
(config.py) as the root serve.py reads them: ``pretrained_path``
(required), ``seed``, the data module's ``data.*`` keys (a checkpoint
trained on GCL or LM features is served with the ``data.node_init_method``
and ``data.embed_dim`` it was trained with, and ``gcl_model`` /
``gcl_fuse_method``), and the port's ``device`` (default cuda).
``PRIMEKG_DATA`` holds configs/data/primekg.yaml's graph, feature and
split settings.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional, TextIO

from .config import CONFIG_DIR, Config, cli_overrides, instantiate, \
    load_config
from .serving import KGEScorer


def primekg_data() -> dict:
    """configs/data/primekg.yaml's graph, feature and split arguments of
    ``PrimeKGModule`` (its unseen-node keys left to the caller)."""
    data = load_config(CONFIG_DIR, "kge").data
    return {k: data[k] for k in ("data_dir", "embed_dim", "node_type",
                                 "batch_size", "val_ratio", "test_ratio",
                                 "node_init_method")}


PRIMEKG_DATA = primekg_data()


def make_data_module(cfg: Config):
    """The data module ``cfg.data`` names, with the run's GCL cache keys,
    seed and device (not yet set up)."""
    return instantiate(cfg.data, gcl_model=cfg.gcl_model,
                       gcl_fuse_method=cfg.gcl_fuse_method, seed=cfg.seed,
                       device=cfg.get("device"))


def serve_loop(scorer: KGEScorer, lines: Iterable[str],
               out: TextIO) -> None:
    print("ready. commands: score <h> <r> <t> | topk <h> <r> [k] | quit",
          file=out, flush=True)
    for line in lines:
        parts = line.strip().split()
        if not parts:
            continue
        try:
            if parts[0] == "quit":
                break
            if parts[0] == "score" and len(parts) == 4:
                print(f"{scorer.score(parts[1], parts[2], parts[3]):.6f}",
                      file=out, flush=True)
            elif parts[0] == "topk" and len(parts) >= 3:
                k = int(parts[3]) if len(parts) > 3 else 10
                for name, p in scorer.topk_tails(parts[1], parts[2], k):
                    print(f"  {p:.6f}  {name}", file=out, flush=True)
            else:
                print("unrecognized command", file=out, flush=True)
        except (KeyError, ValueError) as e:
            # bad names, bad k, non-integer k — report, keep serving
            print(f"error: {e}", file=out, flush=True)


def parse_args(argv: List[str]) -> Config:
    cfg = load_config(CONFIG_DIR, "kge", cli_overrides(argv))
    if not cfg.get("pretrained_path"):
        raise SystemExit("usage: serve pretrained_path=<ckpt> [key=value "
                         "...] (overrides of configs/kge.yaml, and "
                         f"device=<cuda|cpu>); got {argv!r}")
    return cfg


def main(argv: Optional[List[str]] = None) -> None:
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    scorer = KGEScorer(cfg.pretrained_path, make_data_module(cfg),
                       device=cfg.get("device"))
    serve_loop(scorer, sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()

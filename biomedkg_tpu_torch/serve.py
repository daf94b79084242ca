"""Interactive KGE scoring CLI (counterpart of serve.py at the repo root).

    python -m biomedkg_tpu_torch.serve pretrained_path=ckpt/kge/exp/best.ckpt

then on stdin (or piped):
    score <head_name> <relation_name> <tail_name>
    topk <head_name> <relation_name> [k]
    quit

Arguments are ``key=value``: ``pretrained_path`` (required), ``seed``
(default 42) and ``device`` (default cuda). The data module takes the
defaults of configs/data/primekg.yaml, written out below until the config
layer is ported.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional, TextIO

from .data.modules import PrimeKGModule
from .serving import KGEScorer

PRIMEKG_DATA = dict(
    data_dir="./data/primekg", embed_dim=768,
    node_type=["gene/protein", "drug", "disease"], batch_size=128,
    val_ratio=0.2, test_ratio=0.2, node_init_method="random")


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


def parse_args(argv: List[str]) -> dict:
    args = {"pretrained_path": None, "seed": 42, "device": None}
    for arg in argv:
        key, sep, value = arg.partition("=")
        if not sep or key not in args:
            raise SystemExit(f"usage: serve pretrained_path=<ckpt> "
                             f"[seed=<int>] [device=<cuda|cpu>]; got {arg!r}")
        args[key] = int(value) if key == "seed" else value
    if not args["pretrained_path"]:
        raise SystemExit("serve: pretrained_path=<ckpt> is required")
    return args


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    data_module = PrimeKGModule(**PRIMEKG_DATA, seed=args["seed"])
    scorer = KGEScorer(args["pretrained_path"], data_module,
                       device=args["device"])
    serve_loop(scorer, sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()

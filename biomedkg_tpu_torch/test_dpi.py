"""DPI evaluation of a checkpoint (counterpart of test_dpi.py at the repo
root):

    python -m biomedkg_tpu_torch.test_dpi pretrained_path=<ckpt>

The arguments are overrides of configs/dpi.yaml, read by the config layer
(config.py), so ``scripts/test_dpi.sh``'s arguments work verbatim; the
keys and the flow are ``test_kge``'s (test_kge.py) over the DPI data
module (data/modules.py::DPIModule): the checkpoint (the port's own, the
JAX package's or a reference Lightning ``.ckpt``) tested on the test
split's SAINT batches, ``test_*`` metrics printed, then with
``data.unseen_node_ratio > 0`` the cold-start eval. As in the reference,
the relations are the DPI graph's own (``fix_edge_id`` is not set here).
It runs on the card unless ``device=cpu``. ``main`` returns the metrics.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .test_kge import evaluate


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    return evaluate("dpi", "test_dpi", argv)


if __name__ == "__main__":
    main()

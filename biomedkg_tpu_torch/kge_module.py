"""Import-layout alias for the reference's ``biomedkg.kge_module``
(counterpart of biomedkg_tpu/kge_module.py)."""

from .training.kge_module import (KGEModule, TrainState,  # noqa: F401
                                  load_kge_module)

"""Import-layout alias for the reference's ``biomedkg.gcl_module``
(counterpart of biomedkg_tpu/gcl_module.py)."""

from .training.gcl_module import (BaseGCL, DGIModule, GGDModule,  # noqa: F401
                                  GRACEModule, create_gcl_model,
                                  load_gcl_module)

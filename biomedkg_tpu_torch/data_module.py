"""Import-layout alias for the reference's ``biomedkg.data_module``
(counterpart of biomedkg_tpu/data_module.py)."""

from .data.modules import (DPIModule, PrimeKGModule,  # noqa: F401
                           get_node_encode_method)

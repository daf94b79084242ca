"""Import-layout alias for the reference's ``biomedkg.factory``
(counterpart of biomedkg_tpu/factory.py)."""

from .models.factory import (FusionFactory, GAE,  # noqa: F401
                             KGEModelFactory, create_kge_model)

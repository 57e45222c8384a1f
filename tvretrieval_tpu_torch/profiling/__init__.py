"""Stage profilers, the engine-mode study and the search simulation (the
port of the JAX package's ``profiling``)."""
from tvretrieval_tpu_torch.profiling.profile_models import (
    ProfileXML,
    index_storage_gb,
)

__all__ = ["ProfileXML", "index_storage_gb"]

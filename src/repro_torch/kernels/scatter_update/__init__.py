"""The binned segment scatter (Dalorex T3 in block form): its Hopper
kernel, plain PyTorch version and oracle.  See
:mod:`repro_torch.kernels.scatter_update.kernel`."""
from repro_torch.kernels.scatter_update.kernel import (  # noqa: F401
    LIBRARY, binned_scatter, scatter_segments)
from repro_torch.kernels.scatter_update.ref import scatter_ref  # noqa: F401

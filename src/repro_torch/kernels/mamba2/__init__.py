"""The Mamba2 SSD recurrence: its Hopper kernel, plain PyTorch versions and
step-by-step oracle.  See :mod:`repro_torch.kernels.mamba2.kernel`."""
from repro_torch.kernels.mamba2.kernel import LIBRARY, ssd_kernel  # noqa
from repro_torch.kernels.mamba2.ops import ssd  # noqa: F401
from repro_torch.kernels.mamba2.ref import (ssd_chunked,  # noqa: F401
                                            ssd_scan_oracle, ssd_step)

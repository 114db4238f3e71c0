"""The RWKV6 WKV recurrence: its Hopper kernel, plain PyTorch versions and
step-by-step oracle.  See :mod:`repro_torch.kernels.rwkv6.kernel`."""
from repro_torch.kernels.rwkv6.kernel import LIBRARY, wkv6_kernel  # noqa
from repro_torch.kernels.rwkv6.ops import wkv6  # noqa: F401
from repro_torch.kernels.rwkv6.ref import (wkv6_chunked,  # noqa: F401
                                           wkv6_scan_oracle, wkv6_step)

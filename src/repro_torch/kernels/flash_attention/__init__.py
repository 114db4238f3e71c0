"""Flash attention: its Hopper kernel, plain PyTorch version and naive
oracle.  See :mod:`repro_torch.kernels.flash_attention.kernel`."""
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    HEAD_DIMS, LIBRARY, flash_attention, repeat_kv_attention)
from repro_torch.kernels.flash_attention.ops import attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa

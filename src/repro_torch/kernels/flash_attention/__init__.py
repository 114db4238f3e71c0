"""Flash attention: its Hopper kernel, plain PyTorch version and naive
oracle.  See :mod:`repro_torch.kernels.flash_attention.kernel`."""
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    BWD_LIBRARY, HEAD_DIMS, LIBRARY, FlashAttention, attention_bwd_plain,
    attention_lse, flash_attention, flash_attention_bwd,
    flash_attention_fwd, repeat_kv_attention)
from repro_torch.kernels.flash_attention.ops import attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa

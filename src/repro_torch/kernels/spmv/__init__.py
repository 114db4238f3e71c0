"""Block-ELL SpMV: its Hopper kernel, plain PyTorch version, host format
conversion and oracles.  See :mod:`repro_torch.kernels.spmv.kernel`."""
from repro_torch.kernels.spmv.kernel import (  # noqa: F401
    LIBRARY, block_ell_matvec, spmv_block_ell)
from repro_torch.kernels.spmv.ref import (  # noqa: F401
    block_ell_ref, spmv_dense_ref, to_block_ell)

"""Entry point of the WKV6 recurrence for the models (port of
``repro.kernels.rwkv6.ops``): the Hopper kernel, its plain version, or one
decode step."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import ref
from repro_torch.kernels.rwkv6.kernel import wkv6_kernel


def wkv6(r, k, v, w_log, u, state0=None, use_kernel: bool = True,
         chunk: int = 16):
    """r, k, v, w_log: (B, S, H, K); u: (H, K).  Returns (y, final state),
    float32.

    One step with a state (decode) takes ``ref.wkv6_step``, no kernel, as
    the reference does.  Otherwise ``use_kernel=True`` calls
    :func:`wkv6_kernel` (the CUDA kernel on CUDA tensors, the chunked plain
    version on CPU tensors) and ``use_kernel=False`` the chunked plain
    version on any device, both at ``chunk``."""
    r, k, v, w_log = (a.float() for a in (r, k, v, w_log))
    if r.shape[1] == 1 and state0 is not None:  # decode fast path
        state, y = ref.wkv6_step(state0, r[:, 0], k[:, 0], v[:, 0],
                                 torch.exp(w_log[:, 0]), u)
        return y[:, None], state
    if use_kernel:
        return wkv6_kernel(r, k, v, w_log, u, state0=state0, chunk=chunk)
    return ref.wkv6_chunked(r, k, v, w_log, u, state0=state0, chunk=chunk)

"""Entry point of the Mamba2 SSD recurrence for the models (port of
``repro.kernels.mamba2.ops``): the Hopper kernel, its plain version, or one
decode step."""
from __future__ import annotations

from repro_torch.kernels.mamba2 import ref
from repro_torch.kernels.mamba2.kernel import ssd_kernel


def ssd(x, dt, a_log, Bm, Cm, state0=None, use_kernel: bool = True,
        chunk: int = 16):
    """x: (B, S, H, P); dt: (B, S, H); a_log: (H,); Bm, Cm: (B, S, N).
    Returns (y, final state), float32.

    One step with a state (decode) takes ``ref.ssd_step``, no kernel, as
    the reference does.  Otherwise ``use_kernel=True`` calls
    :func:`ssd_kernel` (the CUDA kernel on CUDA tensors, the chunked plain
    version on CPU tensors) on contiguous float32 copies, as the Pallas
    wrapper casts, and ``use_kernel=False`` the chunked plain version on
    any device, both at ``chunk``."""
    if x.shape[1] == 1 and state0 is not None:  # decode fast path
        state, y = ref.ssd_step(state0, x[:, 0], dt[:, 0], a_log,
                                Bm[:, 0], Cm[:, 0])
        return y[:, None], state
    if use_kernel:
        x, dt, Bm, Cm = (a.float().contiguous() for a in (x, dt, Bm, Cm))
        return ssd_kernel(x, dt, a_log, Bm, Cm, state0=state0, chunk=chunk)
    return ref.ssd_chunked(x, dt, a_log, Bm, Cm, state0=state0, chunk=chunk)

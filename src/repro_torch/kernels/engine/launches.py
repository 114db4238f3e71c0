"""Launch accounting for ``Stats.launches`` (port of
``repro.kernels.engine.launches``).

Every public kernel wrapper of :mod:`repro_torch.kernels.engine.kernel`
calls :func:`record` once per call, on either device — the CPU path counts
its plain-version calls the way the reference counts its interpret-mode
launches — and the engine brackets each round with :func:`tally`, so
``Stats.launches`` sums the kernel calls of every round.  Rounds run
eagerly here, so the tally is taken per executed round rather than at
trace time; for the classic program both give 5 per round unfused and 3
fused.

This is separate from each wrapper's ``launches`` attribute, which counts
only real CUDA launches (the evidence that a run went through the
kernels).  Counts nest: a tally sees every launch recorded while it is
open; with no tally open, :func:`record` is a no-op.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


class Tally:
    """Mutable launch counter; ``.n`` is valid once its context exits."""

    def __init__(self):
        self.n = 0


def record(n: int = 1) -> None:
    """Note ``n`` kernel launches against every open tally."""
    for t in _stack():
        t.n += n


@contextlib.contextmanager
def tally():
    """Open a launch-count scope: ``with tally() as t: ...; t.n``."""
    t = Tally()
    _stack().append(t)
    try:
        yield t
    finally:
        _stack().pop()

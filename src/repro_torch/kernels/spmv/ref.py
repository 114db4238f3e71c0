"""Oracles and host-side format conversion for block-ELL SpMV (port of
``repro.kernels.spmv.ref``).

:func:`to_block_ell` gives the reference's arrays bit for bit, but builds
them with one sort and one ``np.add.at`` instead of a Python loop over the
nonzeros: ``np.add.at`` adds repeated entries in input order, as the
reference's ``+=`` loop does, and the slots of a row-block are its
column-blocks in increasing order, as the reference's sorted buckets are.
"""
from __future__ import annotations

import numpy as np


def to_block_ell(n: int, rows, cols, vals, block: int, slots: int | None
                 = None):
    """COO -> block-ELL.  Returns (bvals (NB,S,b,b) f32, bcols (NB,S) i32,
    n_pad).  bcols -1 marks an empty slot.  Raises if a row-block needs more
    than ``slots`` column-blocks (caller picks slots from the histogram)."""
    nb = (n + block - 1) // block
    n_pad = nb * block
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    br, bc = rows // block, cols // block
    # one key per (row-block, column-block) pair, sorted as the reference's
    # buckets are; a pair's slot is its rank inside its row-block
    pairs, which = np.unique(br * nb + bc, return_inverse=True)
    pair_br, pair_bc = pairs // nb, pairs % nb
    first = np.searchsorted(pair_br, pair_br)  # first pair of its row-block
    pair_slot = np.arange(len(pairs)) - first
    width = int(pair_slot.max()) + 1 if len(pairs) else 1
    if slots is None:
        slots = width
    assert width <= slots, f"row-block needs {width} slots > {slots}"
    bvals = np.zeros((nb, slots, block, block), np.float32)
    bcols = np.full((nb, slots), -1, np.int32)
    bcols[pair_br, pair_slot] = pair_bc
    np.add.at(bvals, (br, pair_slot[which], rows % block, cols % block),
              np.asarray(vals))
    return bvals, bcols, n_pad


def spmv_dense_ref(n: int, rows, cols, vals, x):
    """y = A x oracle."""
    y = np.zeros(n, np.float64)
    np.add.at(y, np.asarray(rows),
              np.asarray(vals, np.float64) * np.asarray(x)[np.asarray(cols)])
    return y


def block_ell_ref(bvals, bcols, x_pad):
    """Pure-numpy block-ELL SpMV (the kernel's direct oracle), float64."""
    nb, slots, b, _ = bvals.shape
    y = np.zeros(nb * b, np.float64)
    for i in range(nb):
        for s in range(slots):
            c = bcols[i, s]
            if c >= 0:
                y[i * b:(i + 1) * b] += bvals[i, s].astype(np.float64) @ \
                    x_pad[c * b:(c + 1) * b]
    return y

"""Oracle for the binned segment scatter (Dalorex T3); port of
``repro.kernels.scatter_update.ref``."""
from __future__ import annotations

import numpy as np


def scatter_ref(base, idx, vals, op: str):
    """base: (NB, b); idx: (NB, cap) local indices (-1 empty);
    vals: (NB, cap).  op: "min" | "add".  Returns updated (NB, b)."""
    out = np.array(base, np.float32, copy=True)
    nb, cap = idx.shape
    for i in range(nb):
        for c in range(cap):
            j = idx[i, c]
            if j >= 0:
                if op == "min":
                    out[i, j] = min(out[i, j], vals[i, c])
                else:
                    out[i, j] += vals[i, c]
    return out

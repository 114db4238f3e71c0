"""Parameter specs, single-device part (port of
``repro.parallel.sharding``).

A :class:`ParamSpec` is a leaf's shape, logical axes, dtype and init rule;
:func:`init_tree` materializes a tree of them (nested dicts, tuples and
NamedTuples; ``None`` is an empty subtree) on one device.  The logical
axes are kept for ROADMAP §1's "SPMD on torch.distributed": the mesh,
its rule tables, ``lsc`` and ``gathered`` are not ported, since without a
mesh they are no-ops in the reference (``sharding.py:182-200``).

The init rule is the reference's, unchanged: ``normal`` leaves draw
N(0, 1) in float32, scaled by ``scale / sqrt(fan_in)`` with ``fan_in =
shape[0]``, then cast.  For a stacked block leaf ``(L, d, ...)`` that
``fan_in`` is the layer count ``L`` (ROADMAP §3).  The draws come from a
``torch.Generator``, one leaf after another in the tree's flattening
order, so a seed gives the same weights on every run, though not the JAX
package's (tests carry its weights over with ``params_from_numpy``).
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: str = "float32"
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0


def materialize(gen: torch.Generator, spec: ParamSpec, device):
    dtype = DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    std = spec.scale if spec.init == "embed" else spec.scale / fan_in ** 0.5
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def tree_map(fn, tree, is_leaf=lambda x: False):
    """Apply ``fn`` to every leaf of nested dicts (in sorted key order),
    tuples, lists and NamedTuples; ``None`` stays ``None``."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x, is_leaf) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, is_leaf) for x in tree)
    return fn(tree)


def init_tree(gen: torch.Generator, specs, device):
    """Materialize a tree of ParamSpec on ``device``, drawing from
    ``gen`` (a generator on that device) leaf by leaf."""
    return tree_map(lambda s: materialize(gen, s, device), specs,
                    is_leaf=lambda x: isinstance(x, ParamSpec))

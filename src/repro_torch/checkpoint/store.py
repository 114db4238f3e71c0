"""Atomic, validated checkpoints (port of ``repro.checkpoint.store``), in
the JAX package's on-disk format, so that a checkpoint written by either
package restores in the other bit for bit.

Layout:  <dir>/step_<N>/   arrays.npz (flattened key -> whole array)
                           manifest.json (step, keys, shapes, dtypes,
                                          sha256, extra)

* atomic: written to ``step_<N>.tmp`` then renamed, so a crash mid-write
  never corrupts the newest checkpoint;
* validated: the manifest carries the sha256 of ``arrays.npz``; a
  checkpoint that fails it is skipped by :func:`latest_valid_step`;
* keep-N garbage collection.

Keys are the tree's path, ``/``-joined: dict keys, and the index of a
tuple or NamedTuple field (``opt/1/...`` is the optimizer's master);
``None`` subtrees are absent.  npz holds only numpy's own dtypes, so a
bfloat16 array is stored as its uint16 bits and the manifest keeps the
dtype's name, as the reference stores it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

_TO_NUMPY = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int32: "int32", torch.int64: "int64",
             torch.int8: "int8", torch.float16: "float16",
             torch.uint8: "uint8", torch.bool: "bool"}
_FROM_NAME = {v: k for k, v in _TO_NUMPY.items()}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        if hasattr(template, "_fields"):
            return type(template)(*vals)
        return type(template)(vals)
    if template is None:
        return None
    return flat[prefix[:-1]]


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """(array as npz stores it, dtype name for the manifest)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        name = _TO_NUMPY[x.dtype]
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), name
        return x.numpy(), name
    a = np.asarray(x)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    if str(a.dtype) != dtype:
        raise IOError(f"stored dtype {a.dtype} is not the manifest's "
                      f"{dtype}")
    return torch.from_numpy(a.copy()).to(device)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep: int = 3) -> str:
    """Write ``tree`` (nested dicts, tuples and NamedTuples of tensors or
    arrays) as checkpoint ``step``; keep the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": dtypes,
        "sha256": _sha256(npz_path),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    for s in sorted(all_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return out


def _valid(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return _sha256(os.path.join(path, "arrays.npz")) \
            == manifest["sha256"]
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def latest_valid_step(ckpt_dir: str) -> int | None:
    """The newest checkpoint that passes its hash (crash recovery)."""
    for s in sorted(all_steps(ckpt_dir), reverse=True):
        if _valid(os.path.join(ckpt_dir, f"step_{s}")):
            return s
    return None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step}",
                           "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, template, device="cuda"):
    """Checkpoint ``step`` in the structure of ``template`` (its leaves
    only name the keys), as tensors on ``device``."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    if not _valid(path):
        raise IOError(f"checkpoint {path} failed validation")
    dtypes = read_manifest(ckpt_dir, step)["dtypes"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: _to_tensor(z[k], dtypes[k], device) for k in z.files}
    return _unflatten_into(template, flat)

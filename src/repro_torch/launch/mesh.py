"""Device meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

A mesh here is a :class:`~torch.distributed.device_mesh.DeviceMesh` over
an initialized default process group, one process a device: NCCL on
``"cuda"`` (one GPU a rank: NCCL refuses two ranks of a communicator on
one card), gloo on ``"cpu"``.  A process started by ``torchrun`` finds its
group from the environment; any other caller initializes it first (as
the tests and ``chip_smoke.py`` do, through a file store or
``tcp://127.0.0.1``).  Each rank's device is ``cuda:(local_rank %
device_count)``.  Functions only: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def auto_mesh(shape, axes, device_type: str = "cuda"):
    """A DeviceMesh of ``shape`` with dimensions named ``axes`` over the
    default process group (initialized here from the environment if it
    is not yet: ``torchrun``'s variables).  On ``"cuda"`` each rank takes
    ``cuda:(local_rank % device_count)``; without a GPU it raises (no
    fallback to gloo or the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, "
                         f"got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("auto_mesh(device_type='cuda') needs a CUDA "
                           "device; build a 'cpu' mesh to run over gloo")
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[device_type])
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise ValueError(f"a {device_type!r} mesh runs over "
                         f"{BACKENDS[device_type]!r}; the process group is "
                         f"{backend!r}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production shapes: 16 x 16 ``("data", "model")``,
    and a leading 2-pod axis when ``multi_pod``.  Raises unless the world
    size is the mesh's."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", 1))
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} "
                         f"processes; the world has {world}")
    return auto_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A small ``("data", "model")`` CPU mesh over gloo (tests,
    examples)."""
    return auto_mesh((data, model), ("data", "model"), device_type="cpu")


def rules_for(mesh, kind: str = "train"):
    """The sharding rule table for ``mesh`` (the reference's choice:
    multi-pod or single-pod, and the decode tables for ``kind="decode"``),
    read from :mod:`repro_torch.parallel.sharding` where it holds them."""
    from repro_torch.parallel import sharding
    multi = "pod" in (mesh.mesh_dim_names or ())
    if kind == "decode":
        name = "DECODE_RULES_MULTI" if multi else "DECODE_RULES"
    else:
        name = "MULTI_POD_RULES" if multi else "SINGLE_POD_RULES"
    rules = getattr(sharding, name, None)
    if rules is None:
        raise NotImplementedError(
            f"sharding.{name}: the mesh rule tables are ROADMAP.md §1's "
            f"'the rest of the LM substrate'")
    return rules

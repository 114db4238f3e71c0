"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points target the card unless asked for the CPU, and the kernel
wrappers' CUDA path refuses operands the kernels do not take."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.core.graph import CSRGraph, partition_graph
from repro_torch.kernels.engine import (edge_scan_gather, fold_scatter,
                                        frontier_pop, queue_push_pop)
from repro_torch.kernels.scatter_update import scatter_segments
from repro_torch.kernels.spmv import spmv_block_ell

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

ISOLATION_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import repro_torch
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    for m in mods:
        importlib.import_module(m)
    import chip_smoke  # its imports only: the phases run under __main__
    sys.path.insert(0, "tools")
    import port_round_profile
    import lm_serve_profile
    import flash_variants
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "repro"
                 or m.startswith("repro."))
    assert not bad, bad
    need = {"repro_torch.kernels.scatter_update.kernel",
            "repro_torch.kernels.scatter_update.ref",
            "repro_torch.kernels.spmv.kernel",
            "repro_torch.kernels.spmv.ref",
            "repro_torch.kernels.cuda_build",
            "repro_torch.core.algorithms", "repro_torch.core.program",
            "repro_torch.core.engine", "repro_torch.core.reference",
            "repro_torch.kernels.engine.kernel",
            "repro_torch.configs.base", "repro_torch.configs.granite_3_2b",
            "repro_torch.parallel.sharding", "repro_torch.core.embedding",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.configs.rwkv6_1_6b", "repro_torch.models.rwkv",
            "repro_torch.kernels.rwkv6.kernel",
            "repro_torch.kernels.rwkv6.ops",
            "repro_torch.kernels.rwkv6.ref",
            "repro_torch.configs.zamba2_2_7b", "repro_torch.models.mamba",
            "repro_torch.kernels.mamba2.kernel",
            "repro_torch.kernels.mamba2.ops",
            "repro_torch.kernels.mamba2.ref",
            "repro_torch.launch.serve"}
    assert need <= set(mods), sorted(need - set(mods))
    print("ISOLATED", len(mods))
""")


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    out = subprocess.run([sys.executable, "-c", ISOLATION_SCRIPT],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
    assert int(out.stdout.split()[-1]) >= 55  # every module was imported


def test_partition_graph_targets_the_card_by_default():
    """No device argument means CUDA; without a card that raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would succeed")
    g = CSRGraph.from_edges(4, torch.tensor([0, 1]).numpy(),
                            torch.tensor([1, 2]).numpy())
    with pytest.raises((RuntimeError, AssertionError)):
        partition_graph(g, 2)


def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_cuda_path_rejects_wrong_dtype_and_non_contiguous():
    """Non-CPU tensors take the CUDA path, which checks every operand
    before any launch: a wrong dtype, a non-contiguous tensor, or a tensor
    that is not on a CUDA device raises."""
    T, n = 2, 64
    k = meta((T,), torch.int32)
    with pytest.raises(TypeError):
        frontier_pop(meta((T, n), torch.uint8), k, 8)
    with pytest.raises(ValueError, match="contiguous"):
        frontier_pop(meta((n, T), torch.bool).t(), k, 8)
    with pytest.raises(ValueError, match="CUDA"):
        frontier_pop(meta((T, n), torch.bool), k, 8)

    data, count = meta((T, 16, 3), torch.int32), meta((T,), torch.int32)
    rows, valid = meta((T, 4, 3), torch.int32), meta((T, 4), torch.bool)
    with pytest.raises(TypeError):
        queue_push_pop(data, count, rows.float(), valid, count, 4)
    with pytest.raises(ValueError, match="contiguous"):
        queue_push_pop(data, count, rows, valid,
                       meta((T, 2), torch.int32)[:, 0], 4)

    ed, ev = meta((T, 100), torch.int32), meta((T, 100), torch.float32)
    st = meta((T, 10), torch.int32)
    rv = meta((T, 10), torch.bool)
    with pytest.raises(TypeError):
        edge_scan_gather(ed, ev.double(), st, st, rv, 8)
    with pytest.raises(ValueError, match="contiguous"):
        edge_scan_gather(ed, ev, meta((10, T), torch.int32).t(), st, rv, 8)

    tgt, vals = meta((T, 32), torch.float32), meta((T, 10), torch.float32)
    with pytest.raises(TypeError):
        fold_scatter(tgt, st.long(), vals, rv)
    with pytest.raises(ValueError, match="contiguous"):
        fold_scatter(tgt, st, meta((10, T), torch.float32).t(), rv)
    with pytest.raises(ValueError, match="CUDA"):
        fold_scatter(tgt, st, vals, rv, op="add")
    big = meta((T, 16385), torch.int32)  # past the add fold's sort buffer
    with pytest.raises(ValueError, match="16384"):
        fold_scatter(tgt, big, meta((T, 16385), torch.float32),
                     meta((T, 16385), torch.bool), op="add")

    base, idx = meta((4, 64), torch.float32), meta((4, 8), torch.int32)
    with pytest.raises(TypeError):
        scatter_segments(base, idx.long(), meta((4, 8), torch.float32))
    with pytest.raises(ValueError, match="CUDA"):
        scatter_segments(base, idx, meta((4, 8), torch.float32), op="add")
    with pytest.raises(ValueError):
        scatter_segments(base, idx, meta((4, 8), torch.float32), op="max")

    bv, bc = meta((2, 3, 32, 32), torch.float32), meta((2, 3), torch.int32)
    with pytest.raises(TypeError):
        spmv_block_ell(bv, bc, meta((64,), torch.float64))
    with pytest.raises(ValueError, match="shape"):
        spmv_block_ell(bv, bc, meta((65,), torch.float32))
    with pytest.raises(ValueError, match="CUDA"):
        spmv_block_ell(bv, bc, meta((64,), torch.float32))

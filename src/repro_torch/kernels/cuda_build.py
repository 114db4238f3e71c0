"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel source (``csrc/*.cu`` beside its wrapper module) has a plain C
interface: device pointers, sizes and the caller's ``cudaStream_t`` in,
``cudaGetLastError()`` out.  A :class:`CudaLibrary` compiles its source
with ``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch/`` at
the repository root, keyed by a hash of the source, the headers it
includes and the flags, and loads it with ``ctypes``.  A failed build
raises with nvcc's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
P, I = ctypes.c_void_p, ctypes.c_int  # argtypes of a pointer / a C int
# 3xTF32 products on mma.sync and cp.async, shared by the SSD and WKV6
# kernels
MMA_TF32 = Path(__file__).resolve().parent / "csrc" / "mma_tf32.cuh"


class CudaLibrary:
    """One kernel source, built and loaded once per process.

    ``signatures`` maps each exported launcher to its ``argtypes``;
    ``headers`` are the files the source includes, hashed with it."""

    def __init__(self, source: Path, signatures: dict, headers=()):
        self.source = Path(source)
        self.headers = tuple(Path(h) for h in headers)
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib = None
        self.path = None
        self.build_log = ""       # nvcc/ptxas output of this process's build
        self.build_seconds = 0.0  # 0 when an earlier build was reused

    def get(self):
        with self._lock:
            if self._lib is None:
                self.path = self._build()
                lib = ctypes.CDLL(str(self.path))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def _build(self) -> Path:
        blob = b"".join(p.read_bytes() for p in (self.source, *self.headers))
        tag = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"{self.source.stem}_{tag[:16]}.so"
        if out.exists():
            return out
        nvcc = cuda_tool()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def launch(self, name: str, *args):
        """Call launcher ``name`` with tensors as device pointers, ints as
        C ints and the current stream last; raise if the launch failed."""
        lib = self.get()
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        rc = getattr(lib, name)(*cargs,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}: "
                               f"{lib.repro_cuda_error_string(rc).decode()}")


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program: ``nvcc``, or ``cuobjdump`` to read
    what a built library holds."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", name), shutil.which(name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"{name} not found: the port's kernels are compiled with the CUDA "
        f"toolkit's nvcc at first use (set CUDA_HOME)")


def aligned(t, nbytes: int):
    """``t``, or a copy of it that starts on ``nbytes`` bytes (for a kernel
    that copies it in pieces of that size)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def check(*operands):
    """Check the operands of a CUDA launch, each ``(name, tensor, dtype,
    shape)``: every dtype, shape and contiguity first, then that each
    tensor lies on a CUDA device."""
    for name, x, dtype, shape in operands:
        if x.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    for name, x, _, _ in operands:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the kernel needs a CUDA tensor, got "
                             f"{x.device}")

"""Build the CUDA sources under ``csrc/`` at first use and bind them with ctypes.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The libraries land in ``build/paddle_tpu_torch/`` beside the package,
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. :func:`build` compiles several
sources at once, one ``nvcc`` process each.

Every C entry point takes its pointers and the stream as ``void*``,
launches on the stream it is given (PyTorch's current stream) and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises when that is not 0
and counts the launches that succeeded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEADERS = ("common.cuh",)

PTR = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int

_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the paddle_tpu_torch kernels")


class CudaKernel:
    """One ``csrc/`` source, its C entry point, and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [PTR]     # the stream comes last
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def library_path(self) -> str:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in (self.source,) + HEADERS:
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                digest.update(f.read())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")

    def _bind(self, path: str) -> None:
        fn = getattr(ctypes.CDLL(path), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def load(self):
        if self._fn is None:
            build([self])
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on a CUDA error."""
        fn = self.load()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def build(kernels: List[CudaKernel]) -> Dict[str, float]:
    """Compile every kernel not yet built, one nvcc each, all at once.

    Returns {source: seconds} for the sources compiled by this call."""
    with _LOCK:
        todo = [k for k in kernels if k._fn is None]
        for k in list(todo):
            if os.path.isfile(k.library_path()):
                k._bind(k.library_path())
                todo.remove(k)
        if not todo:
            return {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        t0 = time.perf_counter()
        for k in todo:
            out = k.library_path()
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, k.source_path]
            procs.append((k, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        seconds: Dict[str, float] = {}
        failed = []
        for k, out, tmp, proc in procs:
            log, _ = proc.communicate()
            seconds[k.source] = time.perf_counter() - t0
            k.build_log = log
            if proc.returncode != 0:
                failed.append(f"{k.source} (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            k._bind(out)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return seconds


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, shape: Sequence[int], device: torch.device,
          contiguous: bool = True) -> None:
    """Raise unless ``t`` is a float32 tensor of ``shape`` on ``device``.

    ``contiguous=False`` accepts any strides whose last one is 1 (the
    kernels take the outer strides as arguments)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not contiguous and t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dimension")

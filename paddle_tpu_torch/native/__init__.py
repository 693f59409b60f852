"""Native (C++) host runtime — build-on-first-import, ctypes-loaded.

The TPU compute path is XLA; this package holds the host-side native code
the reference keeps in C++ — currently the data-path scanners
(datapath.cc). The library is compiled once per source hash into
``~/.cache/paddle_tpu`` (or $PADDLE_TPU_CACHE) and loaded via ctypes; any
failure (no g++, sandboxed tmp, exotic platform) degrades to the pure
NumPy fallbacks in the callers, so the framework never hard-depends on a
toolchain at run time. Set PADDLE_TPU_NO_NATIVE=1 to force the fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from paddle_tpu_torch.utils import concurrency as cc
from typing import Optional

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "datapath.cc")
_ABI_VERSION = 1

_lock = cc.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cache_dir() -> str:
    d = os.environ.get("PADDLE_TPU_CACHE")
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu")
    os.makedirs(d, exist_ok=True)
    return d


def build_command(src: str, out: str) -> list:
    """The one datapath compile line — shared with setup.py's wheel
    prebuild so a bundled library can never be compiled with different
    flags than a first-import cache build."""
    return [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-shared",
        "-fPIC",
        "-std=c++17",
        "-o",
        out,
        src,
    ]


def _build(src: str, out: str) -> None:
    subprocess.run(build_command(src, out), check=True, capture_output=True,
                   timeout=120)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64

    lib.pt_pack_index_seq.argtypes = [i32p, i32p, i64, i64, i32p]
    lib.pt_pack_index_subseq.argtypes = [i32p, i32p, i64, i64, i64, i32p]
    lib.pt_pack_sparse_rows.argtypes = [i64p, f32p, i32p, i64, i64, f32p]
    lib.pt_pack_dense_seq.argtypes = [f32p, i32p, i64, i64, i64, f32p]
    lib.pt_pack_sparse_seq.argtypes = [i64p, f32p, i32p, i32p, i64, i64, i64, f32p]
    lib.pt_datapath_abi_version.restype = ctypes.c_int32
    for fn in (
        lib.pt_pack_index_seq,
        lib.pt_pack_index_subseq,
        lib.pt_pack_sparse_rows,
        lib.pt_pack_dense_seq,
        lib.pt_pack_sparse_seq,
    ):
        fn.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The datapath library, building it if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PADDLE_TPU_NO_NATIVE"):
            return None
        # a wheel-bundled prebuild (setup.py BuildPyWithDatapath) skips
        # the toolchain requirement entirely — accepted only when BOTH
        # the ABI version and the build-time source-hash stamp match the
        # present datapath.cc, so a stale-but-ABI-compatible binary can
        # never silently shadow an edited source (the same guarantee the
        # hash-keyed cache path gives)
        bundled = os.path.join(os.path.dirname(_SRC), "_datapath.so")
        if os.path.exists(bundled):
            try:
                with open(_SRC, "rb") as f:
                    src_digest = hashlib.sha256(f.read()).hexdigest()
                with open(bundled.replace(".so", ".hash")) as f:
                    stamp = f.read().strip()
                if stamp == src_digest:
                    lib = ctypes.CDLL(bundled)
                    if lib.pt_datapath_abi_version() == _ABI_VERSION:
                        _lib = _declare(lib)
                        return _lib
            except Exception:  # noqa: BLE001 — stale/foreign-arch bundle
                pass
        try:
            with open(_SRC, "rb") as f:
                src_bytes = f.read()
            tag = hashlib.sha256(src_bytes).hexdigest()[:16]
            so = os.path.join(_cache_dir(), f"datapath_{tag}.so")
            if not os.path.exists(so):
                tmp = f"{so}.tmp.{os.getpid()}"
                _build(_SRC, tmp)
                os.replace(tmp, so)  # atomic vs concurrent builders
            lib = _declare(ctypes.CDLL(so))
            if lib.pt_datapath_abi_version() != _ABI_VERSION:
                return None
            _lib = lib
        except Exception as e:  # noqa: BLE001 — any failure means fallback
            sys.stderr.write(
                f"paddle_tpu: native datapath unavailable ({e!r}); "
                "using NumPy fallback\n"
            )
            _lib = None
        return _lib


def ptr(arr, ctype):
    """ctypes pointer into a numpy array (must be C-contiguous)."""
    return arr.ctypes.data_as(ctypes.POINTER(ctype))

"""Parameter updater hooks — the StaticPruningHook.

Reference: /root/reference/paddle/parameter/ParameterUpdaterHook.cpp:37.
A user-supplied bitmask file defines which weights are enabled; ``init``
masks the parameter VALUE once at startup, ``update`` masks the GRADIENT
every step — so pruned weights start at zero and never receive updates
(momentum/adam statistics of a masked gradient stay zero; L1/L2 decay of
an exactly-zero weight is zero).

Mask file format v0 (StaticMaskHeader, bit-exact with the reference):
packed little-endian ``uint32 version; uint64 size`` header, then
ceil(size/8) bytes of MSB-first bits, 1 = weight enabled. ``.npy`` files
holding a 0/1 array are also accepted (TPU-era convenience).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

_HEADER = struct.Struct("<IQ")


def write_mask_file(path: str, mask: np.ndarray) -> None:
    """Write a v0 bitmask file (1 = enabled); mask may be any shape."""
    flat = np.asarray(mask).reshape(-1) != 0
    n = flat.size
    data = bytearray(_HEADER.pack(0, n))
    buf = 0
    for i, bit in enumerate(flat):
        buf = (buf << 1) | int(bit)
        if i % 8 == 7:
            data.append(buf)
            buf = 0
    if n % 8:
        data.append(buf << (8 - n % 8))  # low bits of the end byte are zero
    with open(path, "wb") as f:
        f.write(bytes(data))


def load_mask_file(path: str) -> np.ndarray:
    """Read a mask file (v0 bitmask or .npy) → flat bool array."""
    if path.endswith(".npy"):
        return np.load(path).reshape(-1) != 0
    with open(path, "rb") as f:
        raw = f.read()
    version, size = _HEADER.unpack_from(raw)
    assert version == 0, f"{path}: unsupported mask version {version}"
    bits = np.unpackbits(np.frombuffer(raw, np.uint8, offset=_HEADER.size))
    assert bits.size >= size, f"{path}: truncated mask ({bits.size} < {size})"
    return bits[:size] != 0


def resolve_mask(mask_filename: str, shape, init_model_path: str = "") -> np.ndarray:
    """Locate and load a pruning mask, reshaped to the parameter's shape.

    Search order matches the reference StaticPruningHook ctor: the path as
    given, then relative to --init_model_path."""
    path = mask_filename
    if not os.path.exists(path) and init_model_path:
        path = os.path.join(init_model_path, mask_filename)
    assert os.path.exists(path), (
        f"cannot load pruning mask {mask_filename!r} (also searched "
        f"init_model_path {init_model_path!r})"
    )
    flat = load_mask_file(path)
    n = int(np.prod(shape))
    assert flat.size == n, (
        f"pruning mask {path} has {flat.size} bits but parameter has {n} weights"
    )
    return flat.reshape(shape)

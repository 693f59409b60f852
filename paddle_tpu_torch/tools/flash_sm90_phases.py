"""Where a tile of the bf16 flash bodies for Hopper goes: the phase clocks
of csrc/flash_attn_fwd.cu (flash_attn_fwd_bf16_sm90) and
csrc/flash_attn_bwd.cu (flash_attn_dq_bf16_sm90, flash_attn_dkv_bf16_sm90),
read from one heavy block.

Run from the root of a checkout, on a machine with the GPU and nvcc:

    python3 -m paddle_tpu_torch.tools.flash_sm90_phases

Both sources are built as they stand with -DFLASH_SM90_PHASES, which turns
on their FLASH_SM90_PHASE probes (csrc/flash_attn.cuh): thread 0 of each
warpgroup reads clock64() at the phase boundaries of every key tile
(forward and dQ: the block of batch 0, head 0 and the last query tile,
the heaviest under the causal mask) or query tile (dK/dV: the block of
the first 128 keys). One nvcc per source, both at once, into
build/flash_sm90_phases/; each body is bound with ctypes and launched
three times at the long-context LM's shape (B = 8, T = 2048, H = 8,
D = 64, causal, full lengths) on strided views of a fused qkv, its
source's clocks zeroed first; the last launch's clocks are read. Prints, per body and warpgroup, the median cycles of each
phase over the tiles, the median cycles a tile and the tile count, as one
JSON object per body, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

PHASES = {
    "fwd": ("full_wait", "scores", "softmax_and_pieces", "pv_and_add", "release"),
    "dq": ("full_wait", "scores", "p_ds_and_pieces", "dq", "release"),
    "dkv": ("full_wait", "scores", "p_ds_and_pieces", "dv_dk", "release"),
}
SOURCES = {"fwd": "flash_attn_fwd.cu", "bwd": "flash_attn_bwd.cu"}
SOURCE_OF = {"fwd": "fwd", "dq": "bwd", "dkv": "bwd"}


def build(root):
    """One nvcc per source with its probes on, both at once:
    {"fwd": path, "bwd": path}."""
    from paddle_tpu_torch.ops import _build

    out_dir = os.path.join(root, "build", "flash_sm90_phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, source in SOURCES.items():
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DFLASH_SM90_PHASES", "-I",
             _build.CSRC_DIR, "-o", lib, os.path.join(_build.CSRC_DIR, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log[-4000:]}")
        libs[name] = lib
    return libs


def _summary(clocks, phases):
    import numpy as np

    out = {}
    for wg in range(2):
        tiles = [t for t in range(clocks.shape[1]) if clocks[wg, t, 0]]
        if not tiles:
            continue
        deltas = np.array([np.diff(clocks[wg, t, :6]) for t in tiles])
        per_tile = [int(clocks[wg, b, 0] - clocks[wg, a, 0]) for a, b in zip(tiles, tiles[1:])]
        out[f"warpgroup_{wg}"] = {
            "tiles": len(tiles),
            "median_cycles": dict(zip(phases, np.median(deltas, axis=0).astype(int).tolist())),
            "median_cycles_a_tile": int(np.median(per_tile)) if per_tile else None}
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_sm90_phases: no CUDA device")
    root = os.getcwd()
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops import flash_attention as fa

    libs = build(root)
    dev = torch.device("cuda")
    B, T, H, D = 8, 2048, 8, 64
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(B, T, 3, H, D).astype(np.float32)).to(dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(dev).to(torch.bfloat16)
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    out = torch.empty(B, T, H, D, device=dev, dtype=torch.bfloat16)
    lse = torch.empty(B, H, T, device=dev)
    dk, dv = torch.empty_like(out), torch.empty_like(out)
    stream = torch.cuda.current_stream().cuda_stream
    st = lambda t: [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dq = torch.empty_like(out)
    for name, kernel in (("fwd", fa.FLASH_ATTN_FWD_BF16_SM90), ("dq", fa.FLASH_ATTN_DQ_BF16_SM90),
                         ("dkv", fa.FLASH_ATTN_DKV_BF16_SM90)):
        symbol = kernel.symbol
        lib = ctypes.CDLL(libs[SOURCE_OF[name]])
        fn = getattr(lib, symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        if lib.phase_clocks_reset():
            raise RuntimeError("phase_clocks_reset failed")
        for _ in range(3):
            if name == "fwd":
                err = fn(*st(q), *st(k), *st(v), lengths.data_ptr(), *st(out), lse.data_ptr(),
                         B, T, H, D, 1, stream)
            else:
                delta = torch.sum(do.float() * out.float(), dim=-1).transpose(1, 2).contiguous()
                grads = [*st(dq)] if name == "dq" else [*st(dk), *st(dv)]
                err = fn(*st(q), *st(k), *st(v), *st(do), lse.data_ptr(), delta.data_ptr(),
                         lengths.data_ptr(), *grads, B, T, H, D, 1, stream)
            if err:
                raise RuntimeError(f"{symbol}: CUDA error {err}")
        torch.cuda.synchronize()
        clocks = np.zeros((2, 64, 8), np.int64)
        if lib.phase_clocks(clocks.ctypes.data):
            raise RuntimeError("phase_clocks failed")
        print(json.dumps({"body": symbol, "shape": {"B": B, "T": T, "H": H, "D": D,
                                                    "causal": True},
                          "card": smi, **_summary(clocks, PHASES[name])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

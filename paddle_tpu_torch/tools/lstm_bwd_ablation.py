"""Where a step of kernel 8 (csrc/lstm_bwd.cu) goes: edited copies of its
source timed side by side on the card.

Run from the root of a checkout, on a machine with the GPU and nvcc:

    python3 -m paddle_tpu_torch.tools.lstm_bwd_ablation

Each variant is the committed csrc/ with a few lines replaced: the product's
loads, its butterfly or its FMAs taken out (the results are then wrong, the
time is what remains), or another product_colsum_staged tile (columns a
thread, rows a chunk, ring slots) for a block of 8 units. One nvcc per
variant, all at once, into build/lstm_bwd_ablation/; each is bound with
ctypes in place of fused_lstm.LSTM_BWD and launched at the LSTM
classifier's shape (T = 64, B = 256, H = 512, two row groups), timed as
chip_smoke.py times kernels (device time from a cold L2, the host's
enqueue hidden) with block 0's phase clocks. Prints one JSON object per
variant and writes them all to build/lstm_bwd_ablation/results.json.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

TILE8 = "static constexpr int kCols = 8, kRows = 4, kStages = 2;"
HALVE = "Halve<kRows * N, 16>::run(&acc[0][0], lane);"
PRODUCT_FMA = "a = fmaf(xa[u], w[u][c2], a);"
DW_FMA = "d[u][c2] = fmaf(sr[c2], x[u][r], d[u][c2]);"
ISSUES = ("if (c < chunks) issue(c);", "if (c + kStages - 1 < chunks) issue(c + kStages - 1);")
GRID, KERNEL = "persistent_grid.cuh", "lstm_bwd.cu"


def _tile(cols, rows, stages):
    return (KERNEL, TILE8,
            f"static constexpr int kCols = {cols}, kRows = {rows}, kStages = {stages};")


# name -> [(file, old, new)]
VARIANTS = {
    "committed": [],
    "no_butterfly": [(GRID, HALVE, "")],
    "no_dw_fma": [(GRID, DW_FMA, "")],
    "compute_only": [(GRID, ISSUES[0], ""), (GRID, ISSUES[1], "")],
    "loads_only": [(GRID, HALVE, ""), (GRID, PRODUCT_FMA, ""), (GRID, DW_FMA, "")],
    "tile_4_4_4": [_tile(4, 4, 4)],
    "tile_4_4_4_no_butterfly": [_tile(4, 4, 4), (GRID, HALVE, "")],
    "tile_4_4_4_no_dw_fma": [_tile(4, 4, 4), (GRID, DW_FMA, "")],
    "tile_4_4_4_neither": [_tile(4, 4, 4), (GRID, HALVE, ""), (GRID, DW_FMA, "")],
    "tile_4_8_2": [_tile(4, 8, 2)],
    "tile_4_4_2": [_tile(4, 4, 2)],
    "tile_2_8_4": [_tile(2, 8, 4)],
}


def build(root, variants=VARIANTS, kernel=KERNEL):
    """One nvcc per variant of csrc/``kernel``, all at once; {name:
    (library, ptxas lines)}."""
    from paddle_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    procs = {}
    for name, edits in variants.items():
        src = os.path.join(root, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, src)
        for fname, old, new in edits:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {fname} exactly once")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        lib = os.path.join(src, os.path.splitext(kernel)[0] + ".so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", src, "-o", lib, os.path.join(src, kernel)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        built[name] = (lib, [l.strip() for l in log.splitlines()
                             if "registers" in l or "spill" in l])
    return built


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lstm_bwd_ablation: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_lstm as fl

    root = os.path.join("build", "lstm_bwd_ablation")
    built = build(root)
    dev = resolve_device(None)
    rng = np.random.RandomState(3)                # chip_smoke.phase_lstm_kernels' inputs
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    T, B, H = cs.LSTM["T"], cs.LSTM["batch"], cs.LSTM["hidden"]
    x4 = t(rng.randn(B, T, 4 * H) * 0.5).transpose(0, 1)
    w = t(rng.randn(H, 4 * H) / np.sqrt(H))
    peep = t(rng.randn(3, H) * 0.1)
    lens = rng.randint(T // 2, T + 1, B)
    lens[5] = 0
    mask = t(np.arange(T)[:, None] < lens[None, :])
    dy = t(rng.randn(T, B, H))
    _, saved, hprev, cprev = fl._launch_fwd(x4, mask, w, peep, False, fl.DEFAULT_ACTS, True)
    args = (dy, saved, hprev, cprev, mask, w, peep, False, fl.DEFAULT_ACTS)
    committed = fl.LSTM_BWD
    want = fl._launch_bwd(*args)
    results = {}
    try:
        for name, (lib, ptxas) in built.items():
            kernel = _build.CudaKernel(KERNEL, "lstm_bwd", committed.argtypes[:-1])
            kernel._bind(lib)
            fl.LSTM_BWD = kernel
            got = fl._launch_bwd(*args)
            clocks = torch.zeros((T, 3), dtype=torch.int64, device=dev)
            fl._launch_bwd(*args, phase_ns=clocks)
            torch.cuda.synchronize()
            spans = (clocks[:, 1:] - clocks[:, :-1]).double().mean(0).cpu().tolist()
            results[name] = {
                "variant": name, "device_ms": cs.time_ms(torch, lambda: fl._launch_bwd(*args),
                                                         hide_host=True),
                "phase1_and_barrier_us": spans[0] / 1e3, "phase2_us": spans[1] / 1e3,
                "max_abs_diff_from_committed": max(float((a - b).abs().max())
                                                   for a, b in zip(got, want)),
                "ptxas": ptxas}
            cs.emit(results[name])
    finally:
        fl.LSTM_BWD = committed
    with open(os.path.join(root, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

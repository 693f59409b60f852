"""Where a row tile of kernel 9's bf16 body goes, and its time: the phase
clocks of csrc/conv1x1_bn.cu (conv1x1_stats_bf16), read from one block,
and its device time at every shape of a ResNet-50 train step.

Run from the root of a checkout, on a machine with the GPU and nvcc:

    python3 -m paddle_tpu_torch.tools.conv1x1_phases [--csrc DIR ...]

Each source directory (the package's csrc/ by default; name another, such
as an unpacked parent commit's paddle_tpu_torch/csrc, to set two bodies
side by side) is built twice, one nvcc each, all at once, into
build/conv1x1_phases/: as it stands, and with -DCONV1X1_PHASES, which
turns on the CONV1X1_PHASE probes where the source has them (nothing in
the normal build): thread 0 of each warpgroup of block (0, 0) adds the
cycles of four phases of each of its row tiles (waiting for stages, the
products, the epilogue's staging, its stores and statistics). Each build
is bound with ctypes and launched without a bias on seeded bf16 inputs.

- Times: at the nine (M, K, N) of ResNet-50's 1x1 stride-1 convs at 224²
  and batch 64 (flagship.resnet_config, as chip_smoke.py's conv_shapes),
  the normal builds in turns (A, B, B, A for two sources) and bf16
  torch.addmm (the product alone), each the median of 20 device times
  from a cold L2 (the card kept busy while the host enqueues, so that no
  host time counts). One JSON object per shape, then one with the sums
  over a step's 30 launches.
- Phases: at 207,936 x 64 x 256 (bytes bind it) and 4,096 x 2,048 x 512
  (operations do), the probed builds run three times and the last
  launch's clocks are read: per warpgroup the row tiles probed, the median
  cycles of each phase a tile and of a whole tile. A source without the
  probes reports none.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

PHASES = ("stage_wait", "products", "epilogue_staging", "stores_and_stats")
PHASE_SHAPES = ((207936, 64, 256), (4096, 2048, 512))


def resnet_shapes():
    """{(M, K, N): launches a step} of ResNet-50's 1x1 stride-1 convs at
    224² and batch 64."""
    from collections import Counter

    from paddle_tpu_torch.flagship import resnet_config

    count = Counter()
    for layer in resnet_config(50, 224, 1000).model_config.layers:
        cc = layer.inputs[0].conv_conf if layer.type == "exconv" else None
        if cc is not None and cc.filter_size == 1 and cc.stride == 1:
            count[(64 * cc.img_size ** 2, cc.channels, layer.num_filters)] += 1
    return dict(count)


def build(root, csrcs):
    """{(index, probed): library path}: each source directory built plain
    and with its probes on, one nvcc each, all at once."""
    from paddle_tpu_torch.ops import _build

    out_dir = os.path.join(root, "build", "conv1x1_phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, csrc in enumerate(csrcs):
        for probed in (False, True):
            lib = os.path.join(out_dir, f"conv1x1_bn_{i}{'_phases' if probed else ''}.so")
            flags = ["-DCONV1X1_PHASES"] if probed else []
            procs[(i, probed)] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-I", csrc, "-o", lib,
                 os.path.join(csrc, "conv1x1_bn.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{csrcs[key[0]]}: nvcc exit {proc.returncode}\n{log[-4000:]}")
        libs[key] = lib
    return libs


def _summary(clocks):
    import numpy as np

    out = {}
    for wg in range(2):
        tiles = [t for t in range(clocks.shape[1]) if clocks[wg, t].any()]
        if not tiles:
            continue
        per = clocks[wg, tiles]
        out[f"warpgroup_{wg}"] = {
            "tiles": len(tiles),
            "median_cycles": dict(zip(PHASES, np.median(per, axis=0).astype(int).tolist())),
            "median_cycles_a_tile": int(np.median(per.sum(axis=1)))}
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=None,
                    help="a directory holding conv1x1_bn.cu and its headers (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv1x1_phases: no CUDA device")
    root = os.getcwd()
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    csrcs = [os.path.abspath(c) for c in (args.csrc or [_build.CSRC_DIR])]
    names = [os.path.relpath(c, root) for c in csrcs]
    libs = build(root, csrcs)
    fns = {}
    for key, path in libs.items():
        lib = ctypes.CDLL(path)
        fn = lib.conv1x1_stats_bf16
        fn.argtypes = fc.CONV1X1_STATS_BF16.argtypes
        fn.restype = ctypes.c_int
        fns[key] = (lib, fn)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB past the L2
    rng = np.random.RandomState(9)

    def device_ms(fn, reps=20):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def operands(M, K, N):
        x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dev).to(torch.bfloat16)
        w = torch.from_numpy((rng.randn(N, K) / np.sqrt(K)).astype(np.float32)).to(dev).to(
            torch.bfloat16)
        y = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
        s, q = torch.empty(N, device=dev), torch.empty(N, device=dev)
        part = torch.empty(min(-(-M // fc.TILE_M), _build.card_sms(dev)), 2, N, device=dev)
        vec = int(K % 8 == 0)

        def launch(fn):
            err = fn(x.data_ptr(), w.data_ptr(), None, y.data_ptr(), s.data_ptr(),
                     q.data_ptr(), part.data_ptr(), M, K, N, vec,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"conv1x1_stats_bf16: CUDA error {err}")

        return x, w, launch

    order = list(range(len(csrcs)))
    step = {name: 0.0 for name in names + ["addmm"]}
    for (M, K, N), per_step in sorted(resnet_shapes().items()):
        x, w, launch = operands(M, K, N)
        turns = {i: [] for i in order}
        for i in order + order[::-1]:
            turns[i].append(device_ms(lambda: launch(fns[(i, False)][1])))
        bias = torch.zeros(N, device=dev, dtype=torch.bfloat16)
        lib_ms = device_ms(lambda: torch.addmm(bias, x, w.t()))
        for i, name in enumerate(names):
            step[name] += per_step * statistics.median(turns[i])
        step["addmm"] += per_step * lib_ms
        print(json.dumps({"shape": {"M": M, "K": K, "N": N}, "per_step": per_step,
                          "device_ms_turns": {name: turns[i] for i, name in enumerate(names)},
                          "addmm_device_ms": lib_ms, "card": smi}), flush=True)
        del x, w, launch
    print(json.dumps({"step_device_ms": step, "launches": 30, "card": smi}), flush=True)

    for M, K, N in PHASE_SHAPES:
        _, _, launch = operands(M, K, N)
        for i, name in enumerate(names):
            lib, fn = fns[(i, True)]
            phases = {}
            if hasattr(lib, "conv1x1_phase_reset"):
                for _ in range(3):
                    if lib.conv1x1_phase_reset():
                        raise RuntimeError("conv1x1_phase_reset failed")
                    launch(fn)
                torch.cuda.synchronize()
                clocks = np.zeros((2, 64, 4), np.int64)
                if lib.conv1x1_phase_clocks(clocks.ctypes.data):
                    raise RuntimeError("conv1x1_phase_clocks failed")
                phases = _summary(clocks)
            print(json.dumps({"csrc": name, "shape": {"M": M, "K": K, "N": N},
                              "phases": phases or None, "card": smi}), flush=True)
        del launch
    return 0


if __name__ == "__main__":
    sys.exit(main())

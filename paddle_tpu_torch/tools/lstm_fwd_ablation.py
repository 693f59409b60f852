"""Where a step of kernels 7a and 7b (csrc/lstm_fwd.cu) goes: edited copies
of the source timed side by side on the card.

Run from the root of a checkout, on a machine with the GPU and nvcc:

    python3 -m paddle_tpu_torch.tools.lstm_fwd_ablation

Each variant is the committed csrc/ with a few lines replaced: the staging
of h or the product's tensor-core steps taken out, or one TF32 product in
place of the 3-pass split (the results are then wrong, or less accurate:
the time is what remains), x4 loaded a step ahead (before the barrier)
instead of before its own step's product, another ring (slots, floats a
slot), or the step's product on the CUDA cores as pgrid::block_product
(the lanes of a warp split k over 8 rows, then the halving butterfly; w's
quads unswizzled, the [R][4 U] product in the ring's shared memory, which
holds it at 2 and 4 row groups). One nvcc per variant, all at once, into build/lstm_fwd_ablation/; each is bound with
ctypes in place of fused_lstm.LSTM_FWD and launched (kernel 7a) at the
LSTM classifier's shape (T = 64, B = 256, H = 512) with 2 and 4 row
groups, timed as chip_smoke.py times kernels (device time from a cold L2,
the host's enqueue hidden) with block 0's phase clocks of the training
form. Prints one JSON object per variant and writes them all to
build/lstm_fwd_ablation/results.json.
"""

from __future__ import annotations

import json
import os
import sys

from paddle_tpu_torch.tools.lstm_bwd_ablation import build

KERNEL = "lstm_fwd.cu"
STAGES = "constexpr int kStages = 2; "
SLOT = "constexpr int kSlotFloats = 12800; "
ISSUES = ("if (c < total) issue(c);", "if (q + kStages - 1 < total) issue(q + kStages - 1);")
PRODUCT = "for (int kk = 0; kk < steps; ++kk) {"
SMALL = ("flash_mma::mma_tf32(ps[qq][j], a.small, b.big);",
         "flash_mma::mma_tf32(ps[qq][j], a.big, b.small);")


# the step's product as pgrid::block_product, read into the cells' fragments
BLOCK_PRODUCT = [
    (KERNEL, "const int c = static_cast<int>(e % 16) ^ (8 * ((k >> 1) & 1));",
     "const int c = static_cast<int>(e % 16);"),
    (KERNEL, "const int total = s > 0 ? passes * NC : 0;",
     "const int total = 0;\n"
     "    if (s > 0) {\n"
     "      for (int qd = 0; qd < nq; ++qd)\n"
     "        block_product<16>(reinterpret_cast<float*>(ring) + 16 * qd, 4 * U, rows,\n"
     "                          hin + static_cast<long long>(row0) * ldh, ldh, H, W + qd * WQ);\n"
     "      __syncthreads();\n"
     "    }"),
    (KERNEL, "for (int ch = 0; ch < NC; ++ch, ++q) {", "for (int ch = 0; ch < 0; ++ch, ++q) {"),
    (KERNEL, "      if (clocked && pass + 1 == passes) phase_ns[3 * s + 1] = global_ns();",
     "      for (int hh = 0; hh < 2 && s > 0; ++hh) {\n"
     "        const int r = r0 + g + 8 * hh;\n"
     "        for (int qq = 0; qq < 2 && r < rows; ++qq)\n"
     "          for (int j = 0; j < 2; ++j)\n"
     "            for (int e = 0; e < 2; ++e)\n"
     "              acc[qq][j][2 * hh + e] = reinterpret_cast<const float*>(ring)[\n"
     "                  r * 4 * U + 16 * (2 * qp + qq) + 8 * j + 2 * t + e];\n"
     "      }\n"
     "      if (clocked && pass + 1 == passes) phase_ns[3 * s + 1] = global_ns();"),
]


def _ring(stages, slot):
    return [(KERNEL, STAGES, f"constexpr int kStages = {stages}; "),
            (KERNEL, SLOT, f"constexpr int kSlotFloats = {slot}; ")]


# name -> [(file, old, new)]
VARIANTS = {
    "committed": [],
    "compute_only": [(KERNEL, ISSUES[0], ""), (KERNEL, ISSUES[1], "")],
    "staging_only": [(KERNEL, PRODUCT, "for (int kk = 0; kk < 0; ++kk) {")],
    "one_pass_tf32": [(KERNEL, SMALL[0], ""), (KERNEL, SMALL[1], "")],
    "x4_a_step_ahead": [
        (KERNEL, "load_x(tt, r0);\n", "if (passes > 1 || s == 0) load_x(tt, r0);\n"),
        (KERNEL, "if (clocked) phase_ns[3 * s + 2] = global_ns();",
         "if (next && passes == 1) load_x(tn, 16 * mt);\n    "
         "if (clocked) phase_ns[3 * s + 2] = global_ns();")],
    "ring_2x6400": _ring(2, 6400),
    "ring_3x6400": _ring(3, 6400),
    "ring_3x12800": _ring(3, 12800),
    "ring_2x25600": _ring(2, 25600),
    "block_product": BLOCK_PRODUCT,
}


def main() -> int:
    import ctypes

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lstm_fwd_ablation: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.ops import fused_lstm as fl

    root = os.path.join("build", "lstm_fwd_ablation")
    built = build(root, VARIANTS, KERNEL)
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
    want = fl.lstm_forward_reference(x4, mask, w, peep)
    saved = {k: (k._fn, k.launches) for k in (fl.LSTM_FWD, fl.LSTM_FWD_TRAIN)}
    fl.LSTM_FWD.load()
    fl.LSTM_FWD_TRAIN.load()
    results = {}
    try:
        for name, (lib, ptxas) in built.items():
            so = ctypes.CDLL(lib)
            for k in (fl.LSTM_FWD, fl.LSTM_FWD_TRAIN):
                fn = getattr(so, k.symbol)
                fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
                k._fn = fn
            row = {"variant": name, "ptxas": ptxas}
            for P in (2, 4):
                run = lambda: fl._launch_fwd(x4, mask, w, peep, False, fl.DEFAULT_ACTS, False,
                                             row_groups=P)
                try:
                    got = run()
                except RuntimeError as e:              # a ring past the shared memory
                    row[f"P{P}"] = {"error": str(e)}
                    continue
                torch.cuda.synchronize()
                clocks = torch.zeros((T, 3), dtype=torch.int64, device=dev)
                fl._launch_fwd(x4, mask, w, peep, False, fl.DEFAULT_ACTS, True, row_groups=P,
                               phase_ns=clocks)
                torch.cuda.synchronize()
                c = clocks.double().cpu()
                row[f"P{P}"] = {
                    "device_ms": cs.time_ms(torch, run, hide_host=True),
                    "max_abs_err": float((got - want).abs().max()),
                    "product_us": float((c[1:, 1] - c[1:, 0]).mean()) / 1e3,
                    "cells_us": float((c[:, 2] - c[:, 1]).mean()) / 1e3,
                    "barrier_us": float((c[1:, 0] - c[:-1, 2]).mean()) / 1e3}
            results[name] = row
            print(json.dumps(row), flush=True)
    finally:
        for k, (fn, n) in saved.items():
            k._fn, k.launches = fn, n
    with open(os.path.join(root, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

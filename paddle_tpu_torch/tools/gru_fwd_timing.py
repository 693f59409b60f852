"""Kernel 1's times at the serve prefill's shape, for the package of any
checkout: this design beside an earlier one, on one card in one call.

Run from the root of a checkout, on a machine with the GPU and nvcc:

    python3 paddle_tpu_torch/tools/gru_fwd_timing.py [--root DIR]

It imports ``paddle_tpu_torch`` from DIR (default: this checkout; for an
earlier design, a ``git archive`` of that commit unpacked somewhere), so
its kernels build from DIR's sources into DIR's build directory, and
calls that package's ``fused_gru`` without a gradient (kernel 1) on
chip_smoke.py's inputs: T = 32, H = 512, the first B rows of a B = 64
admission with ragged lengths and one all-masked row, for B = 64, 8 and
1, forward and reversed. Each case is held to the plain version
(``gru_forward_reference``, max abs error) and timed by this checkout's
``chip_smoke.time_ms``: with the wrapper's host work (ms) and without it
(device_ms). Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose paddle_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.ops import fused_gru as fg

    assert fg.__file__.startswith(root), (fg.__file__, root)
    dev = resolve_device(None)
    T, H, B0 = cs.FULL["prompt_tokens"], cs.FULL["dim"], cs.FULL["slots"]
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x3 = t(rng.randn(T, B0, 3 * H) * 0.5)
    w = t(rng.randn(H, 3 * H) / np.sqrt(H))
    lens = rng.randint(1, T + 1, B0)
    lens[3] = 0                                       # one all-masked row
    mask = t(np.arange(T)[:, None] < lens[None, :])
    cases = []
    with torch.no_grad():
        for B in cs.KERNEL1_BATCHES:
            xb, mb = x3[:, :B], mask[:, :B]
            for reverse in (False, True):
                run = lambda: fg.fused_gru(xb, mb, w, reverse=reverse)
                err = float((run() - fg.gru_forward_reference(xb, mb, w, reverse=reverse))
                            .abs().max())
                cases.append({"B": B, "reverse": reverse, "max_abs_err": err,
                              "ms": cs.time_ms(torch, run),
                              "device_ms": cs.time_ms(torch, run, hide_host=True)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "card": smi, "T": T, "H": H, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

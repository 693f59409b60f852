"""Where a step of the recurrent backward kernels goes: the phase clocks of
kernel 8 (the LSTM backward, csrc/lstm_bwd.cu and lstm_bwd_sm90.cu) and
kernel 6 (the attention-GRU decoder's backward, csrc/attention_gru_bwd.cu
and attention_gru_bwd_sm90.cu), each body read in turns in one process.

Run from the root of a checkout, on a machine with the GPU and nvcc:

    python3 -m paddle_tpu_torch.tools.recurrent_bwd_phases [--kernels 8,6] [--reps 20]

The kernels build at first use into build/ as everywhere in the package.
Each body is launched through its wrapper on seeded inputs at the main
path's shape: kernel 8 at the LSTM classifier's T = 64, B = 256, H = 512
(tanh, sigmoid, tanh), both directions; kernel 6 at the NMT decoder's
Td = Te = 32, B = 64, D = 512, E = 1024. The bodies: kernel 8's float32
instance (lstm_bwd), its persistent bf16 body (lstm_bwd_bf16, through
``_launch_bwd_persistent``) and its Hopper body (lstm_bwd_bf16_sm90, through
``_launch_bwd_sm90``); kernel 6's float32 instance (attention_gru_bwd), its
persistent bf16 body (attention_gru_bwd_bf16) and its Hopper body
(attention_gru_bwd_bf16_sm90).

- Times: the median of ``--reps`` device times a launch from a cold L2
  (the card kept busy while the host enqueues, so that no host time
  counts), the bodies in turns (A, B, C, C, B, A) and each body's medians
  listed in that order.
- Phases: block 0's clock (``%globaltimer``, ns) at the end of each phase
  of each step, read from a third launch with ``phase_ns``: the median and
  the sum over the steps of each phase in µs (the phases that end in a
  barrier include it), the loop's span from the first clock to the last,
  and what the launch spends outside it (device ms less the span: the
  weights' load and, for the Hopper bodies, the dW or dWa work after the
  loop). Kernel 8's phases: ``cells`` (phase 1 with the group barrier),
  ``product`` (DH); kernel 6's: ``gates`` (dh', du, dcand), ``drh``,
  ``dctx``, ``attention``, ``dh`` (each of the first four with the grid
  barrier after it, where the body has one).

One JSON object a body and direction, each with the card's name and power
limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

LSTM_SHAPE = dict(T=64, B=256, H=512)
NMT_SHAPE = dict(Td=32, Te=32, B=64, D=512, E=1024)
LSTM_PHASES = ("cells", "product")
NMT_PHASES = ("gates", "drh", "dctx", "attention", "dh")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def device_ms(torch, fn, reps):
    """Median device ms of fn() from a cold L2, the host's enqueue hidden
    behind a busy card."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
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


def phase_summary(clocks, names, start_ns=None):
    """Per phase the median and sum over the steps (µs) of block 0's clock
    differences; a step's first phase starts where the previous step's last
    ended (the first step's, at ``start_ns`` when the body records one)."""
    rows = clocks.tolist()
    per = {n: [] for n in names}
    prev = start_ns
    for row in rows:
        ends = row[-len(names):]
        for j, n in enumerate(names):
            begin = ends[j - 1] if j else prev
            if begin is not None:
                per[n].append((ends[j] - begin) * 1e-3)
        prev = ends[-1]
    span = (rows[-1][-1] - (start_ns if start_ns is not None else rows[0][-len(names)])) * 1e-6
    return ({n: {"median_us": statistics.median(v), "sum_us": sum(v)} for n, v in per.items()
             if v}, span)


def lstm_cases(torch, dev, reps, smi):
    import numpy as np

    from paddle_tpu_torch.ops import fused_lstm as fl

    T, B, H = LSTM_SHAPE["T"], LSTM_SHAPE["B"], LSTM_SHAPE["H"]
    acts = ("tanh", "sigmoid", "tanh")
    rng = np.random.RandomState(25)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x4 = f32(rng.randn(B, T, 4 * H) * 0.5).transpose(0, 1)
    w = f32(rng.randn(H, 4 * H) / np.sqrt(H))
    peep = f32(rng.randn(3, H) * 0.1)
    lens = rng.randint(T // 2, T + 1, B)
    mask = f32(np.arange(T)[:, None] < lens[None, :])
    dy = f32(rng.randn(T, B, H))
    out = []
    for reverse in (False, True):
        bodies = {}
        for dt in (torch.float32, torch.bfloat16):
            ops = [t.to(dt) for t in (x4, w, peep, dy)]
            _, saved, hprev, cprev = fl._launch_fwd(ops[0], mask, ops[1], ops[2], reverse, acts,
                                                    True)
            args = (ops[3], saved, hprev, cprev, mask, ops[1], ops[2], reverse, acts)
            if dt == torch.float32:
                bodies["lstm_bwd"] = (args, fl._launch_bwd_persistent)
            else:
                bodies["lstm_bwd_bf16"] = (args, fl._launch_bwd_persistent)
                bodies["lstm_bwd_bf16_sm90"] = (args, fl._launch_bwd_sm90)
        order = list(bodies) + list(bodies)[::-1]
        times = {n: [] for n in bodies}
        for n in order:
            args, launch = bodies[n]
            times[n].append(device_ms(torch, lambda: launch(*args), reps))
        for n, (args, launch) in bodies.items():
            clocks = torch.zeros((T, 3), dtype=torch.int64, device=dev)
            launch(*args, phase_ns=clocks)
            torch.cuda.synchronize()
            c = clocks.cpu()
            phases, span = phase_summary(c[:, 1:], LSTM_PHASES, start_ns=int(c[0, 0]))
            ms = statistics.median(times[n])
            out.append({"kernel": 8, "body": n, "reverse": reverse, "shape": LSTM_SHAPE,
                        "device_ms": times[n], "loop_ms": span, "outside_loop_ms": ms - span,
                        "phases": phases, "card": smi})
            print(json.dumps(out[-1]), flush=True)
    return out


def nmt_cases(torch, dev, reps, smi):
    import numpy as np

    from paddle_tpu_torch.ops import fused_attention_gru as fa

    Td, Te, B, D, E = (NMT_SHAPE[k] for k in ("Td", "Te", "B", "D", "E"))
    rng = np.random.RandomState(26)
    r = lambda *s: rng.randn(*s) * 0.3
    lens = rng.randint(1, Te + 1, B)
    em = (np.arange(Te)[:, None] < lens[None, :])[:, :, None]
    dm = (np.arange(Td)[:, None] < rng.randint(1, Td + 1, B)[None, :])[:, :, None]
    host = [r(B, Te, D), r(B, Te, E), em, r(Td, B, 3 * D), dm, r(B, D),
            rng.randn(D, D) / np.sqrt(D), r(1, D), r(1, D), rng.randn(E, 3 * D) / np.sqrt(E),
            rng.randn(D, 3 * D) / np.sqrt(D)]
    dy_host = rng.randn(Td, B, D)
    bodies = {}
    for dt in (torch.float32, torch.bfloat16):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).to(dt)
        args = [t(a) for a in host]
        args[0], args[1] = args[0].transpose(0, 1), args[1].transpose(0, 1)
        ys, hprev, saved, alpha, ctxs, m = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
        ep, ev, _, _, dmask, _, wa, ba, v, wctx, wg = args
        bwd = (t(dy_host), ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg)
        if dt == torch.float32:
            bodies["attention_gru_bwd"] = (bwd, fa._launch_bwd_persistent)
        else:
            bodies["attention_gru_bwd_bf16"] = (bwd, fa._launch_bwd_persistent)
            bodies["attention_gru_bwd_bf16_sm90"] = (bwd, fa._launch_bwd_sm90)
    order = list(bodies) + list(bodies)[::-1]
    times = {n: [] for n in bodies}
    for n in order:
        args, launch = bodies[n]
        times[n].append(device_ms(torch, lambda: launch(*args), reps))
    out = []
    for n, (args, launch) in bodies.items():
        clocks = torch.zeros((Td, len(NMT_PHASES)), dtype=torch.int64, device=dev)
        launch(*args, phase_ns=clocks)
        torch.cuda.synchronize()
        phases, span = phase_summary(clocks.cpu(), NMT_PHASES)
        ms = statistics.median(times[n])
        out.append({"kernel": 6, "body": n, "shape": NMT_SHAPE, "device_ms": times[n],
                    "loop_ms_after_first_step": span, "outside_loop_ms": ms - span,
                    "phases": phases, "card": smi})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="8,6", help="which of kernels 8 and 6, in order")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("recurrent_bwd_phases needs a CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.device import resolve_device

    dev = resolve_device(None)
    smi = card()
    for k in a.kernels.split(","):
        {"8": lstm_cases, "6": nmt_cases}[k.strip()](torch, dev, a.reps, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

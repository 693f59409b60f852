#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON object per line:

1. build   — compile every CUDA kernel of the serve path from csrc/ (one
             nvcc per source, all at once) and print the seconds it took.
2. kernels — at full width, on seeded inputs with ragged lengths and one
             all-masked row, hold each kernel against its plain PyTorch
             version (max abs error <= 1e-4 in float32, TF32 off) and time
             both with CUDA events.
3. serve   — the main path: the seqToseq NMT generation model at full
             width (vocab 30000, dim 512, random weights from seed 1)
             behind build_engine(slots=64, prompt_tokens=32,
             fused_step=True), answering 128 seeded requests. The kernel
             launch counters are zeroed just before the requests and read
             just after. The same requests then go through the unfused
             decode step, and a small prefill is checked against the CPU.

Then the per-kernel line ({"kernels": [...]}), the card's name and power
limit as nvidia-smi reports them, and as the last line
{"ok": true, "device": {...}}. Any failure raises, so the exit code is not
0 and no result line is printed; without a CUDA device, or without the
package beside this script, it fails the same way.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate,
# and the float32 rate outside the tensor cores (the kernels' arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TOL = 1e-4                 # f32, sums over K of 512..1536 terms in another order
FULL = dict(vocab=30000, dim=512, max_length=32, slots=64, prompt_tokens=32)
N_REQUESTS = 128
# the JAX package's allowance for argmax near-ties between two decode
# paths (SLOT_PARITY_TOL in paddle_tpu/graph/decode_step.py)
PARITY_TOL = 0.05


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings after warmup, each call
    starting from a cold L2: on the serve path the 61 MB output projection
    runs between two decode steps and evicts the 50 MB L2."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_build(kernels):
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_source = _build.build(kernels)
    ptxas = {k.source: [l.strip() for l in k.build_log.splitlines()
                        if "registers" in l or "spill" in l]
             for k in kernels}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "ptxas": ptxas})


def phase_kernels(torch, dev):
    """Each kernel against its plain version at the serve path's widths."""
    from paddle_tpu_torch.ops.fused_attention_gru import (
        attention_gru_reference, fused_attention_gru)
    from paddle_tpu_torch.ops.fused_gru import fused_gru, gru_forward_reference

    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    D, E, Te, B = FULL["dim"], 2 * FULL["dim"], FULL["prompt_tokens"], FULL["slots"]

    def lengths(T):
        lens = rng.randint(1, T + 1, B)
        lens[3] = 0                                   # one all-masked row
        return lens

    results = {}
    # kernel 1: the encoder GRU, T = prompt_tokens, H = dim
    T, H = Te, D
    x3 = t(rng.randn(T, B, 3 * H) * 0.5)
    w = t(rng.randn(H, 3 * H) / np.sqrt(H))
    mask = t((np.arange(T)[:, None] < lengths(T)[None, :]))
    cases = []
    for reverse in (False, True):
        got = fused_gru(x3, mask, w, reverse=reverse)
        ref = gru_forward_reference(x3, mask, w, reverse=reverse)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        assert torch.isfinite(got).all() and err <= TOL, ("gru_fwd", reverse, err)
        cases.append({"reverse": reverse, "max_abs_err": err,
                      "ms": time_ms(torch, lambda: fused_gru(x3, mask, w, reverse=reverse)),
                      "plain_ms": time_ms(torch, lambda: gru_forward_reference(
                          x3, mask, w, reverse=reverse), reps=5)})
    nbytes = 4.0 * (T * B * 3 * H + T * B + H * 3 * H + T * B * H)
    flops = T * (6.0 * B * H * H + 14.0 * B * H)     # kernel_flops.gru_fwd_flops
    results["gru_fwd"] = dict(cases=cases, shape=dict(T=T, B=B, H=H),
                              bytes=nbytes, flops=flops)

    # kernel 2: the attention-GRU decode step, Td = 1 (serving) and Td = 8
    ep, ev = t(rng.randn(Te, B, D) * 0.3), t(rng.randn(Te, B, E) * 0.3)
    em = t((np.arange(Te)[:, None] < lengths(Te)[None, :])[:, :, None])
    h0 = t(rng.randn(B, D) * 0.3)
    wa, ba, v = t(rng.randn(D, D) / np.sqrt(D)), t(rng.randn(1, D) * 0.1), t(rng.randn(1, D) * 0.1)
    wctx, wg = t(rng.randn(E, 3 * D) / np.sqrt(E)), t(rng.randn(D, 3 * D) / np.sqrt(D))
    cases = []
    for Td in (1, 8):
        xw = t(rng.randn(Td, B, 3 * D) * 0.5)
        dmask = t(rng.rand(Td, B, 1) > 0.2)
        args = (ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg)
        got = fused_attention_gru(*args)
        ref = attention_gru_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        assert torch.isfinite(got).all() and err <= TOL, ("attention_gru_fwd", Td, err)
        cases.append({"Td": Td, "max_abs_err": err,
                      "ms": time_ms(torch, lambda: fused_attention_gru(*args)),
                      "plain_ms": time_ms(torch, lambda: attention_gru_reference(*args))})
    Td = 1
    nbytes = 4.0 * (Te * B * (D + E + 1) + Td * B * (3 * D + 1 + D) + B * D
                    + D * D + 2 * D + E * 3 * D + D * 3 * D)
    flops = Td * (2.0 * B * D * D + 4.0 * B * Te * D + 2.0 * B * Te * E
                  + 2.0 * B * E * 3 * D + 6.0 * B * D * D)  # pallas_attention_gru._flops
    results["attention_gru_fwd"] = dict(cases=cases, shape=dict(Td=1, Te=Te, B=B, D=D, E=E),
                                        bytes=nbytes, flops=flops)
    emit({"phase": "kernels", "cases": {k: r["cases"] for k, r in results.items()}})
    return results


def run_requests(engine, prompts):
    futs = [engine.submit(p, rid=f"r{i}") for i, p in enumerate(prompts)]
    out = [f.result(timeout=600.0) for f in futs]
    assert engine.drain(timeout=120.0), "engine did not drain"
    return out


def phase_serve(torch, dev, kernels):
    from paddle_tpu_torch.flagship import nmt_gen_config
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.serving.frontend import build_engine

    tc = nmt_gen_config(vocab=FULL["vocab"], dim=FULL["dim"], beam_size=1,
                        max_length=FULL["max_length"])
    machine = GradientMachine(tc.model_config)            # device=None: the card
    params = machine.init_params(seed=1)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, FULL["vocab"], size=rng.randint(8, 33)).tolist()
               for _ in range(N_REQUESTS)]
    engine = build_engine(machine, params, slots=FULL["slots"],
                          prompt_tokens=FULL["prompt_tokens"], fused_step=True).start()
    backend = engine._backend
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    backend.prefill_launches = backend.decode_microsteps = 0
    t0 = time.perf_counter()
    fused = run_requests(engine, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    prefills, microsteps = backend.prefill_launches, backend.decode_microsteps
    peak = torch.cuda.max_memory_allocated(dev)
    assert all(r.outcome == "ok" and len(r.tokens) >= 1 for r in fused), \
        [(r.rid, r.outcome, r.error) for r in fused if r.outcome != "ok" or not r.tokens]
    assert prefills > 0 and launches["gru_fwd"] == 2 * prefills, (launches, prefills)
    assert launches["attention_gru_fwd"] >= microsteps > 0, (launches, microsteps)
    tokens = sum(len(r.tokens) for r in fused)

    unfused_engine = build_engine(machine, params, slots=FULL["slots"],
                                  prompt_tokens=FULL["prompt_tokens"],
                                  fused_step=False).start()
    t0 = time.perf_counter()
    unfused = run_requests(unfused_engine, prompts)
    unfused_wall = time.perf_counter() - t0
    same = sum(a.tokens == b.tokens for a, b in zip(fused, unfused))
    assert same >= (1.0 - PARITY_TOL) * N_REQUESTS, (same, N_REQUESTS)

    # a small prefill on the card against the plain versions on the CPU
    from paddle_tpu_torch.flagship import nmt_gen_batch
    from paddle_tpu_torch.graph.decode_step import capture_prefill, plan_of

    plan, _ = plan_of(machine)
    cpu = GradientMachine(tc.model_config, device="cpu")
    cpu_params = {n: p.cpu() for n, p in params.items()}
    feed = nmt_gen_batch(vocab=FULL["vocab"], B=3, T=8, seed=2, device=dev)
    feed_cpu = nmt_gen_batch(vocab=FULL["vocab"], B=3, T=8, seed=2, device="cpu")
    st_gpu, boots_gpu = capture_prefill(machine, plan, params, feed)
    st_cpu, boots_cpu = capture_prefill(cpu, plan, cpu_params, feed_cpu)
    prefill_err = max(float((st_gpu[n]["value"].cpu() - st_cpu[n]["value"]).abs().max())
                      for n in st_cpu)
    prefill_err = max([prefill_err] + [float((a.cpu() - b).abs().max())
                                       for a, b in zip(boots_gpu, boots_cpu)])
    assert prefill_err <= TOL, prefill_err

    serve = {"phase": "serve", "params": n_params, "requests": N_REQUESTS,
             "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
             "peak_memory_bytes": peak, "prefill_launches": prefills,
             "decode_microsteps": microsteps, "kernel_launches": launches,
             "unfused_identical": same, "unfused_wall_s": unfused_wall,
             "unfused_tokens_per_s": sum(len(r.tokens) for r in unfused) / unfused_wall,
             "prefill_max_abs_err_vs_cpu": prefill_err}
    emit(serve)
    phase_profile(torch, machine, params, prompts)
    return serve


def phase_profile(torch, machine, params, prompts):
    """Where the serve time goes: the same requests once more under
    torch.profiler, device time summed by kernel, and the device's busy
    share of the wall time (kernel time over wall; copies are listed too)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving.frontend import build_engine

    engine = build_engine(machine, params, slots=FULL["slots"],
                          prompt_tokens=FULL["prompt_tokens"], fused_step=True).start()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_requests(engine, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the CPU ops that
        # launched them carry the same device time again
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in rows) if rows else None   # None: not measured
    emit({"phase": "profile", "wall_s": wall, "device_ms": busy_ms,
          "device_busy_share": busy_ms / 1e3 / wall if rows else None,
          "top": [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in rows[:12]]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.ops.fused_attention_gru import ATTENTION_GRU_FWD
    from paddle_tpu_torch.ops.fused_gru import GRU_FWD

    dev = resolve_device(None)                       # also turns TF32 off
    kernels = [GRU_FWD, ATTENTION_GRU_FWD]
    phase_build(kernels)
    k = phase_kernels(torch, dev)
    serve = phase_serve(torch, dev, kernels)

    meta = {
        "gru_fwd": ("paddle_tpu_torch/csrc/gru_fwd.cu",
                    "paddle_tpu/ops/pallas_gru.py:75 (_fwd_kernel_light; pallas_call :178)"),
        "attention_gru_fwd": ("paddle_tpu_torch/csrc/attention_gru_fwd.cu",
                              "paddle_tpu/ops/pallas_attention_gru.py:285 "
                              "(_fwd_kernel_light; pallas_call :266)"),
    }
    rows = []
    for name, r in k.items():
        main_case = r["cases"][0]                     # forward / Td = 1: the serve shapes
        b_ms, b_by = bound(r["bytes"], r["flops"])
        err = max(c["max_abs_err"] for c in r["cases"])
        launches = serve["kernel_launches"][name]
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches,
            "max_abs_err": err, "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call computes this function "
                            "(torch.nn.GRU applies the reset gate after the "
                            "recurrent product, a different cell)",
            "max_err": err, "kernel_ms": main_case["ms"], "bytes": r["bytes"],
            "flops": r["flops"], "shape": r["shape"],
            "launches_per_request": launches / N_REQUESTS,
        })
    emit({"kernels": rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

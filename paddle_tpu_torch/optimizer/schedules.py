"""Learning-rate schedules.

Port of ``paddle_tpu/optimizer/schedules.py`` (reference
LearningRateScheduler.cpp): constant, poly, caffe_poly, exp, discexp,
linear, manual. ``num_samples_processed`` is the number of samples seen,
so schedules do not depend on the batch size. The rate is a host float,
computed in float32 as the JAX package computes it.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.proto import OptimizationConfig


def learning_rate_at(opt: OptimizationConfig, num_samples_processed) -> float:
    f32 = np.float32
    lr = f32(opt.learning_rate)
    a, b = f32(opt.learning_rate_decay_a), f32(opt.learning_rate_decay_b)
    t = f32(num_samples_processed)
    sched = opt.learning_rate_schedule
    if sched in ("constant", ""):
        return float(lr)
    if sched == "poly":
        return float(lr * np.power(f32(1.0) + a * t, -b))
    if sched == "caffe_poly":
        return float(lr * np.power(f32(1.0) - t / a, b))
    if sched == "exp":
        return float(lr * np.power(a, t / b))
    if sched == "discexp":
        return float(lr * np.power(a, np.floor(t / b)))
    if sched == "linear":
        return float(max(lr - a * t, b))
    if sched == "manual":
        # "seg1:lr1,seg2:lr2,..." — segment boundaries in samples
        segs = []
        for part in opt.learning_rate_args.split(","):
            boundary, _, rate = part.partition(":")
            segs.append((float(boundary), float(rate)))
        out = segs[-1][1]
        for boundary, rate in reversed(segs[:-1]):
            if t < boundary:
                out = rate
        return float(f32(out))
    raise ValueError(f"unknown learning_rate_schedule {sched!r}")

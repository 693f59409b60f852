"""Beam search on the card against the CPU's plain versions, sample by
sample: the check of ``chip_smoke.py``'s beam phase and of the GPU tests.

    from paddle_tpu_torch.tools.beam_parity import beam_parity
    differ, ties, worst = beam_parity(card, cpu, feed_card, feed_cpu, max_length, tol)

``card`` and ``cpu`` are two :class:`paddle_tpu_torch.api.GradientMachine`
of one generation config with the same parameters, one on each device. Give
them parameters whose log-probabilities spread
(:func:`paddle_tpu_torch.flagship.nmt_gen_spread_params`): where every
word is about as likely as any other, any choice of tokens scores alike
and the check cannot fail.
"""

from __future__ import annotations

from typing import List, Tuple


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def beam_parity(card, cpu, feed_card, feed_cpu, max_length: int,
                tol: float) -> Tuple[List[int], List[dict], float]:
    """Where a sample's beams hold the same ids on both devices, every
    beam's score within ``tol`` of the CPU's (relative to max(1, |score|));
    where they differ, the first step at which the two devices' beams
    differ (generation cut to m steps, m = 1, 2, ...: the loop's first m
    steps) must be a near tie, the chosen candidates scoring within ``tol``
    of each other. Raises AssertionError otherwise. Returns (samples that
    differ, their ties, worst score gap where equal)."""
    res_card = card.asSequenceGenerator().generate(feed_card)
    res_cpu = cpu.asSequenceGenerator().generate(feed_cpu)
    ids = lambda sample: [e["ids"] for e in sample]
    differ = [b for b, (x, y) in enumerate(zip(res_card, res_cpu)) if ids(x) != ids(y)]
    worst = max([rel_gap(ec["score"], eh["score"]) for b, (x, y) in enumerate(zip(res_card, res_cpu))
                 if b not in differ for ec, eh in zip(x, y)], default=0.0)
    assert worst <= tol, ("beam scores card vs cpu", worst)
    ties = []
    for b in differ:
        for m in range(1, max_length + 1):
            x = card.asSequenceGenerator(max_length=m).generate(feed_card)[b]
            y = cpu.asSequenceGenerator(max_length=m).generate(feed_cpu)[b]
            if ids(x) != ids(y):
                gap = max(rel_gap(ec["score"], eh["score"]) for ec, eh in zip(x, y))
                assert gap <= tol, ("not a near tie", b, m - 1, x, y)
                ties.append({"sample": b, "step": m - 1, "score_gap": gap})
                break
        else:
            raise AssertionError(f"sample {b}: the beams differ, no step's beams do")
    return differ, ties, worst

"""Threaded reassembly of one host's new row range from shard records.

A relaunch round after a host loss re-slices every sparse table's row
ranges over the surviving host set (``rowshard.partition_rows``);
each survivor then loads its new slice from the last committed
checkpoint's ``row_range``-stamped shard records.  That load is the
reshard: possibly several source files per destination range, read
concurrently, each row landing exactly once.

All threading goes through the ``utils/concurrency`` seam so ``paddle
race`` can virtualise the schedule (tests/race_specs/
spec_sparse_reshard.py asserts no lost/duplicate row across the
reshard).  numpy-only — callers hand in a ``read_fn`` so the loader
never touches disk formats itself.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.utils import concurrency as cc


class ReshardError(RuntimeError):
    """A destination row range could not be assembled exactly once."""


class ReshardLoader:
    """Assemble rows ``[lo, hi)`` of one table from shard records.

    ``records`` are shard-index entries carrying ``row_range=[rlo,
    rhi)``; ``read_fn(record)`` returns that record's rows as a numpy
    array of shape ``(rhi - rlo, *row_shape)``.  ``load`` fans the
    overlapping records out over ``workers`` threads and fails loudly
    — naming the interval — on any row left unfilled or filled twice.
    """

    def __init__(self, records: Sequence[Dict[str, Any]],
                 read_fn: Callable[[Dict[str, Any]], np.ndarray],
                 workers: int = 4):
        self._records = list(records)
        self._read_fn = read_fn
        self._workers = max(1, int(workers))

    def load(self, lo: int, hi: int) -> np.ndarray:
        lo, hi = int(lo), int(hi)
        if hi < lo:
            raise ValueError(f"bad row range [{lo}, {hi})")
        overlapping = []
        for rec in self._records:
            rr = rec.get("row_range")
            if not rr:
                continue
            rlo, rhi = int(rr[0]), int(rr[1])
            clo, chi = max(lo, rlo), min(hi, rhi)
            if clo < chi:
                overlapping.append((rec, rlo, clo, chi))
        out: List[np.ndarray] = [None]  # allocated on first read
        fill = np.zeros(hi - lo, dtype=np.int32)  # per-row write count
        lock = cc.Lock()
        work = cc.Queue()
        for item in overlapping:
            work.put(item)
        errors: List[BaseException] = []

        def worker() -> None:
            while True:
                try:
                    rec, rlo, clo, chi = work.get_nowait()
                except Exception:
                    return
                try:
                    rows = np.asarray(self._read_fn(rec))
                    want = int(rec["row_range"][1]) - rlo
                    if rows.shape[0] != want:
                        raise ReshardError(
                            f"shard {rec.get('file', '?')} claims rows "
                            f"[{rlo}, {rlo + want}) but holds "
                            f"{rows.shape[0]} row(s)"
                        )
                    piece = rows[clo - rlo:chi - rlo]
                    with lock:
                        if out[0] is None:
                            out[0] = np.zeros(
                                (hi - lo,) + piece.shape[1:],
                                dtype=piece.dtype,
                            )
                        out[0][clo - lo:chi - lo] = piece
                        fill[clo - lo:chi - lo] += 1
                except BaseException as e:  # surfaced after join
                    with lock:
                        errors.append(e)

        threads = [
            cc.Thread(target=worker, name=f"reshard-{i}", daemon=True)
            for i in range(min(self._workers, max(1, len(overlapping))))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        problems = _fill_problems(lo, hi, fill)
        if problems:
            raise ReshardError("; ".join(problems))
        if out[0] is None:
            # hi == lo (empty destination range) is the only clean way here
            return np.zeros((0,), dtype=np.float32)
        return out[0]


def _fill_problems(lo: int, hi: int, fill: np.ndarray) -> List[str]:
    """Human-named intervals where fill count != 1."""
    problems: List[str] = []
    for want, word in ((0, "missing from every shard record"),
                       (2, "written more than once")):
        mask = (fill == 0) if want == 0 else (fill > 1)
        if not mask.any():
            continue
        idx = np.flatnonzero(mask)
        start = prev = int(idx[0])
        runs: List[Tuple[int, int]] = []
        for i in idx[1:]:
            i = int(i)
            if i != prev + 1:
                runs.append((start, prev + 1))
                start = i
            prev = i
        runs.append((start, prev + 1))
        for a, b in runs:
            problems.append(f"rows [{lo + a}, {lo + b}) {word}")
    return problems

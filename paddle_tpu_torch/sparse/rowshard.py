"""Contiguous row-range math for row-sharded embedding tables.

Pure integer arithmetic, deliberately jax-free: ``cluster_launch``
calls ``row_budget_error`` before relaunch rounds (no jax in the
supervisor), and ``paddle check-checkpoint`` calls
``coverage_problems`` on shard indexes from cold disk.

The sharding model is the simplest one that composes with the
PR-6 durable shard protocol: host ``i`` of ``n`` owns the contiguous
interval ``[i*nrows//n, (i+1)*nrows//n)``.  Balanced to within one
row, order-preserving (resharding moves whole sub-intervals, never
permutes rows), and a shard record needs only ``row_range=[lo, hi)``
to be self-describing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def partition_rows(nrows: int, num_hosts: int) -> List[Tuple[int, int]]:
    """Contiguous, balanced row ranges: one ``(lo, hi)`` per host.

    Ranges tile ``[0, nrows)`` exactly; sizes differ by at most one
    row.  ``nrows < num_hosts`` leaves trailing hosts with empty
    ranges (``lo == hi``) rather than failing — a 3-row table on 4
    hosts is legal, just wasteful.
    """
    if nrows < 0:
        raise ValueError(f"nrows must be >= 0, got {nrows}")
    if num_hosts <= 0:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    return [
        (i * nrows // num_hosts, (i + 1) * nrows // num_hosts)
        for i in range(num_hosts)
    ]


def rows_per_host(nrows: int, num_hosts: int) -> int:
    """Largest per-host row count under ``partition_rows`` (= ceil)."""
    if num_hosts <= 0:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    return -(-max(nrows, 0) // num_hosts)


def row_budget_error(tables: Dict[str, int], num_hosts: int,
                     budget: int) -> Optional[str]:
    """Refusal message when ``num_hosts`` hosts cannot hold every
    table within ``budget`` rows/host, else None.

    ``budget <= 0`` means unlimited (the flag's default).  The message
    names the offending table, its row count, the host count, and the
    per-host need — the string ``cluster_launch`` refuses a relaunch
    round with, so it must carry enough to act on.
    """
    if budget <= 0 or not tables:
        return None
    if num_hosts <= 0:
        return f"no hosts left to hold {len(tables)} sparse table(s)"
    for name, nrows in sorted(tables.items()):
        need = rows_per_host(int(nrows), num_hosts)
        if need > budget:
            label = f"sparse table '{name}'" if name else "sparse table"
            return (
                f"{label} of {int(nrows)} rows does not fit "
                f"{num_hosts} host(s) within --sparse_row_budget={budget} "
                f"rows/host (needs {need})"
            )
    return None


def reshard_plan(old_ranges: Sequence[Tuple[int, int]],
                 new_ranges: Sequence[Tuple[int, int]],
                 ) -> List[List[Tuple[int, int, int]]]:
    """Per-new-host fetch plan: which old hosts' sub-intervals
    assemble each new range.

    Returns one list per new host of ``(src_host, lo, hi)`` triples
    (``[lo, hi)`` in table coordinates), in row order.  A new host's
    triples tile its range exactly when the old ranges tile the table.
    """
    plan: List[List[Tuple[int, int, int]]] = []
    for nlo, nhi in new_ranges:
        parts: List[Tuple[int, int, int]] = []
        for src, (olo, ohi) in enumerate(old_ranges):
            lo, hi = max(nlo, olo), min(nhi, ohi)
            if lo < hi:
                parts.append((src, lo, hi))
        parts.sort(key=lambda t: t[1])
        plan.append(parts)
    return plan


def coverage_problems(nrows: int,
                      ranges: Sequence[Tuple[int, int, object]],
                      ) -> List[str]:
    """Named holes/overlaps in a claimed row coverage of ``[0, nrows)``.

    ``ranges`` is ``(lo, hi, host)`` per shard record.  Every problem
    is a full sentence naming the exact interval and the responsible
    host(s) — ``paddle check-checkpoint`` surfaces these verbatim, and
    "rows [4, 8) missing" must be actionable without opening the
    index by hand.
    """
    problems: List[str] = []
    clean: List[Tuple[int, int, object]] = []
    for lo, hi, host in ranges:
        lo, hi = int(lo), int(hi)
        if lo < 0 or hi > nrows or lo > hi:
            problems.append(
                f"rows [{lo}, {hi}) (host {host}) outside table of "
                f"{nrows} rows"
            )
            continue
        if lo < hi:
            clean.append((lo, hi, host))
    clean.sort(key=lambda t: (t[0], t[1]))
    cursor = 0
    covered_to = 0  # furthest hi seen — overlap detection under sort order
    for lo, hi, host in clean:
        if lo > cursor:
            problems.append(
                f"rows [{cursor}, {lo}) of {nrows} uncovered "
                f"(no host's shard record claims them)"
            )
        if lo < covered_to:
            others = sorted(
                {str(h) for l2, h2, h in clean
                 if (l2, h2, h) != (lo, hi, host) and l2 < hi and h2 > lo}
            )
            problems.append(
                f"rows [{lo}, {min(hi, covered_to)}) covered more than "
                f"once (host {host} overlaps host(s) {', '.join(others)})"
            )
        cursor = max(cursor, hi)
        covered_to = max(covered_to, hi)
    if cursor < nrows:
        problems.append(
            f"rows [{cursor}, {nrows}) of {nrows} uncovered "
            f"(no host's shard record claims them)"
        )
    return problems

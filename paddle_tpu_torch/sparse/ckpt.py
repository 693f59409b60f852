"""Row-range reads of durable checkpoints (the reshard's disk half).

Two consumers:

* relaunch restore — :func:`load_table_rows` assembles an arbitrary
  row slice of a table from a COMMITTED pass directory's merged
  index, via the threaded :class:`~paddle_tpu_torch.sparse.reshard.
  ReshardLoader` (any hole or double-write raises, naming the
  interval);
* ``paddle check-checkpoint`` — :func:`partial_row_holes` names, for
  a torn ``pass-N.tmp``, exactly which row intervals of which tables
  never reached disk and which hosts did commit theirs.

Shard records written since this PR carry an explicit
``row_range=[lo, hi)``; older records for dim-0-sharded params are
equivalent to ``[start[0], start[0] + shape[0])`` and
:func:`load_table_rows` accepts the derived form, so pre-sparse
checkpoints stay loadable.  :func:`partial_row_holes` trusts only the
explicit stamp — deriving there would claim phantom full-row coverage
for column-sharded dense params.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.sparse import rowshard
from paddle_tpu_torch.sparse.reshard import ReshardLoader

_SHARD_HOST_RE = re.compile(r"\.shard(\d{5})\.npz$")
_PARTIAL_IDX_RE = re.compile(r"^(?P<base>.+)\.index\.(?P<pid>\d{5})\.json$")


def shard_row_range(rec: Dict[str, Any]) -> Optional[Tuple[int, int]]:
    """The row interval a shard record claims: explicit ``row_range``
    when stamped, else derived from ``start[0]``/``shape[0]`` (the
    pre-sparse record form for dim-0 shardings)."""
    rr = rec.get("row_range")
    if rr:
        return int(rr[0]), int(rr[1])
    start, shape = rec.get("start"), rec.get("shape")
    if start and shape:
        return int(start[0]), int(start[0]) + int(shape[0])
    return None


def _shard_host(fname: str) -> str:
    m = _SHARD_HOST_RE.search(fname)
    return str(int(m.group(1))) if m else "?"


def load_table_rows(pass_dir: str, name: str, lo: int, hi: int,
                    base: str = "params", workers: int = 4) -> np.ndarray:
    """Rows ``[lo, hi)`` of table ``name`` from a committed pass dir.

    Reads only the shard files whose ``row_range`` overlaps the
    request — a survivor loading its post-reshard slice never touches
    the rest of the table.  Raises :class:`~paddle_tpu_torch.sparse.
    reshard.ReshardError` (naming the interval) on any coverage hole.
    """
    index_path = os.path.join(pass_dir, f"{base}.index.json")
    with open(index_path) as f:
        index = json.load(f)
    entry = index.get(name)
    if entry is None:
        raise KeyError(f"no entry for {name!r} in {index_path}")
    records = []
    for rec in entry.get("shards", []):
        rr = shard_row_range(rec)
        if rr is None:
            continue
        records.append(dict(rec, row_range=[rr[0], rr[1]]))

    def read_fn(rec: Dict[str, Any]) -> np.ndarray:
        with np.load(os.path.join(pass_dir, rec["file"])) as z:
            return np.asarray(z[rec["key"]])

    return ReshardLoader(records, read_fn, workers=workers).load(lo, hi)


def partial_row_holes(tmp_dir: str,
                      tables: Optional[Dict[str, int]] = None) -> List[str]:
    """Named row holes in a TORN pass tmp dir's per-host partial
    indexes — the evidence ``paddle check-checkpoint`` prints for a
    pass that never committed.

    ``tables`` restricts the check to known sparse tables
    (``{name: nrows}``); by default every entry whose partial records
    carry a row extent is checked against its global ``shape[0]``.
    Each message names the table, the missing interval, and which
    hosts DID land their partial index (the absent host is the
    responsible one).
    """
    by_name: Dict[Tuple[str, str], Dict[str, Any]] = {}
    hosts_present: List[str] = []
    try:
        listing = sorted(os.listdir(tmp_dir))
    except OSError:
        return []
    for fn in listing:
        m = _PARTIAL_IDX_RE.match(fn)
        if not m:
            continue
        hosts_present.append(str(int(m.group("pid"))))
        try:
            with open(os.path.join(tmp_dir, fn)) as f:
                partial = json.load(f)
        except (OSError, ValueError):
            continue
        for name, entry in partial.items():
            slot = by_name.setdefault(
                (m.group("base"), name),
                {"shape": entry.get("shape"), "ranges": []},
            )
            for rec in entry.get("shards", []):
                # EXPLICIT row_range only: deriving from start/shape here
                # would claim full-row coverage for column-sharded dense
                # params and report phantom overlaps
                rr = rec.get("row_range")
                if rr:
                    slot["ranges"].append(
                        (int(rr[0]), int(rr[1]),
                         _shard_host(rec.get("file", "")))
                    )
    holes: List[str] = []
    present = ", ".join(sorted(set(hosts_present), key=int)) or "none"
    for (base, name), slot in sorted(by_name.items()):
        shape = slot["shape"]
        if not shape or not slot["ranges"]:
            continue
        if tables is not None and name.split("/", 1)[0] not in tables:
            continue
        nrows = int(shape[0])
        for msg in rowshard.coverage_problems(nrows, slot["ranges"]):
            holes.append(
                f"{base}/{name}: {msg} — partial index present from "
                f"host(s) {present}"
            )
    return holes

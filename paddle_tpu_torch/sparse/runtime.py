"""Process-global sparse-table registry + per-pass touched-row stats.

The registry is how the layers below the trainer learn which params
are row-sharded sparse tables without threading a config through
every call site: the trainer registers ``{param_name: nrows}`` at
construction, and ``checkpoint.snapshot_owned_trees`` (a jax-free
module that must not import the trainer) looks names up here to stamp
``row_range`` into shard records.  Registration is idempotent and
cleared per-trainer — tests call :func:`clear_tables` in teardown.

``SparseStats`` is the accounting half of the ``kind=sparse``
telemetry record: occurrence/unique touched-row counts and
gather/scatter byte estimates per pass, plus reshard events observed
at restore time.  numpy-only, no jax.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_TABLES: Dict[str, int] = {}


def register_tables(tables: Dict[str, int]) -> None:
    """Declare row-sharded sparse tables: ``{param_name: nrows}``."""
    for name, nrows in tables.items():
        _TABLES[str(name)] = int(nrows)


def clear_tables() -> None:
    _TABLES.clear()


def registered_tables() -> Dict[str, int]:
    """Snapshot of the registry (copy — callers may not mutate it)."""
    return dict(_TABLES)


class SparseStats:
    """Per-pass touched-row accounting for one trainer.

    ``row_bytes`` maps table param name -> bytes per row (width *
    itemsize), fixed at construction so byte estimates don't need the
    arrays.  Gather bytes count every occurrence (the prefetch
    fetches per-id); scatter bytes count unique rows (the updater
    dedupes before writing back).
    """

    def __init__(self, row_bytes: Dict[str, int]):
        self.row_bytes = {str(k): int(v) for k, v in row_bytes.items()}
        self.reshard_events: List[Dict[str, int]] = []
        self._reset_pass()

    def _reset_pass(self) -> None:
        self.rows_touched = 0
        self.gather_bytes = 0
        self.scatter_bytes = 0
        self._unique: Dict[str, set] = {}

    def note_batch(self, plan: List[Tuple[str, str]],
                   host_batch: Dict[str, Any]) -> None:
        """Account one batch: ``plan`` is the trainer's
        ``sparse_prefetch_plan()`` ([(param_name, data_layer_name)]),
        ``host_batch`` the per-launch host arg dict whose entries
        carry integer ``.ids``."""
        for pn, dname in plan:
            arg = host_batch.get(dname)
            ids = getattr(arg, "ids", None)
            if ids is None:
                continue
            ids = np.asarray(ids).reshape(-1)
            if ids.size == 0:
                continue
            rb = self.row_bytes.get(pn, 0)
            uniq = np.unique(ids)
            self.rows_touched += int(ids.size)
            self.gather_bytes += int(ids.size) * rb
            self.scatter_bytes += int(uniq.size) * rb
            self._unique.setdefault(pn, set()).update(int(i) for i in uniq)

    def note_reshard(self, old_hosts: int, new_hosts: int) -> None:
        """Record one restore-time resharding (host-count change)."""
        self.reshard_events.append(
            {"old_hosts": int(old_hosts), "new_hosts": int(new_hosts)}
        )

    def unique_rows(self) -> int:
        return sum(len(s) for s in self._unique.values())

    def pass_record(self, duration_s: Optional[float] = None,
                    ) -> Dict[str, Any]:
        """The ``kind=sparse`` payload for the pass just finished;
        resets per-pass counters (reshard events are per-run and
        persist)."""
        uniq = self.unique_rows()
        rec: Dict[str, Any] = {
            "rows_touched": int(self.rows_touched),
            "unique_rows": int(uniq),
            "unique_row_rate": (
                float(uniq) / float(self.rows_touched)
                if self.rows_touched else 0.0
            ),
            "gather_bytes": int(self.gather_bytes),
            "scatter_bytes": int(self.scatter_bytes),
            "reshard_events": len(self.reshard_events),
        }
        if duration_s is not None and duration_s > 0:
            rec["sparse_rows_per_sec"] = self.rows_touched / duration_s
        self._reset_pass()
        return rec

"""Row-sparse gradients — the sparse-at-scale embedding path.

Port of ``paddle_tpu/optimizer/sparse.py`` (the reference's prefetch of
embedding rows from the input ids, TrainerInternal.cpp:91-95; sparse row
gradients, SparseRowMatrix.h:31; per-row updates, ParameterServer2.cpp).
A gradient for a ``sparse_update`` table is a :class:`RowSparseGrad`: the
batch's flat occurrence ids and one gradient row per occurrence, O(batch ·
seq), never the dense [V, D] gradient autograd would build through
``table[ids]``. The machine gets it by differentiating with respect to the
gathered rows (``GradientMachine.grad_fn``); the updater dedupes the
occurrences with :func:`dedupe` and updates only those rows
(``Updater._apply_sparse_indexed``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class RowSparseGrad:
    """Gradient of a [V, D] table as occurrence rows.

    ids:  [N] int — the row of each occurrence (duplicates allowed; an id
          at a padded position carries a zero row and changes nothing)
    rows: [N, D] — d(loss)/d(table[ids[n]]) per occurrence
    nrows: V, for densification and bounds
    """

    def __init__(self, ids: Tensor, rows: Tensor, nrows: int):
        self.ids = ids
        self.rows = rows
        self.nrows = int(nrows)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.rows.shape[-1])

    def to_dense(self) -> Tensor:
        """The dense [V, D] gradient (tests and the small-model numpy API
        only: it is what this class exists to avoid at scale)."""
        out = self.rows.new_zeros((self.nrows, self.rows.shape[-1]))
        return out.index_add_(0, self.ids.reshape(-1).long(), self.rows)

    def __repr__(self):
        return (f"RowSparseGrad(ids={tuple(self.ids.shape)}, rows={tuple(self.rows.shape)}, "
                f"nrows={self.nrows})")


def dedupe(ids: Tensor, rows: Tensor, nrows: int):
    """Sum duplicate occurrences: returns (uid, g_rows, valid), all [N]-sized.

    uid[k] is the k-th distinct row index in ascending order; positions
    past the distinct count hold the sentinel ``nrows``; g_rows[k] is the
    summed gradient of uid[k]. Static shapes throughout, and no read of
    the distinct count on the host: a stable sort, first-of-run flags, a
    cumulative segment id and a segment sum. The sum is
    ``index_put_(accumulate=True)``, which on CUDA sorts and then adds each
    run of duplicates in order (``index_add_``'s atomics add them in no
    fixed order): the occurrences of an id are summed in batch order, as
    autograd's backward of ``table[ids]`` sums them for the dense path, on
    the card and on the CPU alike."""
    N = ids.shape[0]
    ids_s, order = torch.sort(ids.reshape(-1).long(), stable=True)
    rows_s = rows[order]
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(first, 0) - 1                   # occurrence -> distinct slot
    g_rows = rows.new_zeros((N,) + tuple(rows.shape[1:])).index_put_((seg,), rows_s,
                                                                      accumulate=True)
    valid = torch.arange(N, device=ids.device) < first.sum()
    # every occurrence of a segment holds the same id: the scatter writes
    # one value per slot, whatever its order
    uid = torch.full_like(ids_s, nrows).scatter_(0, seg, ids_s)
    uid = torch.where(valid, uid, torch.full_like(uid, nrows))
    return uid, g_rows, valid


def touched_row_bytes(grad: RowSparseGrad) -> Tuple[int, int]:
    """(gather_bytes, scatter_bytes) one step moved for this table: the
    gather pays per occurrence, the scatter per distinct row. Host-side
    accounting: it copies the ids to the host, so it is never called
    inside a step."""
    n = int(grad.ids.shape[0])
    row_bytes = int(grad.rows.shape[-1]) * grad.rows.element_size()
    uniq = int(np.unique(grad.ids.detach().cpu().numpy()).size) if n else 0
    return n * row_bytes, uniq * row_bytes

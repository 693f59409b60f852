"""Row-sharded sparse-parameter training (doc/sparse.md).

Role of the reference's parameter-server sparse path
(`SparseRowMatrix.h`, sparse remote updaters): embedding tables whose
rows are too large for one host live row-sharded across hosts, each
batch gathers/scatters only the touched rows, per-row optimizer state
rides the same row sharding, and the PR 1-6 durability stack is
extended with explicit ``row_range`` shard records so a host loss
reshards the surviving table instead of silently zero-initialising it.

Submodules stay import-light: ``rowshard`` and ``runtime`` are
jax-free (usable from ``cluster_launch`` and ``paddle
check-checkpoint``); ``reshard`` needs only numpy + the
``utils/concurrency`` seam; ``ckpt`` reads checkpoint indexes.
"""

from paddle_tpu_torch.sparse.rowshard import (  # noqa: F401
    coverage_problems,
    partition_rows,
    reshard_plan,
    row_budget_error,
)
from paddle_tpu_torch.sparse.runtime import (  # noqa: F401
    SparseStats,
    clear_tables,
    register_tables,
    registered_tables,
)

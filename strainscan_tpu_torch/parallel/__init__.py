"""Multi-device (``sharded``) and multi-host (``distributed``) scale-out."""

from strainscan_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    ShardedCountPipeline,
    ShardedFpTable,
    ShardedTable,
    l2_mesh,
    make_mesh,
    pad_rows,
    resolve_mesh,
    shard_rows,
    sharded_colsum,
    sharded_colsum_unused,
    sharded_count,
    sharded_fold_grams,
    sharded_l2_stats,
    sharded_or_col,
)

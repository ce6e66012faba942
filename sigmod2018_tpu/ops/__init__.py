from .select import (
    compare_mask,
    equal_mask,
    mask_positions,
    gather_u64,
    gather_rows,
    take_cols,
    checksum,
    checksum_many,
)
from .sort_join import (join_build, join_probe_count,
                        join_probe_count_table, join_emit)
from .agg_join import (fused_join, join_checksum_fused,
                       join_checksum_fused_presorted,
                       join_checksum_fused_table,
                       join_checksum_fused_table_pref, prefix_by_perm)
from .cartesian import cartesian_indices

__all__ = [
    "compare_mask",
    "mask_positions",
    "gather_u64",
    "gather_rows",
    "take_cols",
    "checksum",
    "join_build",
    "join_probe_count",
    "join_emit",
    "fused_join",
    "join_checksum_fused",
    "join_checksum_fused_presorted",
    "join_checksum_fused_table",
    "join_checksum_fused_table_pref",
    "prefix_by_perm",
    "join_probe_count_table",
    "cartesian_indices",
]

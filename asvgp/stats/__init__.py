"""On-device sufficient-statistic assembly (shardable over N)."""

from asvgp.stats.sufficient import (
    SufficientStats,
    kuf_matvec,
    kufkfu_band,
    compute_stats,
    compute_stats_sharded,
)

__all__ = [
    "SufficientStats",
    "kuf_matvec",
    "kufkfu_band",
    "compute_stats",
    "compute_stats_sharded",
]

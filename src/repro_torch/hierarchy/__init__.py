# Hierarchical aggregation and streaming cohorts: the Eq.-3 linearity of
# every stats payload makes aggregation exact under any summation tree, so
# the cohort can fan in through edge aggregators (per-hop channels, per-hop
# wire bytes) and stream through the round in fixed-size chunks with
# O(chunk) peak memory; sharded over devices, each rank folds its own
# edges (``HierarchicalChannel.local_fold``).
from repro_torch.hierarchy.aggregation import (  # noqa: F401
    HierarchicalChannel, HierarchicalContext, contiguous_edge_ids,
    fold_to_edges, segment_mass)
from repro_torch.hierarchy.streaming import (  # noqa: F401
    StreamingSampler, streaming_stats_round)

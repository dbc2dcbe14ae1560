# Hierarchical aggregation: the Eq.-3 linearity of every stats payload
# makes aggregation exact under any summation tree, so the cohort can fan
# in through edge aggregators (per-hop channels, per-hop wire bytes). The
# sharded and streaming folds of the reference are not ported yet
# (ROADMAP §1).
from repro_torch.hierarchy.aggregation import (  # noqa: F401
    HierarchicalChannel, HierarchicalContext, contiguous_edge_ids,
    fold_to_edges, segment_mass)

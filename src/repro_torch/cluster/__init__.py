# Cluster-aware aggregation (heterogeneous populations): cosine k-means
# on the Eq.-3 per-client statistics assigns cohort clients to clusters
# every round; each cluster keeps its own correlation target and
# server-update slot. See repro_torch.cluster.round for the protocol.
from repro_torch.cluster.kmeans import (  # noqa: F401
    assign_clusters, cosine_kmeans, flatten_stats, seed_centroids,
    stats_dim)
from repro_torch.cluster.round import (  # noqa: F401
    ClusterState, fold_to_clusters, init_cluster_state,
    make_cluster_round_body)

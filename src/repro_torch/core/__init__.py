"""DCCO — distributed cross-correlation optimization for federated
dual-encoder training: statistics, losses, the round simulator and the
engine."""
from repro_torch.core import fed_sim  # noqa: F401
from repro_torch.core.cco import (  # noqa: F401
    SECOND_MOMENT_KEYS, STAT_KEYS, cco_loss, cco_loss_from_stats,
    correlation_matrix, dcco_combine, encoding_stats, encoding_stats_masked,
    moment_stats, per_client_stats, weighted_average_stats)
from repro_torch.core.losses import (  # noqa: F401
    byol_predictive_loss, encoding_variance, ntxent_loss,
    softmax_cross_entropy)
from repro_torch.core.round_engine import (  # noqa: F401
    ALGORITHMS, EngineCarry, EngineConfig, EngineMetrics, RoundEngine,
    make_round_body)
from repro_torch.data.partition import (  # noqa: F401
    PARTITIONS, PartitionSpec, build_partition, dirichlet_partition,
    get_partition, iid_partition, label_dominance, register_partition)
from repro_torch.data.pipeline import FederatedDataset  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    synthetic_labeled_images, synthetic_labeled_tokens)
from repro_torch.server.optimizers import (  # noqa: F401
    fedadagrad, fedadam, fedavgm, fedyogi)
from repro_torch.server.update import (  # noqa: F401
    SERVER_UPDATES, ServerUpdate, as_server_update, get_server_update)

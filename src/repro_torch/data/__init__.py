"""Synthetic data, client partitions, augmentation and the round pipeline."""
from repro_torch.data.partition import (  # noqa: F401
    PARTITIONS, PartitionSpec, build_partition, dirichlet_partition,
    get_partition, iid_partition, label_dominance, register_partition)
from repro_torch.data.pipeline import FederatedDataset  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    synthetic_labeled_images, synthetic_labeled_tokens)

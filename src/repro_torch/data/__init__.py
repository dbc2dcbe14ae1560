"""Synthetic data, client partitions, augmentation and the round pipeline."""

"""DCCO — distributed cross-correlation optimization for federated
dual-encoder training: statistics, the round simulator and the engine."""

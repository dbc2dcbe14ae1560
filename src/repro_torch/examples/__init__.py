"""The reference's nine example scripts, one module each, run as
``python -m repro_torch.examples.<name>`` (on the GPU unless ``--device
cpu``): quickstart, federated_cifar, federated_vicreg, federated_comm,
federated_noniid, federated_hierarchy, federated_async,
dual_encoder_text and serve_retrieval. Each has ``main(argv=None)``,
prints the reference script's lines and returns its numbers; nothing
runs at import."""
